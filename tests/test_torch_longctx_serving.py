"""Windowed paged serving in the port against the reference's
(``tests/test_longctx_serving.py``): streaming chunked prefill over the
page pool under a sliding window.

A tiny f32 model (hd 64, window 16, chunked prefill 8) with the JAX
weights converted. Pins:

- a prompt whose full reservation outsizes the pool is admitted through
  the windowed peak bound; its greedy stream equals the JAX windowed
  paged batcher's (logprobs within atol 1e-4, f32 summation order), and
  its peak and recycled page counts equal the reference's on the same
  schedule;
- inside the port, paged windowed equals dense windowed bit for bit,
  tokens and logprobs, at pages of 8 and 16, on a prompt of 3x the window
  and on one past the pool's wall, synchronous and pipelined;
- recycling: out-of-window pages go back mid-stream, retirement drains
  the pool to zero, a recycled table entry points at the trap page, a
  cancel mid-growth returns the pool to its baseline, promotion skips a
  recycled row and keeps a short one; ``pool.check()`` holds after every
  run;
- KV page transfer: a row whose early pages were recycled refuses its
  export (resume by re-prefill), and a page install into a windowed
  pool takes the full reservation, recycles as it decodes and continues
  the uninterrupted stream bit for bit;
- refusals: the full-causal twin is refused at the pool wall with the
  reference's structured fields, the slot wall too; the server's
  ``--attnWindow`` reaches ``/v1/health``.
"""

import json
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_gpu_device_plugin_tpu.models import batching as jbatch
from k8s_gpu_device_plugin_tpu.models import llama as jllama
from k8s_gpu_device_plugin_torch.models import batching as tbatch
from k8s_gpu_device_plugin_torch.models import llama as tllama
from k8s_gpu_device_plugin_torch.models.convert import params_from_jax
from k8s_gpu_device_plugin_torch.models.paging import PagePool
from k8s_gpu_device_plugin_torch.serving import server as srv
from k8s_gpu_device_plugin_torch.serving.prefix_cache import PrefixCache

torch.set_num_threads(1)

PS = 16       # page size
W = 16        # sliding window
CHUNK = 8
BUCKETS = (8, 16, 32, 64, 128)


@pytest.fixture(scope="module")
def models():
    jcfg = jllama.LlamaConfig.tiny(dtype=jnp.float32, head_dim_override=64,
                                   sliding_window=W)
    tcfg = tllama.LlamaConfig.tiny(dtype=torch.float32, head_dim_override=64,
                                   sliding_window=W)
    jparams = jllama.init_params(jax.random.key(0), jcfg)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                              device="cpu")
    return jcfg, jparams, tcfg, tparams


def _prompt(key, n, vocab):
    return np.random.default_rng(key).integers(1, vocab, n).tolist()


def _kw(kv_pages, ps=PS, n_slots=1, max_len=128, layout="paged"):
    kw = dict(n_slots=n_slots, max_len=max_len, prompt_buckets=BUCKETS,
              chunked_prefill=CHUNK, kv_layout=layout)
    if layout == "paged":
        kw.update(kv_page_size=ps, kv_pages=kv_pages)
    return kw


def _batcher(params, cfg, kv_pages, ps=PS, **kw):
    return tbatch.ContinuousBatcher(params, cfg, **_kw(kv_pages, ps), **kw)


def test_pool_recycle_counts_only_true_frees():
    pool = PagePool(8, 16)
    a = pool.alloc(4)  # graftlint: disable=refcount-pairing
    pool.incref(a[:1])  # graftlint: disable=refcount-pairing
    assert pool.recycle(a[:2]) == 1       # a[0] survives its other holder
    assert pool.recycled_total == 1
    assert pool.recycle([a[0]]) == 1      # the other holder lets go
    assert pool.recycled_total == 2
    freed = pool.decref(a[2:])            # a release, not a recycle
    assert freed == a[2:] and pool.recycled_total == 2
    assert pool.in_use == 0
    pool.check()


def test_windowed_prompt_past_pool_wall_serves_o_window(models):
    """The reference's schedule (6 allocatable pages of 16 against a full
    worst case of 8): the port's greedy stream, peak and recycled pages
    equal the JAX windowed paged batcher's."""
    jcfg, jparams, tcfg, tparams = models
    p = _prompt(300, 100, tcfg.vocab_size)
    ref = jbatch.ContinuousBatcher(jparams, jcfg, pipeline_depth=0,
                                   **_kw(6 + 1))
    rr = ref.submit(p, max_new=20)
    ref.run(max_steps=400)
    cb = _batcher(tparams, tcfg, 6 + 1)
    assert cb._incremental_reserve is True
    rid = cb.submit(p, max_new=20)
    cb.run(max_steps=400)
    got, want = cb.done_requests[rid], ref.done_requests[rr]
    assert got.out == want.out and len(got.out) == 20
    np.testing.assert_allclose(got.out_logp, want.out_logp, atol=1e-4,
                               rtol=0)
    full = cb.pool.pages_for_tokens(120)
    bound = cb.pool.pages_for_tokens(cb._windowed_peak_tokens(20))
    assert cb.pool.peak_in_use <= bound < full
    assert cb.pool.peak_in_use == ref.pool.peak_in_use
    assert cb._pages_recycled == ref._pages_recycled > 0
    assert cb.pool.recycled_total == cb._pages_recycled
    assert cb.pool.in_use == 0
    cb.pool.check()
    s = cb.kv_stats()
    assert s["attn_window"] == W
    assert s["pages_recycled_total"] == cb._pages_recycled
    assert s["pages_in_use_peak"] == ref.pool.peak_in_use
    assert cb.kv_rejections()["pool_pressure"] == 0


@pytest.mark.parametrize("ps,kv_pages", [(8, 10 + 1), (16, 6 + 1)])
@pytest.mark.parametrize("depth", [0, 1])
def test_windowed_paged_equals_dense_bitwise(models, ps, kv_pages, depth):
    """A prompt of 3x the window, then one past the pool's wall, on one
    slot: the paged rows (grown, recycled, their table entries reset to
    the trap page) give the dense layout's tokens and logprobs bit for
    bit; a seeded request rides along."""
    _, _, tcfg, tparams = models
    prompts = [_prompt(301, 3 * W, tcfg.vocab_size),
               _prompt(302, 100, tcfg.vocab_size)]

    def serve(cb):
        rids = [cb.submit(p, max_new=20, seed=5 if i else None)
                for i, p in enumerate(prompts)]
        cb.run(max_steps=600)
        return [(cb.done_requests[r].out, cb.done_requests[r].out_logp)
                for r in rids]

    dense = serve(tbatch.ContinuousBatcher(
        tparams, tcfg, pipeline_depth=depth,
        **_kw(0, layout="dense")))
    cb = _batcher(tparams, tcfg, kv_pages, ps=ps, pipeline_depth=depth)
    table = cb.state.pages.data_ptr()
    assert serve(cb) == dense
    # growth and recycling write the table in place: a captured decode
    # step goes on reading the same storage
    assert cb.state.pages.data_ptr() == table
    assert cb._pages_recycled > 0 and cb.pool.in_use == 0
    assert cb.pool.peak_in_use <= cb.pool.pages_for_tokens(
        cb._windowed_peak_tokens(20))
    cb.pool.check()


def test_recycled_entries_point_at_the_trap_page(models):
    """Mid-decode, every recycled table entry of the row is 0 on the
    device (the kernel's floor tile may read it under its mask) and the
    host ledger agrees."""
    _, _, tcfg, tparams = models
    cb = _batcher(tparams, tcfg, 6 + 1, pipeline_depth=0)
    rid = cb.submit(_prompt(303, 100, tcfg.vocab_size), max_new=20)
    while rid not in {r.rid for r in cb.running.values()}:
        cb.step()
    for _ in range(10):
        cb.step()
    slot = next(s for s, r in cb.running.items() if r.rid == rid)
    lo = cb._recycle_lo[slot]
    ids = cb._slot_pages[slot]
    assert lo > 0 and ids[:lo] == [0] * lo
    row = cb.state.pages[slot].tolist()
    assert row[:lo] == [0] * lo and row[lo:len(ids)] == ids[lo:]
    cb.run(max_steps=200)
    cb.pool.check()


def test_full_causal_twin_is_refused_at_the_pool_wall(models):
    """The same pool without a window refuses the same request, with the
    reference's structured fields."""
    jcfg, jparams, tcfg, tparams = models
    import dataclasses

    t0 = dataclasses.replace(tcfg, sliding_window=0)
    cb = _batcher(tparams, t0, 6 + 1)
    assert cb._incremental_reserve is False
    ref = jbatch.ContinuousBatcher(
        jparams, dataclasses.replace(jcfg, sliding_window=0), **_kw(6 + 1))
    p = _prompt(300, 100, tcfg.vocab_size)
    with pytest.raises(jbatch.RequestTooLargeError) as want:
        ref.submit(p, max_new=20)
    with pytest.raises(tbatch.RequestTooLargeError, match="KV pages") as ei:
        cb.submit(p, max_new=20)
    assert ei.value.body() == want.value.body() == {
        "prompt_tokens": 100, "max_new": 20, "limit": 6 * PS}
    assert cb.kv_rejections()["request_too_large"] == 1


def test_slot_wall_reports_structured_fields(models):
    _, _, tcfg, tparams = models
    cb = tbatch.ContinuousBatcher(tparams, tcfg, **dict(
        _kw(12), max_len=64))
    with pytest.raises(tbatch.RequestTooLargeError, match="slot capacity") \
            as ei:
        cb.submit(_prompt(301, 50, tcfg.vocab_size), max_new=30)
    assert ei.value.body() == {"prompt_tokens": 50, "max_new": 30,
                               "limit": 64}


def test_window_zero_and_dense_opt_out_of_incremental(models):
    _, _, tcfg, tparams = models
    import dataclasses

    t0 = dataclasses.replace(tcfg, sliding_window=0)
    assert _batcher(tparams, t0, 12)._incremental_reserve is False
    assert "attn_window" not in _batcher(tparams, t0, 12).kv_stats()
    dense = tbatch.ContinuousBatcher(tparams, tcfg, **_kw(0, layout="dense"))
    assert dense._incremental_reserve is False
    assert dense.kv_stats()["attn_window"] == W


def test_cancel_mid_growth_returns_pool_to_baseline(models):
    """Cancel after the reservation has grown and recycling has zeroed
    early ledger entries: the release frees exactly the live pages."""
    _, _, tcfg, tparams = models
    cb = _batcher(tparams, tcfg, 6 + 1)
    rid = cb.submit(_prompt(311, 100, tcfg.vocab_size), max_new=20)
    for _ in range(8):  # mid-prefill: grown past the tranche, recycling
        cb.step()
    assert rid in {r.rid for r in cb.prefilling.values()}
    assert cb.pool.in_use > 0
    slot = next(s for s, r in cb.prefilling.items() if r.rid == rid)
    assert cb._recycle_lo.get(slot, 0) > 0  # holes in the ledger
    cb.cancel(rid)
    cb.run(max_steps=50)
    assert cb.pool.in_use == 0
    cb.pool.check()


def test_export_refused_after_recycle_prompts_reprefill(models):
    """The reference's pin: a windowed row whose early pages were
    recycled no longer holds its full rows, so its export is refused and
    asks for a re-prefill."""
    _, _, tcfg, tparams = models
    cb = _batcher(tparams, tcfg, 8 + 1)
    rid = cb.submit(_prompt(312, 40, tcfg.vocab_size), max_new=30)
    while rid not in {r.rid for r in cb.running.values()}:
        cb.step()
    with pytest.raises(ValueError, match="re-prefill"):
        cb.export_kv_pages(rid)
    cb.cancel(rid)
    cb.run(max_steps=50)
    assert cb.pool.in_use == 0
    cb.pool.check()


@pytest.mark.parametrize("depth", [0, 1])
def test_install_into_a_windowed_pool_recycles_and_continues(models, depth):
    """A short windowed row exported before any page left its window
    installs under the full reservation (an install has nothing to
    stream) and decodes on past the window: its pages recycle, its
    stream is the uninterrupted one bit for bit, the pool drains."""
    _, _, tcfg, tparams = models
    p = _prompt(315, 10, tcfg.vocab_size)
    ref = _batcher(tparams, tcfg, 8 + 1, pipeline_depth=depth)
    r = ref.submit(p, max_new=40)
    ref.run(max_steps=200)
    src = _batcher(tparams, tcfg, 8 + 1, pipeline_depth=depth)
    rid = src.submit(p, max_new=40)
    while not any(q.rid == rid and len(q.out) >= 3
                  for q in src.running.values()):
        src.step()
    blob, out, lps = src.export_kv_pages(rid)
    src.cancel(rid)
    dst = _batcher(tparams, tcfg, 8 + 1, pipeline_depth=depth)
    rid = dst.submit(p, max_new=40, resume_out=out, resume_logp=lps,
                     kv_pages=blob)
    dst.run(max_steps=200)
    got, want = dst.done_requests[rid], ref.done_requests[r]
    assert got.out == want.out and got.out_logp == want.out_logp
    assert dst._pages_recycled > 0
    assert dst.pool.in_use == 0
    dst.pool.check()


def test_prefix_promotion_skips_recycled_rows_keeps_short_ones(models):
    _, _, tcfg, tparams = models
    pc = PrefixCache(tcfg, buckets=BUCKETS, budget_bytes=1 << 20)
    cb = _batcher(tparams, tcfg, 8 + 1, prefix_cache=pc)
    # long prompt: its first page is recycled by finish time, so its
    # boundary rows no longer exist and no entry may form
    r_long = cb.submit(_prompt(313, 40, tcfg.vocab_size), max_new=4)
    cb.run(max_steps=200)
    assert r_long in cb.done_requests
    assert pc.stats.promotions == 0
    # short prompt (inside the window): nothing recycled mid-prefill
    r_short = cb.submit(_prompt(314, 17, tcfg.vocab_size), max_new=4)
    cb.run(max_steps=200)
    assert r_short in cb.done_requests
    assert pc.stats.promotions > 0
    cb.pool.check()
    while pc.evict_one():
        pass
    assert cb.pool.in_use == 0
    cb.pool.check()


def test_attn_window_alias_and_health():
    """``--attnWindow`` windows the preset; on a paged pool a request
    past the full-causal wall is served, and ``/v1/health``'s ``kv``
    names the window and the pages recycled (absent at window 0)."""
    base = ["--preset", "tiny", "--device", "cpu", "--host", "127.0.0.1",
            "--port", "0", "--slots", "1", "--maxLen", "128",
            "--chunkedPrefill", "8", "--kvLayout", "paged", "--kvPageSize",
            "16", "--kvPages", "7", "--seed", "3"]
    server = srv.build_server(srv.build_parser().parse_args(
        base + ["--attnWindow", "16", "--prefillReserveChunks", "2"]))
    server.start()
    url = f"http://127.0.0.1:{server.bound_port}"
    try:
        req = urllib.request.Request(
            url + "/v1/generate", data=json.dumps(
                {"prompt": list(range(1, 101)), "max_new": 20}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as resp:
            assert len(json.loads(resp.read())["tokens"]) == 20
        with urllib.request.urlopen(url + "/v1/health", timeout=30) as resp:
            kv = json.loads(resp.read())["kv"]
        assert kv["attn_window"] == 16 and kv["pages_recycled_total"] > 0
        assert kv["pages_in_use"] == 0 and kv["prefill_chunks_deferred"] == 0
    finally:
        server.stop()
    server = srv.build_server(srv.build_parser().parse_args(base))
    server.start()
    url = f"http://127.0.0.1:{server.bound_port}"
    try:
        # full causal: the same request needs 8 pages of the 6
        req = urllib.request.Request(
            url + "/v1/generate", data=json.dumps(
                {"prompt": list(range(1, 101)), "max_new": 20}).encode(),
            headers={"Content-Type": "application/json"})
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(req, timeout=60)
        err = json.loads(ei.value.read())["error"]
        assert ei.value.code == 422 and err["code"] == "request_too_large"
        assert (err["prompt_tokens"], err["max_new"], err["limit"]) == (
            100, 20, 96)
        with urllib.request.urlopen(url + "/v1/health", timeout=30) as resp:
            assert "attn_window" not in json.loads(resp.read())["kv"]
    finally:
        server.stop()
    with pytest.raises(ValueError, match="attnWindow"):
        srv.build_server(srv.build_parser().parse_args(
            base + ["--attnWindow", "-1"]))
