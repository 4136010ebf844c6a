"""Automatic prefix caching in the port against the reference's
(``tests/test_prefix_cache.py``): ``serving/prefix_cache.py`` and the
batcher's match, alias, copy-on-write and promotion paths.

- The radix tree, driven with stub rows through the same operations as
  the reference's ``PrefixCache``: the same match depths and misses, the
  same LRU evictions under the same byte budget, the same stats; and
  ``prefix_kv_bytes`` equal for bf16, int8 and int4 caches on both
  layouts (the port's int4 codes are packed two per byte: the bytes they
  really hold).
- Bit identity inside the port (a tiny f32 model): one schedule of
  waves over shared system prompts (greedy, repetition-penalized and
  seeded requests mixed, a cancel in flight, a budget small enough that
  promotions evict live entries) gives the same tokens and logprobs with
  the cache on and off, on the dense and the paged layout, synchronous
  and pipelined; the presence and page-table storage a captured decode
  step reads is written in place, never rebound.
- Against the reference's batcher with its prefix cache (JAX weights
  converted): the same greedy streams, ``cached_tokens`` and
  ``kv_copy_counts()`` (rows copied dense, tail pages copied on write
  paged; a paged hit copies no row) on both layouts; logprobs within
  atol 1e-4 (f32 summation order).
- A manual ``precompute_prefix`` serves the cold prefill's greedy tokens.
- ``pool.check()`` holds after a cancel during a pinned deferral.
- The server: ``cached_tokens`` in the body and the SSE done event, and
  the ``/v1/health`` ``prefix_cache`` key set equal to the reference's.
"""

import dataclasses
import json
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_gpu_device_plugin_tpu.models import batching as jbatch
from k8s_gpu_device_plugin_tpu.models import llama as jllama
from k8s_gpu_device_plugin_tpu.serving import prefix_cache as jpc
from k8s_gpu_device_plugin_torch.models import batching as tbatch
from k8s_gpu_device_plugin_torch.models import llama as tllama
from k8s_gpu_device_plugin_torch.models.convert import params_from_jax
from k8s_gpu_device_plugin_torch.models.sampling import Sampler
from k8s_gpu_device_plugin_torch.serving import prefix_cache as tpc
from k8s_gpu_device_plugin_torch.serving import server as srv

torch.set_num_threads(1)

BUCKETS = (8, 16, 32)
CHUNK = 8
PS = 16


@pytest.fixture(scope="module")
def models():
    jcfg = jllama.LlamaConfig.tiny(dtype=jnp.float32, head_dim_override=64)
    tcfg = tllama.LlamaConfig.tiny(dtype=torch.float32, head_dim_override=64)
    jparams = jllama.init_params(jax.random.key(0), jcfg)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                              device="cpu")
    return jcfg, jparams, tcfg, tparams


def _prompt(key, n, vocab=256):
    return np.random.default_rng(key).integers(1, vocab, n).tolist()


# --- the radix tree, against the reference's (stub rows) --------------------


def _stub(pc, tokens):
    pc.on_prefill_done(tokens, -1, lambda p: f"rows[:{p}]")


def _drive(pc, ops):
    """Run ``ops`` on one cache; returns what each observable step saw:
    match depths (None = miss) and the stats after every step."""
    seen = []
    for op, arg in ops:
        if op == "insert":
            _stub(pc, arg)
            seen.append(("insert", pc.stats.as_dict()))
        else:
            hit = pc.match(arg, -1)
            seen.append(("match", None if hit is None else
                         (hit[1], hit[0].tokens), pc.stats.as_dict()))
    return seen


def _scenario_ops():
    base = _prompt(1, 32)
    p1, p2, p3 = (_prompt(k, 8) for k in (8, 9, 10))
    return [
        # longest boundary wins, capped at len - 1; divergence inside a
        # boundary gap keeps the boundaries below it
        ("insert", base),
        ("match", base), ("match", base + _prompt(2, 3)),
        ("match", base[:16] + _prompt(3, 10)),
        ("match", base[:8] + _prompt(4, 10)), ("match", _prompt(5, 20)),
        # LRU under the budget: touch p1, so p2 is the victim
        ("insert", p1), ("insert", p2), ("match", p1 + [1]),
        ("insert", p3),
        ("match", p1 + [1]), ("match", p2 + [1]), ("match", p3 + [1]),
        # the chunk gate: a prompt no longer than the chunk never matches
        ("match", base[:8]), ("match", base[:8] + [1]),
    ]


@pytest.mark.parametrize("budget_entries,min_hits,chunk", [
    (64, 1, 0), (3, 1, 0), (2, 1, 8), (64, 2, 8)])
def test_radix_tree_matches_and_evicts_as_the_reference(
        models, budget_entries, min_hits, chunk):
    jcfg, _, tcfg, _ = models
    budget = budget_entries * tpc.prefix_kv_bytes(tcfg, 8)
    ref = jpc.PrefixCache(jcfg, buckets=BUCKETS, budget_bytes=budget,
                          min_hits=min_hits, chunk=chunk)
    got = tpc.PrefixCache(tcfg, buckets=BUCKETS, budget_bytes=budget,
                          min_hits=min_hits, chunk=chunk)
    ops = _scenario_ops()
    if min_hits > 1:  # every insert twice: the second sighting promotes
        ops = [x for op in ops for x in ([op, op] if op[0] == "insert"
                                         else [op])]
    want = _drive(ref, ops)
    assert _drive(got, ops) == want
    assert any(s[-1]["evictions"] for s in want) == (budget_entries < 10)
    assert got.stats.resident_bytes <= budget


@pytest.mark.parametrize("quant", ["none", "int8", "int4"])
@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_prefix_kv_bytes_equal_the_reference(quant, layout):
    kw = dict(cache_quant=quant, kv_layout=layout, kv_page_size=PS)
    jcfg = jllama.LlamaConfig.tiny(**kw)
    tcfg = tllama.LlamaConfig.tiny(**kw)
    for p in (8, 17, 64):
        assert tpc.prefix_kv_bytes(tcfg, p) == jpc.prefix_kv_bytes(jcfg, p)
    # the bytes the port's storage really holds, scale planes included
    c = tbatch.KVCache.init(tcfg, 1, 64, "cpu")
    held = sum(x.numel() * x.element_size()
               for x in (c.k, c.v, c.k_scale, c.v_scale) if x is not None)
    assert tpc.prefix_kv_bytes(dataclasses.replace(tcfg, kv_layout="dense"),
                               64) == held


# --- bit identity inside the port: cache on vs off --------------------------


def _scenario(params, cfg, cache_on, depth, layout):
    """Waves over two shared system prompts: greedy and seeded requests
    in one batch, a cancel in flight, and a budget of one {8, 16}
    boundary set, so that the second prompt's promotions evict the
    first's mid-run."""
    budget = tpc.prefix_kv_bytes(cfg, 8) + tpc.prefix_kv_bytes(cfg, 16)
    if layout == "paged":
        budget = 2 * tpc.prefix_kv_bytes(
            dataclasses.replace(cfg, kv_layout="paged", kv_page_size=PS), 16)
    pc = (tpc.PrefixCache(cfg, buckets=BUCKETS, budget_bytes=budget)
          if cache_on else None)
    cb = tbatch.ContinuousBatcher(
        params, cfg, n_slots=2, max_len=64, prompt_buckets=BUCKETS,
        chunked_prefill=CHUNK, pipeline_depth=depth, prefix_cache=pc,
        kv_layout=layout, kv_page_size=PS if layout == "paged" else None)
    sys_a, sys_b = _prompt(20, 17), _prompt(21, 18)
    rids = []

    def sub(base, key, n, new, seed=None, sampler=None):
        rids.append(cb.submit(base + _prompt(key, n), max_new=new,
                              seed=seed, sampler=sampler))

    # the storage a captured decode step reads: aliasing, copies and
    # growth write into it, never rebind it
    storage = (cb.state.presence.data_ptr(),
               None if cb.state.pages is None else cb.state.pages.data_ptr())
    # a greedy request under a repetition penalty: a hit's presence row
    # must equal the cold prefill's
    sub(sys_a, 30, 5, 5, sampler=Sampler(repetition_penalty=1.5))
    sub(sys_a, 31, 4, 4, seed=4)
    for _ in range(7):
        cb.step()
    sub(sys_a, 32, 6, 5, seed=5)
    sub(sys_b, 33, 5, 6)
    for _ in range(4):
        cb.step()
    cancelled = rids[2]
    cb.cancel(cancelled)
    sub(sys_b, 34, 4, 4, seed=7)
    sub(sys_a, 35, 3, 5, sampler=Sampler(repetition_penalty=1.5))
    cb.run()
    assert storage == (
        cb.state.presence.data_ptr(),
        None if cb.state.pages is None else cb.state.pages.data_ptr())
    if cb.pool is not None:
        cb.pool.check()
        held = cb.pool.in_use
        while pc is not None and pc.evict_one():
            pass
        assert cb.pool.in_use == 0 and (held > 0) == cache_on
        cb.pool.check()
    streams = {rid: (req.out, req.out_logp)
               for rid, req in cb.done_requests.items()}
    return rids, cancelled, streams, pc


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_cache_on_off_bit_identical(models, layout):
    _, _, tcfg, tparams = models
    runs = {(on, depth): _scenario(tparams, tcfg, on, depth, layout)
            for on, depth in [(False, 0), (True, 0), (True, 1)]}
    ref_rids, ref_cancel, ref_streams, _ = runs[(False, 0)]
    for key, (rids, cancelled, streams, pc) in runs.items():
        assert rids == ref_rids and cancelled == ref_cancel
        for rid in rids:
            if rid == cancelled:
                # the cancel lands at a run-dependent depth: the common
                # prefix must agree
                toks, lps = streams[rid]
                rt, rl = ref_streams[rid]
                n = min(len(toks), len(rt))
                assert toks[:n] == rt[:n] and lps[:n] == rl[:n], key
            else:
                assert streams[rid] == ref_streams[rid], (key, rid)
        if key[0]:
            assert pc.stats.promotions > 0 and pc.stats.hits > 0
            assert pc.stats.evictions > 0


# --- against the reference's batcher with its prefix cache ------------------


def _waves(vocab):
    """Sequential waves so later requests hit: A promotes boundaries 8
    and 16 of a 20-token system prompt, B matches 16 (page-aligned), C
    shares only the first 12 tokens and matches 8 (inside a page: the
    paged hit copies its tail page), D misses (too short to match)."""
    sys_p = _prompt(40, 20, vocab)
    return [(sys_p + _prompt(41, 5, vocab), 5),
            (sys_p + _prompt(42, 5, vocab), 4),
            (sys_p[:12] + _prompt(43, 6, vocab), 5),
            (_prompt(44, 7, vocab), 3)]


def _serve_waves(cb, waves):
    rids = []
    for prompt, new in waves:
        rids.append(cb.submit(prompt, max_new=new))
        cb.run()
    return [cb.done_requests[r] for r in rids]


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_cached_streams_match_the_reference(models, layout):
    jcfg, jparams, tcfg, tparams = models
    waves = _waves(tcfg.vocab_size)
    kw = dict(n_slots=2, max_len=64, prompt_buckets=BUCKETS,
              chunked_prefill=CHUNK, kv_layout=layout,
              kv_page_size=PS if layout == "paged" else None)
    jbatch.reset_kv_copy_counts()
    jcache = jpc.PrefixCache(jcfg, buckets=BUCKETS, budget_bytes=1 << 26)
    want = _serve_waves(jbatch.ContinuousBatcher(
        jparams, jcfg, pipeline_depth=0, prefix_cache=jcache, **kw), waves)
    want_copies = jbatch.kv_copy_counts()
    tbatch.reset_kv_copy_counts()
    tcache = tpc.PrefixCache(tcfg, buckets=BUCKETS, budget_bytes=1 << 26)
    cb = tbatch.ContinuousBatcher(tparams, tcfg, prefix_cache=tcache, **kw)
    got = _serve_waves(cb, waves)
    for w, g in zip(want, got):
        assert g.out == w.out
        assert g.cached_tokens == w.cached_tokens
        np.testing.assert_allclose(g.out_logp, w.out_logp, atol=1e-4, rtol=0)
    assert [g.cached_tokens for g in got] == [0, 16, 8, 0]
    assert tbatch.kv_copy_counts() == want_copies
    assert tcache.stats.as_dict() == jcache.stats.as_dict()
    if layout == "paged":
        assert want_copies == {"rows": 0, "cow_pages": 1}
        assert cb.pages_aliased == 1  # B's full page; C copied its tail
        cb.pool.check()
    else:
        assert want_copies["rows"] > 0 and want_copies["cow_pages"] == 0
    assert cb.prefill_tokens["prefix_reused"] == 24


def test_manual_prefix_matches_the_reference(models):
    """``precompute_prefix`` + ``submit(prefix=...)`` on both layouts:
    the reference's greedy tokens and ``cached_tokens``; one insert's
    rows counted."""
    jcfg, jparams, tcfg, tparams = models
    pre, tail = _prompt(50, 20, tcfg.vocab_size), _prompt(51, 6)
    kw = dict(n_slots=1, max_len=64, prompt_buckets=BUCKETS,
              chunked_prefill=CHUNK)
    ref = jbatch.ContinuousBatcher(jparams, jcfg, pipeline_depth=0, **kw)
    rr = ref.submit(tail, max_new=5, prefix=jbatch.precompute_prefix(
        jparams, pre, jcfg, prompt_buckets=BUCKETS))
    ref.run()
    want = ref.done_requests[rr]
    for layout in ("dense", "paged"):
        cb = tbatch.ContinuousBatcher(tparams, tcfg, kv_layout=layout,
                                      kv_page_size=PS, **kw)
        state = cb.precompute_shared_prefix(pre)
        assert state.rows.k.shape[2] == 20 and int(state.presence.sum()) == \
            len(set(pre))
        tbatch.reset_kv_copy_counts()
        rid = cb.submit(tail, max_new=5, prefix=state)
        cb.run()
        got = cb.done_requests[rid]
        assert got.out == want.out and got.cached_tokens == want.cached_tokens
        np.testing.assert_allclose(got.out_logp, want.out_logp, atol=1e-4,
                                   rtol=0)
        assert tbatch.kv_copy_counts()["rows"] == 20
        if cb.pool is not None:
            assert cb.pool.in_use == 0
            cb.pool.check()
    with pytest.raises(ValueError, match="chunked_prefill"):
        tbatch.ContinuousBatcher(tparams, tcfg, 1, 64).submit(
            tail, 4, prefix=state)


def test_cancel_during_pinned_deferral_releases_the_pins(models):
    """A paged hit pins its entry's pages at the queue head; when the
    pool is short it waits, and a cancel then gives the pins back."""
    _, _, tcfg, tparams = models
    pc = tpc.PrefixCache(tcfg, buckets=BUCKETS, budget_bytes=1 << 26)
    cb = tbatch.ContinuousBatcher(
        tparams, tcfg, n_slots=2, max_len=64, prompt_buckets=BUCKETS,
        chunked_prefill=CHUNK, prefix_cache=pc, kv_layout="paged",
        kv_page_size=PS, kv_pages=4 + 1)
    sys_p = _prompt(60, 16, tcfg.vocab_size)
    cb.submit(sys_p + _prompt(61, 4), max_new=4)
    cb.run()
    entry_pages = cb.pool.in_use
    assert pc.stats.entries == 2 and entry_pages == 1
    # a long request takes three of the four pages; the hit needs two
    # more than the free one and waits at the head of the queue
    long_rid = cb.submit(_prompt(62, 30), max_new=18)
    cb.step()
    hit = cb.submit(sys_p + _prompt(63, 12), max_new=8)
    cb.step()
    req = cb.pending[0]
    assert req.rid == hit and req.pinned_pages and req.defer_counted
    assert cb.kv_rejections()["pool_pressure"] == 1
    assert cb.cancel(hit)
    assert req.pinned_pages is None
    cb.pool.check()
    cb.run()
    assert len(cb.done[long_rid]) == 18
    cb.pool.check()
    # what stays allocated is what the cache's entries hold (the long
    # request promoted its own boundaries too)
    held = {p for node in pc._lru for p in node.entry.page_ids}
    assert cb.pool.in_use == len(held) > entry_pages
    assert pc.stats.hits == 0  # the cancelled hit was never recorded
    while pc.evict_one():
        pass
    assert cb.pool.in_use == 0
    cb.pool.check()


def test_cache_refusals(models):
    _, _, tcfg, tparams = models
    pc = tpc.PrefixCache(tcfg, buckets=BUCKETS, budget_bytes=1 << 20)
    with pytest.raises(ValueError, match="chunked_prefill"):
        tbatch.ContinuousBatcher(tparams, tcfg, 1, 64,
                                 prompt_buckets=BUCKETS, prefix_cache=pc)
    _stub(pc, _prompt(99, 16))
    with pytest.raises(ValueError, match="different bucket ladder"):
        tbatch.ContinuousBatcher(tparams, tcfg, 1, 64,
                                 prompt_buckets=(16, 64), chunked_prefill=8,
                                 prefix_cache=pc)


# --- the server -------------------------------------------------------------


def test_server_reports_cached_tokens_and_health():
    args = srv.build_parser().parse_args([
        "--preset", "tiny", "--device", "cpu", "--host", "127.0.0.1",
        "--port", "0", "--slots", "2", "--maxLen", "128",
        "--chunkedPrefill", "16", "--seed", "3"])
    server = srv.build_server(args)
    server.start()
    url = f"http://127.0.0.1:{server.bound_port}"
    sys_p = list(range(1, 41))  # past the 32-token boundary

    def post(body):
        req = urllib.request.Request(
            url + "/v1/generate", data=json.dumps(body).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as resp:
            return resp.read().decode()

    try:
        cold = json.loads(post({"prompt": sys_p + [7, 8], "max_new": 4}))
        assert cold["cached_tokens"] == 0
        hit = json.loads(post({"prompt": sys_p + [9, 10], "max_new": 4}))
        assert hit["cached_tokens"] == 32  # two chunks of 16 skipped
        frames = [json.loads(line[len("data: "):]) for line in post(
            {"prompt": sys_p + [11, 12], "max_new": 4, "stream": True}
        ).split("\n\n") if line.startswith("data: ")]
        assert frames[-1] == {"done": True, "cached_tokens": 32}
        with urllib.request.urlopen(url + "/v1/health", timeout=30) as resp:
            health = json.loads(resp.read())
        assert set(health["prefix_cache"]) == set(
            jpc.PrefixCacheStats().as_dict())
        assert health["prefix_cache"]["hits"] == 2
        assert health["prefill_tokens"]["prefix_reused"] == 64
    finally:
        server.stop()
    # the cache is off with --prefixCacheOff and without chunked prefill
    for flags in (["--prefixCacheOff"], ["--chunkedPrefill", "0"]):
        args = srv.build_parser().parse_args([
            "--preset", "tiny", "--device", "cpu", "--port", "0", *flags])
        engine_args = srv.build_server(args)
        try:
            assert engine_args.engine.cb.prefix_cache is None
        finally:
            engine_args.server_close()
            engine_args.engine.shutdown()
