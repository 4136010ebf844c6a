"""The port's speculative continuous batcher (``models/spec_batching.py``)
against the reference's (``tests/test_spec_batching.py``,
``tests/test_spec_fastpath.py``), on the tiny config in f32 with the JAX
weights converted. The partial-acceptance draft is the target's first
layer with its embedding, final norm and head, in both packages.

- Against the reference's ``SpeculativeBatcher`` on one schedule (three
  requests over two slots, synchronous), dense and paged: the same greedy
  tokens, logprobs within 1e-4, the same ``spec_stats`` (rounds,
  proposals drafted and accepted) and the same ``kv_stats`` draft keys
  and bytes.
- Against the port's plain batcher: the same greedy tokens, logprobs
  within 1e-4 (the T = gamma verify and the T = 1 decode sum in other
  orders).
- The reference's matrix, bit for bit inside the port: dense / depth 0 /
  cache on, dense / depth 1 / cache off, paged / depth 1 / cache on (and
  paged / depth 0 / cache off), over admission waves behind two shared
  prompts, promotion, hits, eviction under a tight budget, a cancel in
  flight and a stop sequence; both pools check clean and drain.
- Pool discipline: draft-pool pressure defers once and then admits, a
  request past the draft pool is refused, paged hits copy no row.
- The round updates the batch state in place (a CUDA graph replays it),
  and the draft's prefill finish leaves the shared generator alone.
- The guards raise as the reference's do; the server answers
  ``--draftPreset tiny``, reports ``spec`` with the reference's keys and
  answers 422 to a per-request sampler, logit bias or seed.
"""

import dataclasses
import json
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_gpu_device_plugin_tpu.models import llama as jllama
from k8s_gpu_device_plugin_tpu.models import spec_batching as jspec
from k8s_gpu_device_plugin_torch.models import batching as tbatch
from k8s_gpu_device_plugin_torch.models import llama as tllama
from k8s_gpu_device_plugin_torch.models import spec_batching as tspec
from k8s_gpu_device_plugin_torch.models.convert import params_from_jax
from k8s_gpu_device_plugin_torch.models.generate import generate
from k8s_gpu_device_plugin_torch.models.paging import kv_token_bytes
from k8s_gpu_device_plugin_torch.models.sampling import Sampler
from k8s_gpu_device_plugin_torch.serving import prefix_cache as tpc
from k8s_gpu_device_plugin_torch.serving import server as srv

torch.set_num_threads(1)

BUCKETS = (8, 16, 32)
PS = 16  # divides max_len=64; boundary 8 is inside a page (copy-on-write)
GAMMA = 3
MAX_LEN = 64


@pytest.fixture(scope="module")
def models():
    jcfg = jllama.LlamaConfig.tiny(n_layers=2, dtype=jnp.float32)
    tcfg = tllama.LlamaConfig.tiny(n_layers=2, dtype=torch.float32)
    jparams = jllama.init_params(jax.random.key(0), jcfg)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                              device="cpu")
    jd = (dataclasses.replace(jcfg, n_layers=1),
          {**jparams, "layers": jax.tree.map(lambda x: x[:1],
                                             jparams["layers"])})
    td = (dataclasses.replace(tcfg, n_layers=1),
          {**tparams, "layers": {k: v[:1]
                                 for k, v in tparams["layers"].items()}})
    return jcfg, jparams, tcfg, tparams, jd, td


def _prompt(key, n, vocab=512):
    return np.random.default_rng(key).integers(1, vocab, n).tolist()


def _oracle(params, prompt, cfg, max_new):
    return generate(params, torch.tensor([prompt]), cfg, max_new)[0].tolist()


def _spec(models, layout="dense", pc=None, depth=1, n_slots=2, draft=True,
          **kw):
    _, _, cfg, params, _, (dcfg, dparams) = models
    if not draft:  # a self-draft
        dcfg, dparams = cfg, params
    return tspec.SpeculativeBatcher(
        params, cfg, dparams, dcfg, n_slots=n_slots, max_len=MAX_LEN,
        gamma=kw.pop("gamma", GAMMA), chunked_prefill=kw.pop("chunk", 8),
        prompt_buckets=BUCKETS, pipeline_depth=depth, prefix_cache=pc,
        kv_layout=layout, kv_page_size=PS if layout == "paged" else None,
        **kw)


def _checked(sb):
    if sb.pool is not None:
        sb.pool.check()
        sb.draft_pool.check()


# --- against the reference's batcher ----------------------------------------

SPECS = [(400, 5, 6), (401, 9, 4), (402, 3, 7)]


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_spec_batching_matches_the_reference(models, layout):
    """Three requests over two slots, slot reuse included: the reference's
    tokens, logprobs (1e-4), acceptance counts and draft reservation."""
    jcfg, jparams, tcfg, _, (jdcfg, jdparams), _ = models
    paged = dict(kv_layout=layout, kv_page_size=PS if layout == "paged"
                 else None)
    ref = jspec.SpeculativeBatcher(
        jparams, jcfg, jdparams, jdcfg, n_slots=2, max_len=MAX_LEN,
        gamma=GAMMA, chunked_prefill=4, pipeline_depth=0, **paged)
    got = _spec(models, layout, depth=0, chunk=4)
    jr = [ref.submit(_prompt(k, n), max_new=m) for k, n, m in SPECS]
    tr = [got.submit(_prompt(k, n), max_new=m) for k, n, m in SPECS]
    ref.run()
    got.run()
    for a, b in zip(jr, tr):
        want, have = ref.done_requests[a], got.done_requests[b]
        assert have.out == want.out, b
        np.testing.assert_allclose(have.out_logp, want.out_logp, atol=1e-4,
                                   rtol=0)
    want_stats, have_stats = ref.spec_stats(), got.spec_stats()
    assert have_stats == want_stats
    assert 0 < have_stats["acceptance_rate"] < 1  # partial acceptance
    wkv, hkv = ref.kv_stats(), got.kv_stats()
    for key in ("reserved_bytes", "target_reserved_bytes",
                "draft_reserved_bytes", "draft"):
        assert hkv[key] == wkv[key], key
    _checked(got)
    if got.pool is not None:
        assert got.pool.in_use == 0 and got.draft_pool.in_use == 0


def test_spec_batching_matches_the_plain_batcher(models):
    """The same traffic through the port's plain batcher: the same
    tokens (and ``generate``'s), logprobs within 1e-4."""
    _, _, cfg, params, _, _ = models
    cb = tbatch.ContinuousBatcher(params, cfg, n_slots=2, max_len=MAX_LEN,
                                  chunked_prefill=4)
    sb = _spec(models, chunk=4)
    pr = [cb.submit(_prompt(k, n), max_new=m) for k, n, m in SPECS]
    sr = [sb.submit(_prompt(k, n), max_new=m) for k, n, m in SPECS]
    cb.run()
    sb.run()
    for (k, n, m), a, b in zip(SPECS, pr, sr):
        plain, spec = cb.done_requests[a], sb.done_requests[b]
        assert spec.out == plain.out == _oracle(params, _prompt(k, n), cfg, m)
        np.testing.assert_allclose(spec.out_logp, plain.out_logp, atol=1e-4,
                                   rtol=0)


def test_spec_batching_selfdraft_accepts_everything(models):
    """Draft == target: every proposal verifies, rounds emit gamma
    tokens and the steps collapse."""
    _, _, cfg, params, _, _ = models
    sb = _spec(models, draft=False, n_slots=1, gamma=4)
    p = _prompt(410, 6)
    rid = sb.submit(p, max_new=8)
    steps = 0
    while sb.pending or sb.running or sb.prefilling:
        sb.step()
        steps += 1
    assert sb.done[rid] == _oracle(params, p, cfg, 8)
    # one prefill step and ceil((8 - 1) / 4) = 2 rounds (+ 1 slack)
    assert steps <= 5, steps
    assert sb.spec_stats()["acceptance_rate"] == 1.0


def test_spec_batching_eos_and_logprobs(models):
    """EOS mid-round drops the tail as the plain batcher would."""
    _, _, cfg, params, _, _ = models
    p = _prompt(420, 5)
    oracle = _oracle(params, p, cfg, 6)
    eos = oracle[2]
    assert eos not in oracle[:2]
    sb = _spec(models, n_slots=1, eos_id=eos)
    rid = sb.submit(p, max_new=6)
    sb.run()
    req = sb.done_requests[rid]
    assert req.out == oracle[:3]
    assert len(req.out_logp) == len(req.out)
    assert all(lp <= 0.0 for lp in req.out_logp)


def test_spec_batching_guards(models):
    _, _, cfg, params, _, (dcfg, dparams) = models

    def make(**kw):
        return tspec.SpeculativeBatcher(params, cfg, dparams, dcfg,
                                        n_slots=1, **kw)

    with pytest.raises(ValueError, match="repetition_penalty"):
        make(max_len=64, gamma=3, chunked_prefill=4,
             sampler=Sampler(temperature=0.7, repetition_penalty=1.2))
    with pytest.raises(ValueError, match="chunked_prefill"):
        make(max_len=64, gamma=3)
    with pytest.raises(ValueError, match="vocabulary"):
        tspec.SpeculativeBatcher(
            params, cfg, dparams, dataclasses.replace(dcfg, vocab_size=256),
            n_slots=1, max_len=64, chunked_prefill=4)
    with pytest.raises(ValueError, match="gamma"):
        make(max_len=64, gamma=0, chunked_prefill=4)
    with pytest.raises(ValueError, match="gamma"):
        make(max_len=64, gamma=17, chunked_prefill=4)
    with pytest.raises(ValueError, match="draft_kv_pages"):
        make(max_len=64, chunked_prefill=4, draft_kv_pages=3)
    sb = make(max_len=32, gamma=4, chunked_prefill=4)
    with pytest.raises(ValueError, match="gamma"):
        sb.submit(list(range(1, 21)), max_new=10)  # 20 + 10 + 4 > 32
    with pytest.raises(ValueError, match="resume"):
        sb.submit([1, 2, 3], max_new=8, resume_out=[4, 5])
    for kw, what in ((dict(sampler=Sampler(temperature=0.5)), "samplers"),
                     (dict(logit_bias={5: 1.0}), "logit_bias"),
                     (dict(seed=3), "seeds")):
        with pytest.raises(ValueError, match=what):
            sb.submit([1, 2, 3], max_new=4, **kw)
    for flag in ("per_request_sampler", "per_request_bias",
                 "per_request_seed"):
        assert not getattr(tspec.SpeculativeBatcher, flag)
        assert getattr(tbatch.ContinuousBatcher, flag)


def test_sampled_spec_selfdraft_full_acceptance(models):
    """Sampled, draft == target: q == p, so min(1, p/q) keeps every
    proposal and rounds emit gamma tokens."""
    _, _, cfg, _, _, _ = models
    sb = _spec(models, draft=False, n_slots=1, gamma=4,
               sampler=Sampler(temperature=0.8, top_k=50))
    rid = sb.submit(_prompt(440, 6), max_new=9)
    steps = 0
    while sb.pending or sb.running or sb.prefilling:
        sb.step()
        steps += 1
    out = sb.done[rid]
    assert len(out) == 9 and all(0 <= t < cfg.vocab_size for t in out)
    assert steps <= 5, steps


def test_sampled_spec_streams_complete_with_small_draft(models):
    _, _, cfg, _, _, _ = models
    sb = _spec(models, chunk=4, sampler=Sampler(temperature=0.9, top_p=0.9))
    rids = [sb.submit(_prompt(450 + i, 4 + i), max_new=6) for i in range(3)]
    results = sb.run()
    for rid in rids:
        assert len(results[rid]) == 6
        assert all(0 <= t < cfg.vocab_size for t in results[rid])
        assert len(sb.done_requests[rid].out_logp) == 6


def test_draft_prefill_finish_leaves_the_shared_generator(models):
    """The draft's prefill finish draws from a generator of its own: a
    sampled request's first token (the target's prefill draw) is the
    plain batcher's for the same seed."""
    _, _, cfg, params, _, _ = models
    s = Sampler(temperature=1.0)
    firsts = []
    for make in (lambda: tbatch.ContinuousBatcher(
            params, cfg, n_slots=2, max_len=MAX_LEN, chunked_prefill=8,
            sampler=s, seed=7), lambda: _spec(models, sampler=s, seed=7)):
        cb = make()
        rids = [cb.submit(_prompt(460 + i, 12), max_new=1) for i in range(3)]
        out = cb.run()
        firsts.append([out[r] for r in rids])
    assert firsts[0] == firsts[1]


def test_round_updates_the_state_in_place(models):
    """A CUDA graph replays the round on the same storage: every tensor of
    both states keeps its storage across admissions and rounds."""
    sb = _spec(models, "paged")

    def ptrs():
        out = {}
        for tag, st in (("t", sb.state), ("d", sb.draft_state)):
            for name in ("lengths", "last_token", "active", "budget",
                         "pages"):
                out[tag + name] = getattr(st, name).data_ptr()
            out[tag + "k"] = st.cache.k.data_ptr()
        return out

    before = ptrs()
    for k in range(3):
        sb.submit(_prompt(470 + k, 10), max_new=6)
    for _ in range(4):
        sb.step()
    assert ptrs() == before
    sb.run()
    assert ptrs() == before
    _checked(sb)


# --- the matrix: layout x pipeline depth x prefix cache ---------------------


def _scenario(models, layout, depth, cache_on):
    """Staggered waves behind two shared system prompts (promotion, hits,
    a re-miss after eviction under a tight budget), a cancel in flight and
    a stop sequence: the same interleaving in every configuration."""
    cfg = models[2]
    pc = None
    if cache_on:
        if layout == "paged":
            b = tpc.prefix_kv_bytes(dataclasses.replace(
                cfg, kv_layout="paged", kv_page_size=PS), 16) * 2
        else:
            b = tpc.prefix_kv_bytes(cfg, 8) + tpc.prefix_kv_bytes(cfg, 16)
        pc = tpc.PrefixCache(cfg, buckets=BUCKETS, budget_bytes=b)
    sb = _spec(models, layout, pc=pc, depth=depth)
    sys_a, sys_b = _prompt(520, 17), _prompt(521, 18)
    rids = []

    def sub(base, key, n, new, stop=None):
        rids.append(sb.submit(base + _prompt(key, n), max_new=new, stop=stop))

    sub(sys_a, 530, 5, 5)
    sub(sys_a, 531, 4, 4)
    for _ in range(7):
        sb.step()
    sub(sys_a, 532, 6, 5)
    sub(sys_b, 533, 5, 6)
    for _ in range(4):
        sb.step()
    cancelled = rids[2]
    sb.cancel(cancelled)
    sub(sys_b, 534, 4, 4)
    sub(sys_a, 535, 3, 5, stop=[[cfg.vocab_size - 1, cfg.vocab_size - 1]])
    sb.run()
    streams = {rid: (list(r.out), list(r.out_logp))
               for rid, r in sb.done_requests.items()}
    _checked(sb)
    if sb.prefix_cache is not None:
        while sb.prefix_cache.evict_one():
            pass
    if sb.pool is not None:
        assert sb.pool.in_use == 0 and sb.draft_pool.in_use == 0
        _checked(sb)
    return rids, cancelled, streams, pc, sb


@pytest.fixture(scope="module")
def matrix_reference(models):
    return _scenario(models, "dense", 0, True)


@pytest.mark.parametrize("layout,depth,cache_on", [
    ("dense", 1, False), ("paged", 1, True), ("paged", 0, False)])
def test_spec_matrix_bit_identical_streams(models, matrix_reference,
                                           layout, depth, cache_on):
    ref_rids, ref_cancel, ref_streams, ref_pc, ref_sb = matrix_reference
    assert ref_pc.stats.promotions > 0 and ref_pc.stats.hits > 0
    assert ref_pc.stats.evictions > 0
    assert ref_sb.draft_backfill_chunks > 0
    rids, cancelled, streams, pc, sb = _scenario(models, layout, depth,
                                                 cache_on)
    assert rids == ref_rids and cancelled == ref_cancel
    for rid in rids:
        toks, lps = streams[rid]
        rt, rl = ref_streams[rid]
        if rid == cancelled:
            # the cancel lands at a run-dependent depth: the common part
            # must be bit for bit
            n = min(len(toks), len(rt))
            toks, lps, rt, rl = toks[:n], lps[:n], rt[:n], rl[:n]
        assert toks == rt, rid
        assert lps == rl, rid
    if pc is not None:
        assert pc.stats.promotions > 0 and pc.stats.hits > 0
        assert pc.stats.evictions > 0
    st = sb.spec_stats()
    assert st["rounds"] > 0 and st["tokens_accepted"] > 0


def test_spec_manual_prefix_supported(models):
    """submit(prefix=...): the target takes the precomputed rows, the
    draft re-prefills them, and the stream is the full prompt's."""
    _, _, cfg, params, _, _ = models
    sb = _spec(models)
    sys_p, suffix = _prompt(540, 12), _prompt(541, 6)
    prefix = tbatch.precompute_prefix(params, sys_p, cfg,
                                      prompt_buckets=BUCKETS)
    rid = sb.submit(suffix, max_new=5, prefix=prefix)
    assert sb.run()[rid] == _oracle(params, sys_p + suffix, cfg, 5)
    assert sb.draft_backfill_chunks == 2  # 12 rows on the grid of 8


def test_spec_cancel_mid_backfill_clears_the_queue(models):
    _, _, cfg, params, _, _ = models
    pc = tpc.PrefixCache(cfg, buckets=BUCKETS, budget_bytes=1 << 26)
    sb = _spec(models, pc=pc, n_slots=1)
    sys_p = _prompt(545, 33)
    sb.submit(sys_p + _prompt(546, 3), max_new=2)
    sb.run()
    rid = sb.submit(sys_p + _prompt(547, 4), max_new=4)
    sb.step()  # admitted on a hit: the backfill is queued
    assert sb._draft_backfill
    sb.cancel(rid)
    assert not sb._draft_backfill
    p = sys_p + _prompt(548, 5)
    rid = sb.submit(p, max_new=4)
    assert sb.run()[rid] == _oracle(params, p, cfg, 4)


def test_spec_paged_zero_copy_and_drained_pools(models):
    """Paged hits move no row with a draft in the loop, and both pools
    drain to the surviving cache entries' pages (the draft's to none)."""
    _, _, cfg, params, _, _ = models
    tbatch.reset_kv_copy_counts()
    pc = tpc.PrefixCache(cfg, buckets=BUCKETS, budget_bytes=1 << 26)
    sb = _spec(models, "paged", pc=pc)
    sys_p = _prompt(550, 20)
    for k, n, new in [(551, 5, 5), (552, 4, 4)]:
        p = sys_p + _prompt(k, n)
        rid = sb.submit(p, max_new=new)
        sb.run()
        assert sb.done[rid] == _oracle(params, p, cfg, new)
    assert pc.stats.hits >= 1 and pc.stats.promotions >= 1
    assert tbatch.kv_copy_counts()["rows"] == 0
    _checked(sb)
    assert sb.draft_pool.in_use == 0
    assert sb.pool.in_use > 0  # the cache's pins


def test_spec_draft_pool_pressure_defers_then_admits(models):
    """A draft pool with room for one request: the second waits (counted
    once) and is admitted when the first retires; a request past the
    draft pool is refused at submit."""
    _, _, cfg, params, _, _ = models
    # per request: ceil((9 + 20 + 3) / 16) = 2 draft pages; 2 + the trap
    sb = _spec(models, "paged", draft_kv_pages=2 + 1)
    p1, p2 = _prompt(560, 9), _prompt(561, 9)
    r1 = sb.submit(p1, max_new=20)
    r2 = sb.submit(p2, max_new=20)
    results = sb.run()
    assert results[r1] == _oracle(params, p1, cfg, 20)
    assert results[r2] == _oracle(params, p2, cfg, 20)
    assert sb.kv_rejections()["pool_pressure"] == 1
    _checked(sb)
    assert sb.pool.in_use == 0 and sb.draft_pool.in_use == 0
    with pytest.raises(ValueError, match="draft KV pages"):
        sb.submit(_prompt(562, 20), max_new=25)
    assert sb.kv_rejections()["request_too_large"] == 1


def test_spec_stats_and_kv_comparability(models):
    """``reserved_bytes`` counts both caches, the split kept visible."""
    _, _, cfg, params, _, (dcfg, _) = models
    sb = _spec(models, "paged")
    p = _prompt(570, 6)
    rid = sb.submit(p, max_new=6)
    assert sb.run()[rid] == _oracle(params, p, cfg, 6)
    st = sb.spec_stats()
    assert st["gamma"] == GAMMA and st["rounds"] > 0
    assert 0.0 < st["acceptance_rate"] <= 1.0
    assert 1.0 <= st["accepted_per_round"] <= GAMMA
    kv = sb.kv_stats()
    assert kv["reserved_bytes"] == (kv["target_reserved_bytes"]
                                    + kv["draft_reserved_bytes"])
    assert kv["draft"]["layout"] == "paged"
    assert kv["draft"]["reserved_bytes"] == (
        sb.draft_pool.n_pages * PS * kv_token_bytes(dcfg))
    kvd = _spec(models).kv_stats()
    assert kvd["draft"]["layout"] == "dense"
    assert kvd["reserved_bytes"] == (kvd["target_reserved_bytes"]
                                     + kvd["draft_reserved_bytes"])


# --- the server --------------------------------------------------------------


def _post(url, body):
    req = urllib.request.Request(
        url + "/v1/generate", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


@pytest.fixture(scope="module")
def served(models):
    args = srv.build_parser().parse_args([
        "--device", "cpu", "--preset", "tiny", "--draftPreset", "tiny",
        "--gamma", "3", "--host", "127.0.0.1", "--port", "0", "--maxLen",
        "64", "--chunkedPrefill", "8", "--slots", "2"])
    server = srv.build_server(args)
    server.start()
    yield server, f"http://127.0.0.1:{server.bound_port}"
    server.stop()


def test_server_serves_draft_preset_and_reports_spec(models, served):
    jcfg, jparams, _, _, (jdcfg, jdparams), _ = models
    server, url = served
    cb = server.engine.cb
    assert isinstance(cb, tspec.SpeculativeBatcher)
    assert cb.draft_params is cb.params  # the self-draft shares tensors
    p = _prompt(580, 7)
    status, body = _post(url, {"prompt": p, "max_new": 5, "logprobs": True})
    assert status == 200
    assert body["tokens"] == _oracle(cb.params, p, cb.cfg, 5)
    with urllib.request.urlopen(url + "/v1/health", timeout=30) as resp:
        health = json.loads(resp.read())
    ref = jspec.SpeculativeBatcher(jparams, jcfg, jdparams, jdcfg, n_slots=1,
                                   max_len=MAX_LEN, gamma=GAMMA,
                                   chunked_prefill=8)
    assert set(health["spec"]) == set(ref.spec_stats())
    assert health["spec"]["gamma"] == 3 and health["spec"]["rounds"] > 0
    assert health["spec"]["acceptance_rate"] == 1.0
    assert health["kv"]["draft_reserved_bytes"] > 0


@pytest.mark.parametrize("extra,what", [
    ({"temperature": 0.5}, "per-request sampling"),
    ({"logit_bias": {"5": 2.0}}, "logit_bias"),
    ({"seed": 3}, "seeds"),
    ({"max_new": 60}, "gamma")])
def test_server_refuses_what_the_round_does_not_thread(served, extra, what):
    _, url = served
    status, body = _post(url, {"prompt": [1, 2, 3], "max_new": 4, **extra})
    assert status == 422
    assert what in json.dumps(body)


def test_draft_kv_pages_needs_draft_and_paged():
    for flags in (["--draftKvPages", "5", "--kvLayout", "paged"],
                  ["--draftKvPages", "5", "--draftPreset", "tiny"]):
        args = srv.build_parser().parse_args(
            ["--device", "cpu", "--preset", "tiny", "--port", "0", *flags])
        with pytest.raises(ValueError, match="draftKvPages"):
            srv.build_server(args)
