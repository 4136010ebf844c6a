"""Tensor-parallel serving in the port (``parallel/tp_serving.py`` and
the tp paths of the batcher, the cached forward, the speculative
batcher, the metrics and the server), against tp=1 and the reference.

The reference's ``tests/test_tp_serving.py`` claims, for the port. Its
mesh is ``["cpu"] * tp`` (``tp_devices``): torch has no forced host
device count, so one device is named once a shard.

- **Bit for bit**: greedy and seeded token and logprob streams at tp 2
  and 4 equal tp 1's over dense/paged x prefix cache on/off x pipeline
  depth 0/1, across preemption and resume, a manual prefix and
  speculative rounds; ``tp_allow_psum`` within 1e-4 of tp 1 in f32.
- **Shards**: per-shard shapes, replicated leaves shared (one device
  named tp times), shard views of ``kv_stats`` equal to the reference
  batcher's, the shard gauges, admission under pool pressure drained on
  every shard, int8/int4 KV streams and shard bytes.
- **Refusals**: the mesh-flag rule (the reference's messages), the
  engine with an injected batcher, a prefix cache moved between tp
  degrees, a forward without the mesh, training at tp > 1, the server's
  ``--tp``/``--tpPsum`` before the weights load.
- **Against the reference**: the port at tp 2 against the JAX batcher at
  tp 2 on the conftest's 8 CPU devices, weights moved by
  ``params_from_jax``, dense and paged: greedy tokens equal, f32
  logprobs within 1e-4.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_gpu_device_plugin_tpu.models import batching as jbatch
from k8s_gpu_device_plugin_tpu.models import llama as jllama
from k8s_gpu_device_plugin_tpu.parallel import mesh as jmesh
from k8s_gpu_device_plugin_torch.models import batching as tbatch
from k8s_gpu_device_plugin_torch.models import generate as tgen
from k8s_gpu_device_plugin_torch.models import llama as tllama
from k8s_gpu_device_plugin_torch.models.convert import params_from_jax
from k8s_gpu_device_plugin_torch.parallel import mesh as tmesh
from k8s_gpu_device_plugin_torch.parallel import tp_serving
from k8s_gpu_device_plugin_torch.serving.prefix_cache import (
    PrefixCache,
    prefix_kv_bytes,
)

torch.set_num_threads(1)

BUCKETS = (8, 16, 32)
PS = 16  # page size: divides max_len=64


@pytest.fixture(scope="module")
def setup():
    # the reference's tiny config: n_kv_heads=4, n_heads=8, so tp 2 and 4
    # both divide
    cfg = tllama.LlamaConfig.tiny(n_layers=2)
    return cfg, tllama.init_params(cfg, seed=0, device="cpu")


def _prompt(key, n, cfg):
    g = np.random.default_rng(key)
    return g.integers(1, cfg.vocab_size, n).tolist()


def _devices(tp):
    return ["cpu"] * tp if tp > 1 else None


def _batcher(params, cfg, tp, layout="dense", pc=None, depth=1, n_slots=2,
             chunk=8, **kw):
    return tbatch.ContinuousBatcher(
        params, cfg, n_slots=n_slots, max_len=64, prompt_buckets=BUCKETS,
        chunked_prefill=chunk, pipeline_depth=depth, prefix_cache=pc,
        kv_layout=layout, kv_page_size=PS if layout == "paged" else None,
        tp=tp, tp_devices=_devices(tp), **kw)


def _streams(cb):
    return {rid: (list(r.out), list(r.out_logp))
            for rid, r in cb.done_requests.items()}


# --- bit for bit: tp 1 against tp 2 / 4 ------------------------------------


def _scenario(params, cfg, tp, layout, depth, cache_on):
    """The reference's scenario: staggered waves over a shared system
    prompt, greedy and seeded requests, a stop sequence that cannot
    fire, a cancel mid-flight, a prefix cache small enough to evict."""
    from k8s_gpu_device_plugin_torch.models.sampling import Sampler

    pc = None
    if cache_on:
        b = prefix_kv_bytes(cfg, 8) + prefix_kv_bytes(cfg, 16)
        pc = PrefixCache(cfg, buckets=BUCKETS, budget_bytes=b)
    cb = _batcher(params, cfg, tp, layout, pc=pc, depth=depth)
    sys_a = _prompt(20, 17, cfg)
    rids = []

    def sub(base, key, n, new, seed=None, stop=None):
        kw = {} if seed is None else dict(
            seed=seed, sampler=Sampler(temperature=0.8, top_p=0.95))
        rids.append(cb.submit(base + _prompt(key, n, cfg), max_new=new,
                              stop=stop, **kw))

    sub(sys_a, 30, 5, 5)
    sub(sys_a, 31, 4, 4, seed=4)
    for _ in range(7):
        cb.step()
    sub(sys_a, 32, 6, 5, seed=5)
    sub([], 33, 9, 4)
    for _ in range(4):
        cb.step()
    cancelled = rids[2]
    cb.cancel(cancelled)
    sub(sys_a, 35, 3, 5, stop=[[cfg.vocab_size - 1] * 2])
    cb.run()
    if cb.pool is not None:
        cb.pool.check()
    return rids, cancelled, _streams(cb), cb


@pytest.fixture(scope="module")
def tp1_reference(setup):
    cfg, params = setup
    rids, cancelled, streams, _ = _scenario(params, cfg, 1, "dense", 0, True)
    return rids, cancelled, streams


@pytest.mark.parametrize("tp,layout,depth,cache_on", [
    (2, "dense", 1, True), (2, "paged", 0, True), (2, "paged", 1, False),
    (2, "dense", 0, False), (4, "paged", 1, True), (4, "dense", 0, True)])
def test_tp_streams_bit_identical_across_matrix(setup, tp1_reference, tp,
                                                layout, depth, cache_on):
    cfg, params = setup
    ref_rids, ref_cancel, ref = tp1_reference
    rids, cancelled, streams, cb = _scenario(params, cfg, tp, layout, depth,
                                             cache_on)
    assert rids == ref_rids and cancelled == ref_cancel
    for rid in rids:
        if rid == cancelled:
            (toks, lps), (rt, rl) = streams[rid], ref[rid]
            n = min(len(toks), len(rt))
            assert (toks[:n], lps[:n]) == (rt[:n], rl[:n])
        else:
            assert streams[rid] == ref[rid], rid
    assert cb.mesh.tp == tp and cb.cfg.tp == tp
    assert isinstance(cb.state.cache, tgen.ShardedKVCache)


def test_tp_preempt_resume_bit_identical(setup):
    from k8s_gpu_device_plugin_torch.serving.scheduler import SloScheduler

    cfg, params = setup

    def run(tp):
        cb = _batcher(params, cfg, tp, "paged", n_slots=1,
                      scheduler=SloScheduler(preempt=True))
        r_low = cb.submit(_prompt(5, 8, cfg), max_new=24, priority=5)
        for _ in range(6):
            cb.step()
        cb.submit(_prompt(6, 6, cfg), max_new=4, priority=0, deadline_ms=1)
        cb.run()
        assert cb.done_requests[r_low].preemptions >= 1, "never preempted"
        cb.pool.check()
        assert cb.pool.in_use == 0
        return _streams(cb)

    assert run(2) == run(1)


def test_tp_manual_prefix_bit_identical(setup):
    cfg, params = setup

    def run(tp):
        cb = _batcher(params, cfg, tp)
        pre = cb.precompute_shared_prefix(_prompt(40, 9, cfg))
        if tp > 1:
            assert isinstance(pre.rows, tgen.ShardedKVCache)
        rid = cb.submit(_prompt(41, 4, cfg), max_new=5, prefix=pre)
        cb.run()
        return _streams(cb)[rid]

    assert run(2) == run(1)
    # the sharded rows come from the sharded forward only
    with pytest.raises(ValueError, match="sharded"):
        tbatch.precompute_prefix(params, [1, 2, 3],
                                 dataclasses.replace(cfg, tp=2),
                                 prompt_buckets=BUCKETS)


def test_tp_speculative_bit_identical(setup):
    from k8s_gpu_device_plugin_torch.models.spec_batching import (
        SpeculativeBatcher,
    )

    cfg, params = setup
    d_cfg = dataclasses.replace(cfg, n_layers=1)
    d_params = tllama.init_params(d_cfg, seed=1, device="cpu")

    def run(tp):
        sb = SpeculativeBatcher(
            params, cfg, d_params, d_cfg, n_slots=2, max_len=64, gamma=3,
            prompt_buckets=BUCKETS, chunked_prefill=8, kv_layout="paged",
            kv_page_size=PS, tp=tp, tp_devices=_devices(tp))
        sb.submit(_prompt(1, 11, cfg), max_new=6)
        sb.submit(_prompt(2, 7, cfg), max_new=5)
        sb.run()
        sb.pool.check()
        sb.draft_pool.check()
        if tp > 1:
            # the shard gauges mean what the aggregate means (target and
            # draft) and sum back to it
            s = sb.kv_stats()
            assert sum(sh["reserved_bytes"] for sh in s["shards"]) \
                == s["reserved_bytes"]
            assert isinstance(sb.draft_state.cache, tgen.ShardedKVCache)
        return _streams(sb)

    assert run(2) == run(1)


def test_tp_speculative_draft_heads_must_divide(setup):
    from k8s_gpu_device_plugin_torch.models.spec_batching import (
        SpeculativeBatcher,
    )

    cfg, params = setup
    d_cfg = dataclasses.replace(cfg, n_layers=1, n_heads=3, n_kv_heads=3,
                                head_dim_override=16)
    d_params = tllama.init_params(d_cfg, seed=1, device="cpu")
    with pytest.raises(ValueError, match="draft model's"):
        SpeculativeBatcher(params, cfg, d_params, d_cfg, n_slots=1,
                           max_len=64, prompt_buckets=BUCKETS,
                           chunked_prefill=8, tp=2, tp_devices=["cpu"] * 2)


def test_tp_streams_match_generate_oracle(setup):
    cfg, params = setup
    cb = _batcher(params, cfg, 2, "paged")
    p = _prompt(90, 12, cfg)
    rid = cb.submit(p, max_new=5)
    got = cb.run()[rid]
    want = tgen.generate(params, torch.tensor([p]), cfg, max_new=5)
    assert got == want[0].tolist()


# --- shards --------------------------------------------------------------


def test_shard_shapes_and_shared_replicas(setup):
    cfg, params = setup
    cb = _batcher(params, cfg, 2, "paged")
    sp = cb.params
    assert isinstance(sp, tp_serving.ShardedParams)
    assert sp.placement["layers"]["wq"] == "col"
    assert sp.placement["layers"]["wo"] == "rep"
    assert sp.placement["lm_head"] == "col"
    hd = cfg.head_dim
    for s, tree in enumerate(sp.shards):
        lay = tree["layers"]
        assert lay["wq"].shape == (2, cfg.d_model, cfg.n_heads * hd // 2)
        assert lay["wk"].shape == (2, cfg.d_model, cfg.n_kv_heads * hd // 2)
        assert lay["w1"].shape == (2, cfg.d_model, cfg.d_ff // 2)
        assert tree["lm_head"].shape == (cfg.d_model, cfg.vocab_size // 2)
        # one device named twice: a replicated leaf is the same tensor,
        # a column shard a view of the whole leaf
        assert lay["wo"] is sp["layers"]["wo"]
        assert tree["embed"] is sp["embed"]
        assert lay["wq"].untyped_storage().data_ptr() == \
            sp["layers"]["wq"].untyped_storage().data_ptr()
        assert torch.equal(lay["wq"], sp["layers"]["wq"][..., s * 64:
                                                          (s + 1) * 64])
    assert cb.weight_stats["shard_bytes"] == 0
    # the cache: the head axis third from last, split; tables replicated
    shards = cb.state.cache.shards
    assert [c.k.shape for c in shards] == [
        (2, cb.pool.n_pages, PS, cfg.n_kv_heads // 2, hd)] * 2
    assert all(c.k.is_contiguous() for c in shards)
    assert cb.state.pages.shape == (2, 64 // PS)


def test_tp_psum_opt_out_within_tolerance(setup):
    """wo and w2 row-shard and the partial products are summed: not the
    tp=1 bits, but within 1e-4 of its f32 logprobs and its greedy
    tokens."""
    cfg, _ = setup
    fcfg = dataclasses.replace(cfg, dtype=torch.float32)
    fparams = tllama.init_params(fcfg, seed=0, device="cpu")
    specs = tp_serving.serving_param_specs(
        dataclasses.replace(fcfg, tp=2, tp_allow_psum=True))["layers"]
    assert specs["wo"] == "row" and specs["w2"] == "row"
    assert tp_serving.serving_param_specs(
        dataclasses.replace(fcfg, tp=2))["layers"]["wo"] == "rep"

    def run(tp, psum):
        cb = _batcher(fparams, dataclasses.replace(fcfg, tp_allow_psum=psum),
                      tp, "paged")
        if psum:
            assert cb.params.placement["layers"]["wo"] == "row"
            assert cb.params.shards[1]["layers"]["wo"].shape == (
                2, cfg.n_heads * cfg.head_dim // 2, cfg.d_model)
        rids = [cb.submit(_prompt(77 + i, 9, cfg), max_new=6)
                for i in range(2)]
        cb.run()
        return [cb.done_requests[r] for r in rids]

    for got, want in zip(run(2, True), run(1, False)):
        assert got.out == want.out
        np.testing.assert_allclose(got.out_logp, want.out_logp, atol=1e-4,
                                   rtol=0)


def test_kv_stats_shard_view(setup):
    cfg, params = setup
    # tp=1: the dict has no tp or shards key, dense and paged
    assert set(_batcher(params, cfg, 1).kv_stats()) == {
        "layout", "reserved_bytes"}
    s1 = _batcher(params, cfg, 1, "paged").kv_stats()
    assert "shards" not in s1 and "tp" not in s1
    s = _batcher(params, cfg, 2, "paged").kv_stats()
    assert s["tp"] == 2 and len(s["shards"]) == 2
    for sh in s["shards"]:
        assert sh["reserved_bytes"] * 2 == s["reserved_bytes"]
        assert sh["pages_total"] == s["pages_total"]
        assert sh["pages_free"] == s["pages_free"]
    sd = _batcher(params, cfg, 2).kv_stats()
    assert sd["shards"][0]["reserved_bytes"] * 2 == sd["reserved_bytes"]


def test_serving_metrics_shard_gauges():
    from k8s_gpu_device_plugin_torch.metrics.exposition import Registry
    from k8s_gpu_device_plugin_torch.metrics.serving_metrics import (
        ServingMetrics,
    )

    reg = Registry()
    m = ServingMetrics(reg)
    m.set_kv_shards([
        {"shard": 0, "reserved_bytes": 100, "pages_in_use": 3,
         "in_use_bytes": 48},
        {"shard": 1, "reserved_bytes": 100, "pages_in_use": 3,
         "in_use_bytes": 48}])
    text = reg.render()
    assert 'kv_shard_reserved_bytes{shard="1"} 100' in text
    assert 'kv_shard_pages_in_use{shard="0"} 3' in text
    assert 'kv_shard_in_use_bytes{shard="0"} 48' in text


def test_batcher_pushes_shard_gauges(setup):
    cfg, params = setup

    class _Rec:
        def __init__(self):
            self.shards, self.calls = None, 0

        def set_kv_shards(self, shards):
            self.shards = shards
            self.calls += 1

        def __getattr__(self, name):  # every other hook: a no-op
            return lambda *a, **k: None

    rec1 = _Rec()
    _batcher(params, cfg, 1, "paged", metrics=rec1)
    assert rec1.calls == 0, "tp=1 emits no shard gauges"
    rec = _Rec()
    cb = _batcher(params, cfg, 2, "paged", metrics=rec)
    assert rec.calls > 0 and len(rec.shards) == 2
    rid = cb.submit(_prompt(60, 9, cfg), max_new=4)
    cb.run()
    assert cb.done[rid]
    assert rec.shards[0]["pages_in_use"] == 0  # drained back


def test_sharded_admission_under_pool_pressure(setup):
    cfg, params = setup
    cb = _batcher(params, cfg, 2, "paged", kv_pages=4, n_slots=2)
    baseline = [s["pages_free"] for s in cb.kv_stats()["shards"]]
    r1 = cb.submit(_prompt(70, 9, cfg), max_new=8)    # needs 2 pages
    r2 = cb.submit(_prompt(71, 9, cfg), max_new=8)    # must defer
    cb.step()
    shards = cb.kv_stats()["shards"]
    assert all(s["pages_free"] < b for s, b in zip(shards, baseline))
    assert cb.pending and cb.pending[0].rid == r2
    assert cb.cancel(r2)
    cb.run()
    assert cb.done[r1] is not None
    assert [s["pages_free"] for s in cb.kv_stats()["shards"]] == baseline
    cb.pool.check()


@pytest.mark.parametrize("quant", ["int8", "int4"])
def test_tp_quantized_cache_streams_and_shard_bytes(setup, quant):
    from k8s_gpu_device_plugin_torch.models.paging import (
        kv_shard_token_bytes,
        kv_token_bytes,
    )

    cfg, params = setup
    qcfg = dataclasses.replace(cfg, cache_quant=quant)
    assert kv_shard_token_bytes(dataclasses.replace(qcfg, tp=2)) * 2 \
        == kv_token_bytes(qcfg)

    def run(tp, layout):
        cb = _batcher(params, qcfg, tp, layout)
        if tp > 1:
            c = cb.state.cache.shards[0]
            assert c.k_scale.shape[-2] == cfg.n_kv_heads // 2
            s = cb.kv_stats()
            planes = (c.k, c.v, c.k_scale, c.v_scale)
            assert s["shards"][0]["reserved_bytes"] * 2 == \
                s["reserved_bytes"]
            assert s["shards"][0]["reserved_bytes"] == sum(
                x.numel() * x.element_size() for x in planes)
        rid = cb.submit(_prompt(95, 10, cfg), max_new=5)
        cb.run()
        return _streams(cb)[rid]

    want = run(1, "dense")
    assert run(2, "dense") == want
    assert run(2, "paged") == want


def test_kv_export_install_across_tp(setup):
    """The wire is tp-agnostic: pages a tp=2 pool exports install into a
    tp=1 pool (and back), and the stream goes on as uninterrupted."""
    cfg, params = setup
    p = _prompt(110, 20, cfg)

    def whole(tp):
        cb = _batcher(params, cfg, tp, "paged", pc=None)
        rid = cb.submit(p, max_new=10)
        cb.run()
        return _streams(cb)[rid]

    want = whole(1)
    for src, dst in ((2, 1), (1, 4)):
        a = _batcher(params, cfg, src, "paged", depth=0)
        rid = a.submit(p, max_new=10)
        while not a.running or len(a.running[0].out) < 3:
            a.step()
        blob, out, lps = a.export_kv_pages(rid)
        b = _batcher(params, cfg, dst, "paged", depth=0)
        rid2 = b.submit(p, max_new=10, resume_out=out, resume_logp=lps,
                        kv_pages=blob)
        b.run()
        got = b.done_requests[rid2]
        # the resumed request's stream carries the tokens it resumed from
        assert got.out[:len(out)] == out
        assert (list(got.out), list(got.out_logp)) == want


# --- refusals --------------------------------------------------------------


def test_from_flags_matches_the_reference_rule():
    """The mesh-flag rule over a grid: the same outcome and message as
    the reference's ``MeshSpec.from_flags``."""
    for tp in (1, 2, 3, 4, 8, 16):
        for n in (1, 2, 4, 6, 8):
            for heads in (None, 1, 4, 8):
                for exact in (True, False):
                    kw = dict(tp=tp, n_devices=n, n_kv_heads=heads,
                              exact=exact)
                    try:
                        want = jmesh.MeshSpec.from_flags(**kw).sizes()
                    except ValueError as e:
                        with pytest.raises(ValueError) as got:
                            tmesh.MeshSpec.from_flags(**kw)
                        assert str(got.value) == str(e), kw
                        continue
                    assert tmesh.MeshSpec.from_flags(**kw).sizes() == want
    with pytest.raises(ValueError, match="tp must be >= 1"):
        tmesh.MeshSpec.from_flags(tp=0, n_devices=8)


def test_batcher_tp_refusals(setup):
    cfg, params = setup
    with pytest.raises(ValueError, match="n_kv_heads"):
        _batcher(params, cfg, 8)
    with pytest.raises(ValueError, match="needs 2 devices"):
        tbatch.ContinuousBatcher(params, cfg, n_slots=1, max_len=64, tp=2,
                                 tp_devices=["cpu"])
    with pytest.raises(ValueError, match="tp > 1 mesh"):
        tbatch.ContinuousBatcher(params, cfg, n_slots=1, max_len=64,
                                 tp_devices=["cpu"])


def test_forward_without_the_mesh_raises(setup):
    cfg, params = setup
    tcfg = dataclasses.replace(cfg, tp=2)
    cache = tgen.KVCache.init(tcfg, 1, 16, "cpu")
    with pytest.raises(ValueError, match="serving mesh"):
        tgen._forward_cached(params, torch.ones((1, 4), dtype=torch.long),
                             cache, 0, tcfg)
    mesh = tp_serving.serving_mesh(2, cfg.n_kv_heads, ["cpu"] * 2)
    sharded = tp_serving.shard_serving_params(params, tcfg, mesh)
    with pytest.raises(ValueError, match="serving mesh"):
        tgen._forward_cached(sharded, torch.ones((1, 4), dtype=torch.long),
                             cache, 0, tcfg)


def test_training_refuses_tp():
    from k8s_gpu_device_plugin_torch.models import train, trainer

    cfg = tllama.LlamaConfig.tiny(tp=2)
    with pytest.raises(NotImplementedError, match="A.13"):
        trainer.Trainer(trainer.TrainerConfig(model=cfg, device="cpu"))
    with pytest.raises(NotImplementedError, match="A.13"):
        train.make_train_step(cfg, train.make_optimizer())


def test_engine_refuses_tp_with_injected_batcher(setup):
    from k8s_gpu_device_plugin_torch.serving.server import InferenceEngine

    cfg, params = setup
    cb = _batcher(params, cfg, 1)
    with pytest.raises(ValueError, match="injected batcher"):
        InferenceEngine(cb, tp=2)


def test_engine_health_reports_shards(setup):
    from k8s_gpu_device_plugin_torch.serving.server import InferenceEngine

    cfg, params = setup
    engine = InferenceEngine(make_batcher=lambda: _batcher(
        params, cfg, 2, "paged"), tp=2)
    try:
        stats = engine.stats()
        kv = stats["kv"]
        assert kv["tp"] == 2 and len(kv["shards"]) == 2
        assert kv["shards"][0]["reserved_bytes"] * 2 == kv["reserved_bytes"]
        assert stats["weights"]["shard_bytes"] == 0
        assert "per shard over the tp=2 serving mesh" in \
            stats["decode_attn"]["decode"]["reason"]
    finally:
        engine.shutdown()


def test_prefix_cache_cannot_move_between_tp_degrees(setup):
    cfg, params = setup
    pc = PrefixCache(cfg, buckets=BUCKETS, budget_bytes=1 << 24)
    cb = _batcher(params, cfg, 2, pc=pc)
    cb.submit(_prompt(80, 17, cfg), max_new=3)
    cb.run()
    assert pc.stats.entries > 0, "nothing promoted"
    with pytest.raises(ValueError, match="tp="):
        _batcher(params, cfg, 1, pc=pc)


def test_server_tp_flags_fail_before_the_weights_load(monkeypatch, capsys):
    from k8s_gpu_device_plugin_torch.serving import server

    def no_load(*a, **k):
        raise AssertionError("the weights loaded")

    monkeypatch.setattr(server, "load_params", no_load)
    # --tp > 1 sets the exact-cuBLAS variable when unset: keep it scoped
    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":0:0")
    base = ["--device", "cpu", "--preset", "tiny", "--port", "0"]
    assert server._main(base + ["--tp", "3"]) == 2
    assert "needs 3 devices but only 1 are visible" in capsys.readouterr().err
    assert server._main(base + ["--tpPsum"]) == 2
    assert "--tpPsum needs --tp > 1" in capsys.readouterr().err
    # the in-process seam: eight named devices, tp 3 does not divide them
    # (the reference's words), tp 8 does not divide the KV heads
    args = server.build_parser().parse_args(base + ["--tp", "3"])
    with pytest.raises(ValueError, match="8 devices not divisible"):
        server.build_server(args, tp_devices=["cpu"] * 8)
    args = server.build_parser().parse_args(base + ["--tp", "8"])
    with pytest.raises(ValueError, match="does not divide n_kv_heads=4"):
        server.build_server(args, tp_devices=["cpu"] * 8)


def test_server_serves_at_tp2(setup):
    """``--tp 2`` through ``build_server`` on a repeated device: the
    stream equals the tp=1 server's."""
    import json
    import threading
    import urllib.request

    from k8s_gpu_device_plugin_torch.serving import server

    cfg, params = setup
    body = json.dumps({"prompt": _prompt(7, 12, cfg), "max_new": 6,
                       "logprobs": True}).encode()
    answers = []
    for tp in (1, 2):
        argv = ["--device", "cpu", "--preset", "tiny", "--port", "0",
                "--host", "127.0.0.1", "--slots", "2", "--maxLen", "64",
                "--chunkedPrefill", "8", "--tp", str(tp)]
        srv = server.build_server(server.build_parser().parse_args(argv),
                                  params=params, tp_devices=_devices(tp))
        thread = threading.Thread(target=srv.serve_forever, daemon=True)
        thread.start()
        try:
            req = urllib.request.Request(
                f"http://127.0.0.1:{srv.bound_port}/v1/generate", data=body,
                headers={"Content-Type": "application/json"})
            answers.append(json.loads(urllib.request.urlopen(
                req, timeout=60).read()))
            health = json.loads(urllib.request.urlopen(
                f"http://127.0.0.1:{srv.bound_port}/v1/health",
                timeout=60).read())
            assert ("shards" in health["kv"]) == (tp > 1)
        finally:
            srv.shutdown()
            srv.server_close()
            srv.engine.shutdown()
            thread.join(timeout=30)
    assert answers[0]["tokens"] == answers[1]["tokens"]
    assert answers[0]["logprobs"] == answers[1]["logprobs"]


# --- the quantized, LoRA and MoE leaves replicate ------------------------


def test_quantized_lora_and_moe_serve_at_tp2(setup):
    """Quantized weight leaves, LoRA stacks and MoE experts replicate
    (the q/k/v of a replicated leaf is the whole product, cut to the
    shard's columns; the MoE decode mix runs whole): each serves at tp 2
    with tp 1's streams bit for bit."""
    from k8s_gpu_device_plugin_torch.models.lora_serving import (
        init_random_adapters,
        stack_adapters,
    )
    from k8s_gpu_device_plugin_torch.models.quantized_serving import (
        quantize_weights,
    )

    cfg, params = setup
    moe_cfg = dataclasses.replace(cfg, n_experts=4)
    cases = {
        "w8": (cfg, quantize_weights(params, "int8"), {}),
        "w4": (cfg, quantize_weights(params, "int4"), {}),
        "moe": (moe_cfg, tllama.init_params(moe_cfg, seed=3, device="cpu"),
                {}),
        "lora": (cfg, params, dict(adapters=stack_adapters(
            cfg, init_random_adapters(cfg, 2, 4, device="cpu")))),
    }
    for name, (c, p, kw) in cases.items():
        def run(tp):
            cb = _batcher(p, c, tp, "paged", **kw)
            if tp > 1 and name.startswith("w"):
                assert cb.params.placement["layers"]["wq"] == "rep"
            rids = [cb.submit(_prompt(120 + i, 10, cfg), max_new=5,
                              **({"adapter": i - 1} if kw else {}))
                    for i in range(3)]
            cb.run()
            return [_streams(cb)[r] for r in rids]

        assert run(2) == run(1), name


# --- against the reference: the port at tp 2, the JAX batcher at tp 2 -----


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_tp2_matches_the_reference_batcher(layout):
    """The same f32 weights (``params_from_jax``) through the JAX batcher
    at tp 2 (the conftest's 8 CPU devices) and the port's at tp 2: greedy
    tokens equal, logprobs within 1e-4; on the paged layout the two
    ``kv_stats`` agree key for key, their shard views included."""
    jcfg = jllama.LlamaConfig.tiny(n_layers=2, dtype=jnp.float32)
    tcfg = tllama.LlamaConfig.tiny(n_layers=2, dtype=torch.float32)
    jparams = jllama.init_params(jax.random.key(0), jcfg)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                              device="cpu")
    kw = dict(n_slots=2, max_len=64, prompt_buckets=BUCKETS,
              chunked_prefill=8, pipeline_depth=0, kv_layout=layout,
              kv_page_size=PS if layout == "paged" else None, tp=2)
    prompts = [_prompt(130 + i, n, tcfg) for i, n in enumerate((11, 20, 5))]

    def serve(cb):
        rids = [cb.submit(p, max_new=6) for p in prompts]
        mid = None
        while cb.pending or cb.running or cb.prefilling:
            cb.step()
            if mid is None and len(cb.running) == 2:
                mid = cb.kv_stats()
        return [cb.done_requests[r] for r in rids], mid

    want, jmid = serve(jbatch.ContinuousBatcher(jparams, jcfg, **kw))
    got, tmid = serve(tbatch.ContinuousBatcher(
        tparams, tcfg, tp_devices=["cpu"] * 2, **kw))
    for g, w in zip(got, want):
        assert g.out == w.out
        np.testing.assert_allclose(g.out_logp, w.out_logp, atol=1e-4,
                                   rtol=0)
    assert tmid["tp"] == jmid["tp"] == 2
    for key, value in jmid.items():
        assert tmid[key] == pytest.approx(value), key
