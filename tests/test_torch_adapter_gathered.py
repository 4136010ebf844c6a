"""Gathered multi-LoRA serving in the port: the compact (L, K, ...)
stacks, the AdapterStore's residency and the admission gate.

The port's counterpart of the reference's ``tests/test_adapter_gathered.py``
(its router case waits for the port's router). The reference's adapters
(drawn with JAX) are carried over with ``lora_params_from_jax``. The pins,
each exact unless stated: the gathered path (K compact slots, the one-hot
over slots) gives token and logprob streams equal bit for bit to the
dense-N path (every adapter in the stacks, the one-hot over registry
indices), across the dense and paged layouts, int8 KV and both pipeline
depths, greedy and seeded; a base request in an adapter batcher is bit
for bit the same request in a batcher without adapters; residency
misses, K-slot overflow, a cancel while deferred, LRU eviction and
run-time registration leave every stream equal to ``generate`` on its
adapter's ``merge_lora`` weights (greedy tokens).
"""

from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_gpu_device_plugin_torch.metrics.exposition import Registry
from k8s_gpu_device_plugin_torch.metrics.serving_metrics import (
    ServingMetrics,
)
from k8s_gpu_device_plugin_torch.models import batching as tbatch
from k8s_gpu_device_plugin_torch.models import llama as tllama
from k8s_gpu_device_plugin_torch.models import lora as tlora
from k8s_gpu_device_plugin_torch.models import lora_serving as tls
from k8s_gpu_device_plugin_torch.models.convert import (
    lora_params_from_jax,
    params_from_jax,
)
from k8s_gpu_device_plugin_torch.models.generate import generate
from k8s_gpu_device_plugin_torch.models.sampling import Sampler
from k8s_gpu_device_plugin_torch.serving import server as srv
from k8s_gpu_device_plugin_torch.serving.faults import FaultPlane
from k8s_gpu_device_plugin_torch.serving.prefix_cache import PrefixCache
from k8s_gpu_device_plugin_torch.serving.scheduler import (
    SchedulerOverloadError,
    make_scheduler,
    parse_adapter_quotas,
)
from k8s_gpu_device_plugin_tpu.models import llama as jllama
from k8s_gpu_device_plugin_tpu.models import lora as jlora

torch.set_num_threads(1)


def _rand_b(lp, seed):
    out = {}
    for i, (t, ab) in enumerate(sorted(lp.items())):
        k = jax.random.fold_in(jax.random.key(seed), i)
        out[t] = {"a": ab["a"],
                  "b": 0.3 * jax.random.normal(k, ab["b"].shape,
                                               ab["b"].dtype)}
    return out


@pytest.fixture(scope="module")
def setup():
    jcfg = jllama.LlamaConfig.tiny(dtype=jnp.float32)
    cfg = tllama.LlamaConfig.tiny(dtype=torch.float32)
    jparams = jllama.init_params(jax.random.key(0), jcfg)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                             device="cpu")
    lcs = [jlora.LoraConfig(rank=4, alpha=8.0, targets=("wq", "wo", "w2")),
           jlora.LoraConfig(rank=8, alpha=16.0),
           jlora.LoraConfig(rank=2, alpha=4.0, targets=("wq", "wk"))]
    entries = []
    for i, lc in enumerate(lcs):
        lp = _rand_b(jlora.init_lora_params(jax.random.key(i + 1), jcfg, lc),
                     20 + i)
        entries.append((f"ad{i}", lora_params_from_jax(
            jax.tree.map(np.asarray, lp), cfg, device="cpu"),
            tlora.LoraConfig(rank=lc.rank, alpha=lc.alpha,
                             targets=tuple(lc.targets))))
    aset = tls.stack_adapters(cfg, entries)
    merged = {-1: params}
    for i, (_, lp, lc) in enumerate(entries):
        merged[i] = tlora.merge_lora(params, lp, lc)
    return cfg, params, aset, merged, entries


def _prompt(seed, n, vocab=512):
    return np.random.default_rng(seed).integers(1, vocab, n).tolist()


def _oracle(params, prompt, cfg, max_new):
    return generate(params, torch.tensor([prompt]), cfg, max_new)[0].tolist()


def _streams(cb, rids):
    cb.run()
    return {k: (cb.done_requests[r].out, cb.done_requests[r].out_logp)
            for k, r in rids.items()}


# --- gathered = dense-N = no adapters for base rows, bit for bit ------------


MATRIX = [("dense", "none", 1), ("dense", "none", 0),
          ("paged", "none", 1), ("paged", "int8", 0), ("dense", "int8", 1)]


@pytest.mark.parametrize("layout,cache_quant,depth", MATRIX)
def test_gathered_matches_dense_across_matrix(setup, layout, cache_quant,
                                              depth):
    """Both modes serve one mixed batch (greedy adapter rows, a seeded
    sampled adapter row, a base row; three requests over two slots, so
    the third's admission changes the active set mid-run): tokens and
    logprobs equal bit for bit. The base row equals a batcher without
    adapters, bit for bit."""
    cfg, params, aset, merged, _ = setup
    cfg = replace(cfg, cache_quant=cache_quant)
    kw = dict(n_slots=2, max_len=64, chunked_prefill=8, pipeline_depth=depth,
              kv_layout=layout, kv_page_size=16 if layout == "paged" else None)

    def serve(**mode):
        cb = tbatch.ContinuousBatcher(params, cfg, **kw, **mode)
        rids = {"a0": cb.submit(_prompt(300, 6), max_new=8, adapter=0)
                if mode else None,
                "a1s": cb.submit(_prompt(301, 5), max_new=6, adapter=1,
                                 sampler=Sampler(temperature=0.9, top_k=12),
                                 seed=7) if mode else None,
                "base": cb.submit(_prompt(302, 4), max_new=5)}
        return cb, _streams(cb, {k: r for k, r in rids.items()
                                 if r is not None})

    dense_cb, dense = serve(adapters=aset, lora_slots=0)
    gathered_cb, gathered = serve(adapters=aset)
    _, plain = serve()
    assert gathered == dense
    assert gathered["base"] == plain["base"]
    st = gathered_cb.adapter_stats()
    assert st["mode"] == "gathered" and st["gathers"] >= 1
    assert dense_cb.adapter_stats()["mode"] == "dense"
    if cache_quant == "none":
        assert gathered["a0"][0] == _oracle(merged[0], _prompt(300, 6), cfg,
                                            8)


def test_a_gather_copies_only_the_slots_that_change(setup):
    """Serial requests on adapters 0, 1, 0, 2 with K = 2: adapter 0 keeps
    its slot while 1 comes and goes, so the third request copies
    nothing; 2 takes 1's slot. Every stream stays its merged oracle."""
    cfg, params, aset, merged, _ = setup
    cb = tbatch.ContinuousBatcher(params, cfg, n_slots=2, max_len=64,
                                  chunked_prefill=8, adapters=aset,
                                  lora_slots=2)
    copies = []
    for a, seed in ((0, 400), (1, 401), (0, 402), (2, 403)):
        p = _prompt(seed, 5)
        rid = cb.submit(p, max_new=4, adapter=a)
        assert cb.run()[rid] == _oracle(merged[a], p, cfg, 4), a
        copies.append(cb.adapter_stats()["slot_copies"])
    assert copies == [1, 2, 2, 3]
    assert cb._lora_slot_of == [0, 2]


# --- K-overflow and residency misses ----------------------------------------


def test_k_overflow_defers_then_serves_exactly(setup):
    """Three distinct adapters over K = 2 slots: the third defers at the
    queue head (``adapter_slots``) until a holder retires, then serves
    exactly."""
    cfg, params, aset, merged, _ = setup
    cb = tbatch.ContinuousBatcher(params, cfg, n_slots=3, max_len=64,
                                  chunked_prefill=8, adapters=aset,
                                  lora_slots=2)
    want, rids = {}, {}
    for a, seed in ((0, 310), (1, 311), (2, 312)):
        p = _prompt(seed, 5)
        rids[a] = cb.submit(p, max_new=6, adapter=a)
        want[a] = _oracle(merged[a], p, cfg, 6)
    done = cb.run()
    for a, rid in rids.items():
        assert done[rid] == want[a], f"adapter {a}"
    st = cb.adapter_stats()
    assert st["deferrals"].get("adapter_slots", 0) >= 1
    assert st["lora_slots"] == 2 and st["registered"] == 3


def test_residency_miss_defers_and_stream_is_baseline_exact(setup):
    """An injected ``adapter.upload`` fault reads as an upload in
    flight: the admission defers once, retries next pass, and the stream
    equals the unfaulted one bit for bit."""
    cfg, params, aset, merged, _ = setup
    p = _prompt(320, 6)
    kw = dict(n_slots=2, max_len=64, chunked_prefill=8, adapters=aset,
              lora_slots=2)
    base = tbatch.ContinuousBatcher(params, cfg, **kw)
    want = _streams(base, {"r": base.submit(p, max_new=6, adapter=1)})
    assert want["r"][0] == _oracle(merged[1], p, cfg, 6)
    plane = FaultPlane.from_spec("adapter.upload:nth=1")
    cb = tbatch.ContinuousBatcher(params, cfg, faults=plane, **kw)
    assert _streams(cb, {"r": cb.submit(p, max_new=6, adapter=1)}) == want
    assert cb.adapter_stats()["deferrals"].get("adapter_miss", 0) == 1
    assert plane.point("adapter.upload").fired == 1


def test_cancel_while_deferred_leaves_store_clean(setup):
    """A request cancelled while adapter-deferred (no slot, no pages)
    leaves nothing behind: the next request's stream equals a batcher
    that never saw it."""
    cfg, params, aset, merged, _ = setup
    p2 = _prompt(331, 5)
    kw = dict(n_slots=2, max_len=64, chunked_prefill=8, adapters=aset,
              lora_slots=2)
    base = tbatch.ContinuousBatcher(params, cfg, **kw)
    want = _streams(base, {"r": base.submit(p2, max_new=6, adapter=0)})
    plane = FaultPlane.from_spec("adapter.upload:p=1.0:seed=1:times=4")
    cb = tbatch.ContinuousBatcher(params, cfg, faults=plane, **kw)
    rid1 = cb.submit(_prompt(330, 5), max_new=6, adapter=2)
    cb.run(max_steps=2)
    assert rid1 in {r.rid for r in cb.pending}
    assert cb.adapter_stats()["deferrals"].get("adapter_miss", 0) == 1
    assert cb.cancel(rid1)
    got = _streams(cb, {"r": cb.submit(p2, max_new=6, adapter=0)})
    assert got == want
    assert want["r"][0] == _oracle(merged[0], p2, cfg, 6)
    assert not cb.pending and not cb.running and not cb.prefilling


def test_lru_residency_budget_evicts_and_stays_exact(setup):
    """A budget under one adapter's bytes: serving 0, 1, 2 in turn
    uploads on a miss (off the engine thread: the admission defers) and
    evicts the idle adapter; every stream stays exact."""
    cfg, params, aset, merged, _ = setup
    store = tls.AdapterStore.from_set(cfg, aset, cache_bytes=1)
    cb = tbatch.ContinuousBatcher(params, cfg, n_slots=1, max_len=64,
                                  chunked_prefill=8, adapters=store,
                                  lora_slots=1)
    for a, seed in ((0, 340), (1, 341), (2, 342)):
        p = _prompt(seed, 5)
        rid = cb.submit(p, max_new=6, adapter=a)
        assert cb.run()[rid] == _oracle(merged[a], p, cfg, 6), a
    st = cb.adapter_stats()
    assert st["evictions"] >= 1 and st["uploads"] >= 3
    assert st["resident"] <= 2
    assert st["deferrals"].get("adapter_miss", 0) >= 1
    assert st["misses"] >= 2 and st["upload_failures"] == 0


# --- run-time registration ----------------------------------------------------


def test_dynamic_register_serve_unregister(setup):
    """Register at run time, serve exactly, unregister: the index
    becomes a tombstone (submit refuses it), the names drop it, and a
    new adapter takes a fresh index."""
    cfg, params, _, merged, entries = setup
    name1, lp1, lc1 = entries[1]
    name2, lp2, lc2 = entries[2]
    store = tls.AdapterStore(cfg)
    store.register(name1, lp1, lc1)
    cb = tbatch.ContinuousBatcher(params, cfg, n_slots=2, max_len=64,
                                  chunked_prefill=8, adapters=store,
                                  lora_slots=2)
    idx2 = cb.register_adapter(name2, lp2, lc2)
    assert idx2 == 1 and cb.adapter_names == (name1, name2)
    p = _prompt(350, 5)
    rid = cb.submit(p, max_new=6, adapter=idx2)
    assert cb.run()[rid] == _oracle(merged[2], p, cfg, 6)
    assert cb.unregister_adapter(name2) == idx2
    assert cb.adapter_names == (name1, "")
    with pytest.raises(ValueError, match="unregistered"):
        cb.submit(p, max_new=4, adapter=idx2)
    lc9 = tlora.LoraConfig(rank=2, alpha=4.0, targets=("wv",))
    lp9 = tlora.init_lora_params(cfg, lc9,
                                 generator=torch.Generator().manual_seed(9),
                                 device="cpu")
    assert cb.register_adapter("ad9", lp9, lc9) == 2
    with pytest.raises(ValueError, match="outside the store's frozen set"):
        cb.register_adapter("bad", entries[0][1], entries[0][2])


def test_unregister_refuses_live_and_evicts_prefix_root(setup):
    """Unregistering an adapter with a live request refuses; after it
    drains, the adapter's prefix-cache root goes."""
    cfg, params, aset, _, _ = setup
    pc = PrefixCache(cfg, buckets=(8, 16), budget_bytes=1 << 26)
    cb = tbatch.ContinuousBatcher(
        params, cfg, n_slots=2, max_len=64, prompt_buckets=(8, 16),
        chunked_prefill=8, adapters=tls.AdapterStore.from_set(cfg, aset),
        lora_slots=2, prefix_cache=pc)
    rid = cb.submit(_prompt(360, 12) + _prompt(361, 4), max_new=4, adapter=2)
    with pytest.raises(ValueError, match="live requests"):
        cb.unregister_adapter("ad2")
    cb.run()
    assert rid in cb.done
    before = pc.stats.as_dict()["entries"]
    assert before >= 1
    cb.unregister_adapter("ad2")
    after = pc.stats.as_dict()
    assert after["entries"] < before and after["evictions"] >= 1


# --- per-adapter quotas (serving/scheduler.py) ---------------------------------


def test_adapter_quota_hard_rejects_and_refunds(setup):
    """``--adapterQuota``'s token bucket through the batcher under both
    policies: an over-quota submit raises the 429 error, a queued
    request's cancel refunds its charge, base and unmetered adapters
    never touch a bucket; the server takes the flag."""
    cfg, params, aset, _, _ = setup
    assert parse_adapter_quotas("") == {}
    for policy in ("fifo", "slo"):
        sched = make_scheduler(policy, adapter_quota="ad0=1:burst=30")
        cb = tbatch.ContinuousBatcher(params, cfg, n_slots=1, max_len=64,
                                      chunked_prefill=8, adapters=aset,
                                      scheduler=sched)
        r1 = cb.submit([1] * 10, max_new=10, adapter=0)  # 20 of 30
        with pytest.raises(SchedulerOverloadError) as ei:
            cb.submit([1] * 10, max_new=10, adapter=0)
        assert ei.value.reason == "adapter_quota"
        assert ei.value.retry_after >= 1
        cb.submit([1] * 10, max_new=10)             # base: no bucket
        cb.submit([1] * 10, max_new=10, adapter=1)  # unmetered
        assert cb.cancel(r1)                        # queued: refunded
        cb.submit([1] * 10, max_new=10, adapter=0)
        st = sched.sched_stats()
        assert st["adapters"]["ad0"]["rejected"] == 1
        assert st["adapters"]["ad0"]["submitted"] == 3
        assert st["rejections"]["adapter_quota"] == 1
        cb.pending.clear()
    args = srv.build_parser().parse_args([
        "--device", "cpu", "--preset", "tiny", "--port", "0",
        "--adapterQuota", "fr=5"])
    server = srv.build_server(args)
    try:
        assert server.engine.cb.scheduler.adapter_quotas["fr"].rate == 5.0
    finally:
        server.engine.shutdown()
        server.server_close()
        server.metrics.close()


# --- metrics hooks --------------------------------------------------------------


def test_adapter_metrics_surface(setup):
    """The four hooks set the registered adapter families: residency
    gauges follow the store; uploads, deferrals and gathers count."""
    cfg, params, aset, merged, _ = setup
    reg = Registry()
    m = ServingMetrics(reg)
    try:
        store = tls.AdapterStore.from_set(cfg, aset, cache_bytes=1)
        cb = tbatch.ContinuousBatcher(params, cfg, n_slots=2, max_len=64,
                                      chunked_prefill=8, adapters=store,
                                      lora_slots=2, metrics=m)
        p = _prompt(370, 5)
        rid = cb.submit(p, max_new=5, adapter=2)
        assert cb.run()[rid] == _oracle(merged[2], p, cfg, 5)
        st = cb.adapter_stats()
        text = reg.render()
        samples = {line.split(" ")[0]: float(line.split(" ")[1])
                   for line in text.splitlines()
                   if line.startswith("gpu_serving_adapter")}
        assert samples["gpu_serving_adapters_registered"] == 3
        assert samples["gpu_serving_adapters_resident"] == st["resident"]
        assert samples["gpu_serving_adapter_resident_bytes"] == \
            st["resident_bytes"] > 0
        assert samples["gpu_serving_adapter_uploads_total"] == st["uploads"]
        assert samples["gpu_serving_adapter_upload_seconds_count"] == \
            st["uploads"]
        assert samples['gpu_serving_adapter_deferred_total{reason='
                       '"adapter_miss"}'] == 1
        assert samples["gpu_serving_adapter_gathers_total"] == \
            st["gathers"] >= 1
    finally:
        m.close()
