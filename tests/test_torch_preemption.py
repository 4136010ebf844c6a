"""Preemption and the resume seam: the port's batcher against the
reference's, and against itself uninterrupted.

A priority-2 request is decoding in the only slot when a priority-0
request with a 1 ms deadline arrives: the ``slo`` scheduler evicts the
decode, its emitted tokens fold into its prompt, and it resumes by
re-prefill. Held against the JAX batcher under the same scheduler (the
reference's policy, ported), on dense and paged caches at pipeline depth
0 and 1: every stream's tokens are equal, logprobs within 1e-5 (f32; a
resumed token's logprob comes from the finish chunk's forward, not a
T = 1 decode, so it differs in the last bits, in both packages). Inside
the port a preempted stream equals its uninterrupted one token for token
(greedy, seeded sampling, a repetition penalty, the prefix cache on).
``resume_out`` continues a stream another incarnation started with the
same tokens, and injected ``pool.alloc`` faults defer a windowed prompt's
chunks, never the request.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_gpu_device_plugin_torch.models import batching as tbatch
from k8s_gpu_device_plugin_torch.models import llama as tllama
from k8s_gpu_device_plugin_torch.models.convert import params_from_jax
from k8s_gpu_device_plugin_torch.models.sampling import Sampler
from k8s_gpu_device_plugin_torch.serving.faults import FaultPlane
from k8s_gpu_device_plugin_torch.serving.prefix_cache import PrefixCache
from k8s_gpu_device_plugin_torch.serving.scheduler import SloScheduler
from k8s_gpu_device_plugin_tpu.models import batching as jbatch
from k8s_gpu_device_plugin_tpu.models import llama as jllama
from k8s_gpu_device_plugin_tpu.serving import scheduler as jsched

# the suite runs in several worker processes on shared cores: one
# intra-op thread each keeps torch's OpenMP pool from spinning against
# them (these shapes gain nothing from more)
torch.set_num_threads(1)

BUCKETS = (8, 16, 32)
PS = 16


@pytest.fixture(scope="module")
def models():
    jcfg = jllama.LlamaConfig.tiny(dtype=jnp.float32, head_dim_override=64,
                                   n_layers=2)
    tcfg = tllama.LlamaConfig.tiny(dtype=torch.float32, head_dim_override=64,
                                   n_layers=2)
    jparams = jllama.init_params(jax.random.key(0), jcfg)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                              device="cpu")
    return jcfg, jparams, tcfg, tparams


def _prompt(seed, n, vocab):
    return np.random.default_rng(seed).integers(1, vocab, n).tolist()


def _kw(layout, depth, n_slots=1, chunk=8):
    return dict(n_slots=n_slots, max_len=64, prompt_buckets=BUCKETS,
                chunked_prefill=chunk, pipeline_depth=depth,
                kv_layout=layout,
                kv_page_size=PS if layout == "paged" else None)


def _preempted_run(mod, params, cfg, sched, kw, low, hi, low_kw=None,
                   steps=12):
    """The low request decodes ``steps`` steps alone, then the deadlined
    high one arrives; returns both requests once everything ran."""
    cb = mod.ContinuousBatcher(params, cfg, scheduler=sched, **kw)
    lo = cb.submit(low, max_new=20, tenant="bronze", priority=2,
                   **(low_kw or {}))
    for _ in range(steps):
        cb.step()
    assert cb.running, "the low request should be decoding"
    h = cb.submit(hi, max_new=6, tenant="gold", priority=0, deadline_ms=1)
    cb.run()
    return cb, cb.done_requests[lo], cb.done_requests[h]


@pytest.mark.parametrize("layout", ["dense", "paged"])
@pytest.mark.parametrize("depth", [0, 1])
def test_preemption_streams_equal_the_reference(models, layout, depth):
    jcfg, jparams, tcfg, tparams = models
    low, hi = _prompt(1, 9, tcfg.vocab_size), _prompt(2, 9, tcfg.vocab_size)
    kw = _kw(layout, depth)
    jsch, tsch = jsched.SloScheduler(), SloScheduler()
    _, jlo, jhi = _preempted_run(jbatch, jparams, jcfg, jsch, kw, low, hi)
    tcb, tlo, thi = _preempted_run(tbatch, tparams, tcfg, tsch, kw, low, hi)
    assert tlo.preemptions == tsch.preemptions == 1
    assert jlo.preemptions >= 1
    for want, got, n in ((jlo, tlo, 20), (jhi, thi, 6)):
        assert len(got.out) == n
        assert got.out == want.out
        np.testing.assert_allclose(got.out_logp, want.out_logp, atol=1e-5,
                                   rtol=0)
    # the port gives the freed slot to the request it was freed for
    assert thi.t_done < tlo.t_done
    if tcb.pool is not None:
        assert tcb.pool.in_use == 0
    # a resume is not a second admission: WFQ charged the original once
    bronze = tsch.sched_stats()["tenants"]["bronze"]
    assert (bronze["admitted"], bronze["preempted"]) == (1, 1)


@pytest.mark.parametrize("case", ["greedy", "seeded", "penalized",
                                  "prefix_cache"])
def test_preempted_stream_equals_the_uninterrupted_one(models, case):
    _, _, tcfg, tparams = models
    low = _prompt(3, 20, tcfg.vocab_size)
    hi = _prompt(4, 9, tcfg.vocab_size)
    low_kw = {
        "greedy": {},
        "seeded": {"sampler": Sampler(temperature=0.8, top_k=8), "seed": 7},
        "penalized": {"sampler": Sampler(repetition_penalty=1.3)},
        "prefix_cache": {"sampler": Sampler(temperature=0.7), "seed": 5},
    }[case]

    def kw(depth):
        out = _kw("paged", depth)
        if case == "prefix_cache":
            # a cache per batcher: paged entries belong to one pool
            out["prefix_cache"] = PrefixCache(tcfg, buckets=BUCKETS,
                                              budget_bytes=1 << 20)
        return out

    runs = []
    for depth in (0, 1):
        base = tbatch.ContinuousBatcher(tparams, tcfg, **kw(depth))
        rid = base.submit(low, max_new=20, **low_kw)
        base.run()
        want = base.done_requests[rid]
        sched = SloScheduler()
        cb, got, _ = _preempted_run(tbatch, tparams, tcfg, sched, kw(depth),
                                    low, hi, low_kw=low_kw, steps=14)
        assert got.preemptions == 1
        assert got.out == want.out
        np.testing.assert_allclose(got.out_logp, want.out_logp, atol=1e-5,
                                   rtol=0)
        if case == "prefix_cache":
            # the boundaries the first prefill promoted serve the resume
            assert got.cached_tokens > 0
        runs.append(got.out)
    assert runs[0] == runs[1]


def test_resume_out_continues_the_stream(models):
    """``resume_out`` (the cross-incarnation resume seam) continues a
    greedy and a seeded stream from token k with the uninterrupted
    tokens, as the reference's batcher does, and refuses what cannot
    resume."""
    jcfg, jparams, tcfg, tparams = models
    p = _prompt(5, 11, tcfg.vocab_size)
    kw = _kw("dense", 1, n_slots=2)
    for extra in ({}, {"sampler": Sampler(temperature=0.9), "seed": 3}):
        cb = tbatch.ContinuousBatcher(tparams, tcfg, **kw)
        rid = cb.submit(p, max_new=16, **extra)
        cb.run()
        full = cb.done_requests[rid]
        for k in (1, 6, 15):
            rcb = tbatch.ContinuousBatcher(tparams, tcfg, **kw)
            r = rcb.submit(p, max_new=16, resume_out=full.out[:k],
                           resume_logp=full.out_logp[:k], **extra)
            rcb.run()
            got = rcb.done_requests[r]
            assert got.out == full.out
            assert got.prefilled_out == k
            np.testing.assert_allclose(got.out_logp, full.out_logp,
                                       atol=1e-5, rtol=0)
    # the reference's batcher continues the greedy stream the same way
    jcb = jbatch.ContinuousBatcher(jparams, jcfg, **kw)
    r = jcb.submit(p, max_new=16, resume_out=full.out[:6])
    jcb.run()
    cb = tbatch.ContinuousBatcher(tparams, tcfg, **kw)
    r2 = cb.submit(p, max_new=16, resume_out=full.out[:6])
    cb.run()
    assert cb.done_requests[r2].out == jcb.done_requests[r].out
    with pytest.raises(ValueError, match="nothing left"):
        cb.submit(p, max_new=3, resume_out=[1, 2, 3])
    with pytest.raises(ValueError, match="chunked_prefill"):
        tbatch.ContinuousBatcher(tparams, tcfg, n_slots=1, max_len=64,
                                 prompt_buckets=BUCKETS).submit(
            p, max_new=8, resume_out=[1])
    with pytest.raises(ValueError, match="length"):
        cb.submit(p, max_new=8, resume_out=[1, 2], resume_logp=[0.0])


def test_pool_alloc_fault_mid_prompt_defers_chunk_not_request(models):
    """As the reference's ``test_longctx_serving.py`` pins it: injected
    ``pool.alloc`` failures during a windowed prompt's growth defer the
    next chunk only; the request keeps its slot and pages and its stream
    equals the no-fault run's."""
    _, _, tcfg, tparams = models
    from dataclasses import replace

    cfg = replace(tcfg, sliding_window=16)
    p = _prompt(6, 100, cfg.vocab_size)
    kw = dict(n_slots=1, max_len=128, prompt_buckets=(32, 64, 128),
              chunked_prefill=8, kv_layout="paged", kv_page_size=PS,
              kv_pages=7)
    base = tbatch.ContinuousBatcher(tparams, cfg, **kw)
    rb = base.submit(p, max_new=20)
    want = base.run(max_steps=400)[rb]
    # hit 1 is the admission's reservation, hits 2.. the growth calls:
    # nth=2, times=3 lands all three fires mid-prompt
    cb = tbatch.ContinuousBatcher(
        tparams, cfg, faults=FaultPlane.from_spec("pool.alloc:nth=2:times=3"),
        **kw)
    rid = cb.submit(p, max_new=20)
    assert cb.run(max_steps=400)[rid] == want
    assert cb.done_requests[rid].out_logp == base.done_requests[rb].out_logp
    assert cb.chunks_deferred == 3
    assert cb.kv_rejections()["pool_pressure"] == 0  # never re-queued
    assert cb.pool.in_use == 0


def test_preemption_is_refused_where_it_cannot_resume(models):
    _, _, tcfg, tparams = models
    from k8s_gpu_device_plugin_torch.models.spec_batching import (
        SpeculativeBatcher,
    )

    with pytest.raises(ValueError, match="preemption"):
        SpeculativeBatcher(tparams, tcfg, tparams, tcfg, n_slots=2,
                           max_len=64, chunked_prefill=8,
                           prompt_buckets=BUCKETS, scheduler=SloScheduler())
    sb = SpeculativeBatcher(tparams, tcfg, tparams, tcfg, n_slots=2,
                            max_len=64, chunked_prefill=8,
                            prompt_buckets=BUCKETS,
                            scheduler=SloScheduler(preempt=False))
    rid = sb.submit(_prompt(7, 9, tcfg.vocab_size), max_new=4,
                    tenant="gold", priority=0)
    sb.run()
    assert len(sb.done[rid]) == 4
    with pytest.raises(ValueError, match="resume"):
        sb.submit([1, 2, 3], max_new=8, resume_out=[4])

    # the class flags a subclass turns off are refused at construction
    class Plain(tbatch.ContinuousBatcher):
        supports_paged_kv = False
        supports_prefix_cache = False

    with pytest.raises(ValueError, match="paged"):
        Plain(tparams, tcfg, **_kw("paged", 1))
    with pytest.raises(ValueError, match="prefix cache"):
        Plain(tparams, tcfg, prefix_cache=PrefixCache(
            tcfg, buckets=BUCKETS, budget_bytes=1 << 20), **_kw("dense", 1))
    # a bucketed batcher takes the slo policy but never preempts
    sched = SloScheduler()
    cb = tbatch.ContinuousBatcher(tparams, tcfg, n_slots=1, max_len=64,
                                  prompt_buckets=BUCKETS, scheduler=sched)
    lo = cb.submit(_prompt(8, 9, tcfg.vocab_size), max_new=12, priority=2)
    for _ in range(4):
        cb.step()
    hi = cb.submit(_prompt(9, 9, tcfg.vocab_size), max_new=4, priority=0,
                   deadline_ms=1)
    cb.run()
    assert sched.preemptions == 0
    assert len(cb.done[lo]) == 12 and len(cb.done[hi]) == 4
