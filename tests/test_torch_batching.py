"""The port's continuous batcher against the reference's.

Both batchers serve the same four requests (prompt lengths 5, 16, 40 and
70; two slots, max_len 128, chunked prefill 16, the reference in its
synchronous ``pipeline_depth=0`` loop), admitted in the same order, on
the same f32 weights. Greedy streams must be equal; logprobs agree
within atol 1e-4 (f32, summation order only).
"""

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
from k8s_gpu_device_plugin_torch.models.sampling import Sampler

# the suite runs in several worker processes on shared cores: one
# intra-op thread each keeps torch's OpenMP pool from spinning against
# them (these shapes gain nothing from more)
torch.set_num_threads(1)

SPECS = [(5, 9), (16, 6), (40, 12), (70, 7)]  # (prompt length, max_new)


@pytest.fixture(scope="module")
def models():
    jcfg = jllama.LlamaConfig.tiny(dtype=jnp.float32, head_dim_override=64)
    tcfg = tllama.LlamaConfig.tiny(dtype=torch.float32, head_dim_override=64)
    jparams = jllama.init_params(jax.random.key(0), jcfg)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                              device="cpu")
    return jcfg, jparams, tcfg, tparams


def _prompts(vocab):
    rng = np.random.default_rng(11)
    return [rng.integers(1, vocab, n).tolist() for n, _ in SPECS]


def test_greedy_streams_and_logprobs_match_reference(models):
    jcfg, jparams, tcfg, tparams = models
    prompts = _prompts(jcfg.vocab_size)
    jcb = jbatch.ContinuousBatcher(jparams, jcfg, n_slots=2, max_len=128,
                                   chunked_prefill=16, pipeline_depth=0)
    tcb = tbatch.ContinuousBatcher(tparams, tcfg, n_slots=2, max_len=128,
                                   chunked_prefill=16)
    jr = [jcb.submit(p, max_new=n) for p, (_, n) in zip(prompts, SPECS)]
    tr = [tcb.submit(p, max_new=n) for p, (_, n) in zip(prompts, SPECS)]
    jcb.run()
    tcb.run()
    for a, b, (_, n) in zip(jr, tr, SPECS):
        want, got = jcb.done_requests[a], tcb.done_requests[b]
        assert len(got.out) == n
        assert got.out == want.out
        np.testing.assert_allclose(got.out_logp, want.out_logp, atol=1e-4,
                                   rtol=0)
    assert tcb.prefill_chunks == sum(max(1, -(-n // 16)) for n, _ in SPECS)


def _seeded_stream(tparams, tcfg, neighbours):
    cb = tbatch.ContinuousBatcher(tparams, tcfg, n_slots=3, max_len=128,
                                  chunked_prefill=16, seed=5)
    sampler = Sampler(temperature=1.0, top_k=40, top_p=0.9)
    rid = cb.submit(list(range(3, 30)), max_new=10, sampler=sampler, seed=77)
    for i, plen in enumerate(neighbours):
        cb.submit(list(range(1, plen + 1)), max_new=12,
                  sampler=Sampler(temperature=0.8), seed=i if i % 2 else None)
    return cb.run()[rid]


def test_seeded_stream_does_not_depend_on_neighbours(models):
    _, _, tcfg, tparams = models
    alone = _seeded_stream(tparams, tcfg, [])
    crowded = _seeded_stream(tparams, tcfg, [9, 33, 50])
    assert len(alone) == 10
    assert crowded == alone


def test_stop_sequence_and_cancel(models):
    _, _, tcfg, tparams = models
    cb = tbatch.ContinuousBatcher(tparams, tcfg, n_slots=2, max_len=128,
                                  chunked_prefill=16)
    first = cb.submit([4, 5, 6], max_new=8)
    full = cb.run()[first]
    stop = full[2:4]
    ends = next(j for j in range(2, 9) if full[j - 2:j] == stop)
    rid = cb.submit([4, 5, 6], max_new=8, stop=[stop])
    assert cb.run()[rid] == full[:ends]
    rid = cb.submit(list(range(1, 60)), max_new=8)
    cb.step()  # admitted, first chunk prefilled
    assert cb.cancel(rid) and not cb.cancel(rid)
    assert cb.run()[rid] == [] and not cb.prefilling


def test_refuses_what_the_slice_does_not_serve(models):
    """What is still unserved is refused; the pipelined loop, bucketed
    prefill and logit bias are served now, with the reference's
    defaults (pipeline_depth 1, chunked_prefill 0) and its bounds."""
    _, _, tcfg, tparams = models
    with pytest.raises(NotImplementedError, match="adapters"):
        tbatch.ContinuousBatcher(tparams, tcfg, 2, 128, adapters=object())
    with pytest.raises(NotImplementedError, match="tenant"):
        tbatch.ContinuousBatcher(tparams, tcfg, 2, 128).submit(
            [1, 2], 4, tenant="gold")
    with pytest.raises(ValueError, match="pipeline_depth"):
        tbatch.ContinuousBatcher(tparams, tcfg, 2, 128, pipeline_depth=2)
    with pytest.raises(ValueError, match="no prompt bucket"):
        tbatch.ContinuousBatcher(tparams, tcfg, 2, 16, prompt_buckets=(32,))
    cb = tbatch.ContinuousBatcher(tparams, tcfg, 2, 128, kv_layout=None)
    assert (cb.pipeline_depth, cb.chunk) == (1, 0)
    assert cb.submit([1, 2], 4, logit_bias={1: 5.0}) == 0
    with pytest.raises(ValueError, match="exceeds largest bucket"):
        tbatch.ContinuousBatcher(tparams, tcfg, 2, 128,
                                 prompt_buckets=(32,)).submit(
            list(range(1, 40)), max_new=4)
    with pytest.raises(tbatch.RequestTooLargeError):
        cb.submit(list(range(1, 100)), max_new=40)
