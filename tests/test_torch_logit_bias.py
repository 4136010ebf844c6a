"""Per-request logit bias in the port against the reference's.

The bias is added to the raw logits before the penalty and every filter,
per slot, as one (B, V) plane of the decode step; greedy rows take the
argmax of the biased logits, and logprobs stay over the unbiased
distribution. Pins, on a tiny f32 model with the JAX weights converted:

- one batch of a forced (+100), a banned (-100 on the unbiased first
  token) and an unbiased request: greedy streams equal the JAX batcher's
  on the same requests, logprobs within atol 1e-4 (summation order
  only), the forced stream is the forced token, the neighbour is
  untouched (as the reference's ``tests/test_logit_bias.py`` pins force
  and ban); inside the port the paged layout gives the dense layout's
  biased streams bit for bit;
- the validation cases of the reference (vocabulary, [-100, 100], at
  most 300 entries);
- a zero bias row leaves the sampler's f32 logits as they are, and a
  retired slot's row goes back to zeros;
- a seeded stream with a bias is the same alone and among neighbours.
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
from k8s_gpu_device_plugin_torch.models.sampling import (
    Sampler,
    sample_logits_dyn,
)

torch.set_num_threads(1)

FORCED = 123


@pytest.fixture(scope="module")
def models():
    jcfg = jllama.LlamaConfig.tiny(dtype=jnp.float32, head_dim_override=64)
    tcfg = tllama.LlamaConfig.tiny(dtype=torch.float32, head_dim_override=64)
    jparams = jllama.init_params(jax.random.key(0), jcfg)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                              device="cpu")
    return jcfg, jparams, tcfg, tparams


def _prompt(seed, n, vocab):
    return np.random.default_rng(seed).integers(1, vocab, n).tolist()


def _three(cb, prompt, banned):
    return [cb.submit(prompt, max_new=5, logit_bias={FORCED: 100.0}),
            cb.submit(prompt, max_new=5, logit_bias={banned: -100.0}),
            cb.submit(prompt, max_new=5)]


def test_force_and_ban_match_the_reference(models):
    jcfg, jparams, tcfg, tparams = models
    prompt = _prompt(1, 9, jcfg.vocab_size)
    kw = dict(n_slots=3, max_len=64, prompt_buckets=(32,))
    plain = tbatch.ContinuousBatcher(tparams, tcfg, **kw)
    rid = plain.submit(prompt, max_new=5)
    unbiased = plain.run()[rid]
    jcb = jbatch.ContinuousBatcher(jparams, jcfg, pipeline_depth=0, **kw)
    tcb = tbatch.ContinuousBatcher(tparams, tcfg, **kw)
    jr = _three(jcb, prompt, unbiased[0])
    tr = _three(tcb, prompt, unbiased[0])
    jcb.run()
    tcb.run()
    got = [tcb.done_requests[r] for r in tr]
    for want, mine in zip((jcb.done_requests[r] for r in jr), got):
        assert mine.out == want.out
        np.testing.assert_allclose(mine.out_logp, want.out_logp, atol=1e-4,
                                   rtol=0)
    assert got[0].out == [FORCED] * 5
    assert got[1].out[0] != unbiased[0]
    assert got[2].out == unbiased
    assert not tcb._bias.any()  # every row back to zeros


@pytest.mark.parametrize("chunk", [0, 8])
def test_paged_bias_streams_equal_dense(models, chunk):
    """Inside the port the paged layout serves the dense layout's biased
    streams bit for bit, bucketed or chunked."""
    _, _, tcfg, tparams = models
    prompt = _prompt(2, 20, tcfg.vocab_size)
    streams = []
    for layout in ("dense", "paged"):
        cb = tbatch.ContinuousBatcher(
            tparams, tcfg, 2, 64, chunked_prefill=chunk, kv_layout=layout,
            kv_page_size=16 if layout == "paged" else None)
        rids = _three(cb, prompt, 7)
        cb.run()
        streams.append([(cb.done_requests[r].out, cb.done_requests[r].out_logp)
                        for r in rids])
    assert streams[0] == streams[1]
    assert streams[0][0][0] == [FORCED] * 5


def test_bias_validation(models):
    _, _, tcfg, tparams = models
    cb = tbatch.ContinuousBatcher(tparams, tcfg, 1, 32, chunked_prefill=8)
    with pytest.raises(ValueError, match="outside vocab"):
        cb.submit([1, 2], max_new=2, logit_bias={tcfg.vocab_size: 1.0})
    with pytest.raises(ValueError, match="outside \\[-100, 100\\]"):
        cb.submit([1, 2], max_new=2, logit_bias={5: 101.0})
    with pytest.raises(ValueError, match="at most 300"):
        cb.submit([1, 2], max_new=2,
                  logit_bias={i: 1.0 for i in range(301)})
    assert cb.validate_bias([(3, 1.5), (4, -2)]) == ((3, 1.5), (4, -2.0))
    assert cb.validate_bias(None) == () and not cb.pending


def test_zero_bias_row_leaves_the_draws_as_they_are():
    """The graph always adds the bias plane: its zero rows must change
    no token, greedy or sampled, against the call without a bias."""
    gen = torch.Generator().manual_seed(3)
    logits = torch.randn((4, 512), generator=gen)
    knobs = torch.tensor([[0.0, 0, 1.0, 1.0], [0.9, 20, 1.0, 1.0],
                          [1.1, 0, 0.8, 1.2], [0.7, 5, 0.9, 1.0]])
    presence = torch.rand((4, 512), generator=gen) < 0.1
    seeds = torch.tensor([-1, 4, -1, 9], dtype=torch.int32)
    draws = torch.tensor([0, 3, 0, 1], dtype=torch.int32)
    outs = []
    for bias in (None, torch.zeros((4, 512))):
        g = torch.Generator().manual_seed(8)
        outs.append(sample_logits_dyn(logits, knobs, presence, g, bias,
                                      seeds, draws))
    assert torch.equal(outs[0], outs[1])


def _seeded_biased(tparams, tcfg, neighbours):
    cb = tbatch.ContinuousBatcher(tparams, tcfg, 3, 64, chunked_prefill=8,
                                  seed=5)
    rid = cb.submit(list(range(3, 20)), max_new=8, seed=77,
                    sampler=Sampler(temperature=1.0, top_k=40),
                    logit_bias={5: 3.0, 9: -4.0})
    for i, plen in enumerate(neighbours):
        cb.submit(list(range(1, plen + 1)), max_new=10,
                  sampler=Sampler(temperature=0.8), seed=i if i % 2 else None,
                  logit_bias={7: 2.0} if i == 1 else None)
    return cb.run()[rid]


def test_seeded_biased_stream_does_not_depend_on_neighbours(models):
    _, _, tcfg, tparams = models
    alone = _seeded_biased(tparams, tcfg, [])
    assert len(alone) == 8
    assert _seeded_biased(tparams, tcfg, [9, 25, 30]) == alone
