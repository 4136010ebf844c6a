"""Bucketed prefill-then-insert (``chunked_prefill=0``, the batcher's
default) in the port against the reference's.

A prompt is padded to its bucket P, run through a fresh single-row
scratch cache of capacity P from position 0 (the attention kernel's
chunk route at T = P, base 0), its last real position projected, and the
P rows inserted into the slot: copied on the dense layout, scattered
through the slot's page table on the paged one, codes and scales alike.
Pins, on a tiny f32 model with the JAX weights converted and prompts
inside the 32 and 64 buckets (as the reference's ``tests/test_batching.py``
pins its batcher against dedicated generation):

- four requests on two slots (slot reuse; one greedy request under a
  repetition penalty, which must count the real prompt and not its
  padding): greedy streams equal to the JAX batcher's at
  ``chunked_prefill=0``, logprobs within atol 1e-4 (f32 summation order;
  5e-4 on the int8 cache, ROADMAP C), on the dense and paged layouts and
  on an int8 cache;
- inside the port: paged equal to dense bit for bit on every cache type,
  and the same greedy tokens as chunked prefill;
- the bucket ladder and its admission rule: the smallest bucket that
  holds the prompt, a prompt past the largest bucket refused at submit,
  no bucket under max_len refused at construction.
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

torch.set_num_threads(1)

BUCKETS = (32, 64)
SPECS = [(5, 9), (40, 6), (16, 12), (60, 7)]  # (prompt length, max_new)
PENALIZED = 2  # this request decodes greedily under repetition_penalty 1.5


def _models(cache_quant):
    jcfg = jllama.LlamaConfig.tiny(dtype=jnp.float32, head_dim_override=64,
                                   cache_quant=cache_quant)
    tcfg = tllama.LlamaConfig.tiny(dtype=torch.float32, head_dim_override=64,
                                   cache_quant=cache_quant)
    jparams = jllama.init_params(jax.random.key(0), jcfg)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                              device="cpu")
    return jcfg, jparams, tcfg, tparams


@pytest.fixture(scope="module")
def models():
    return _models("none")


def _prompts(vocab):
    rng = np.random.default_rng(17)
    return [rng.integers(1, vocab, n).tolist() for n, _ in SPECS]


def _serve(cb, prompts):
    rids = [cb.submit(p, max_new=n,
                      sampler=(Sampler(repetition_penalty=1.5)
                               if i == PENALIZED else None))
            for i, (p, (_, n)) in enumerate(zip(prompts, SPECS))]
    cb.run()
    return [cb.done_requests[r] for r in rids]


def _kw(layout):
    return dict(n_slots=2, max_len=128, prompt_buckets=BUCKETS,
                kv_layout=layout,
                kv_page_size=16 if layout == "paged" else None)


@pytest.mark.parametrize("layout,quant", [("dense", "none"),
                                          ("paged", "none"),
                                          ("dense", "int8")])
def test_bucketed_streams_match_reference(models, layout, quant):
    jcfg, jparams, tcfg, tparams = models if quant == "none" \
        else _models(quant)
    prompts = _prompts(jcfg.vocab_size)
    want = _serve(jbatch.ContinuousBatcher(jparams, jcfg, chunked_prefill=0,
                                           pipeline_depth=0, **_kw(layout)),
                  prompts)
    cb = tbatch.ContinuousBatcher(tparams, tcfg, **_kw(layout))
    assert cb.chunk == 0 and cb.buckets == BUCKETS
    got = _serve(cb, prompts)
    atol = 5e-4 if quant == "int8" else 1e-4
    for w, g, (_, n) in zip(want, got, SPECS):
        assert len(g.out) == n
        assert g.out == w.out
        np.testing.assert_allclose(g.out_logp, w.out_logp, atol=atol, rtol=0)
    assert cb.prefill_chunks == len(SPECS)  # one prefill dispatch each
    if layout == "paged":
        cb.pool.check()
        assert cb.pool.in_use == 0


@pytest.mark.parametrize("quant", ["none", "int8", "int4"])
def test_bucketed_paged_equals_dense_bitwise(quant):
    tcfg = tllama.LlamaConfig.tiny(dtype=torch.float32, head_dim_override=64,
                                   cache_quant=quant)
    tparams = tllama.init_params(tcfg, seed=2, device="cpu")
    prompts = _prompts(tcfg.vocab_size)
    streams = []
    for layout in ("dense", "paged"):
        cb = tbatch.ContinuousBatcher(tparams, tcfg, **_kw(layout))
        streams.append([(r.out, r.out_logp) for r in _serve(cb, prompts)])
    assert streams[0] == streams[1]


def test_bucketed_tokens_equal_chunked(models):
    _, _, tcfg, tparams = models
    prompts = _prompts(tcfg.vocab_size)
    runs = []
    for chunk in (0, 16):
        cb = tbatch.ContinuousBatcher(tparams, tcfg, chunked_prefill=chunk,
                                      **_kw("dense"))
        runs.append(_serve(cb, prompts))
    for a, b in zip(*runs):
        assert a.out == b.out
        np.testing.assert_allclose(a.out_logp, b.out_logp, atol=1e-5, rtol=0)


def test_bucket_selection():
    assert tbatch._bucket(5, (8, 16)) == 8
    assert tbatch._bucket(8, (8, 16)) == 8
    assert tbatch._bucket(9, (8, 16)) == 16
    with pytest.raises(ValueError, match="largest bucket 16"):
        tbatch._bucket(17, (8, 16))


def test_bucket_admission_rule(models):
    _, _, tcfg, tparams = models
    cb = tbatch.ContinuousBatcher(tparams, tcfg, 1, 64, prompt_buckets=(8,))
    with pytest.raises(ValueError, match="largest bucket"):
        cb.submit(list(range(1, 11)), max_new=4)  # 10 > the bucket of 8
    with pytest.raises(tbatch.RequestTooLargeError):
        tbatch.ContinuousBatcher(tparams, tcfg, 1, 16,
                                 prompt_buckets=(8, 16)).submit(
            list(range(1, 13)), max_new=8)       # 12 + 8 > 16
    with pytest.raises(ValueError, match="no prompt bucket"):
        tbatch.ContinuousBatcher(tparams, tcfg, 1, 4, prompt_buckets=(8,))
    assert not cb.pending
    # the same prompt is served chunked, where no bucket applies
    chunked = tbatch.ContinuousBatcher(tparams, tcfg, 1, 64,
                                       prompt_buckets=(8,), chunked_prefill=4)
    rid = chunked.submit(list(range(1, 11)), 4)
    assert len(chunked.run()[rid]) == 4
