"""The int8 KV cache: dense against paged inside the port, the port
against the reference's int8 batcher, and the cache conversion.

A tiny f32 model (hd 64, page size 16, max_len 128, chunked prefill 16)
whose cache holds int8 codes and f32 scales.

- Inside the port, the int8 pool gives the int8 dense cache's tokens and
  logprobs bit for bit, greedy and seeded: both layouts quantize before
  they write, so they hold the same codes and scales.
- Against the reference: ``_forward_cached`` logits within atol 5e-4.
  That is looser than the 1e-4 of the unquantized pins for a reason: the
  two frameworks' K/V rows differ in their last bits (summation order),
  and a value that sits on a rounding boundary then takes another code,
  which moves that cache entry by a whole quantization step (1/127 of
  its row's largest value) where summation order alone moves it by
  ~1e-7. Measured on these inputs: at most 2 codes of 390,000 differ and
  the logits by 2.8e-5 (logits' std 0.22). Greedy streams are equal on
  this workload (a top-two logit gap narrower than that difference could
  flip a token; none of these is); logprobs within the same 5e-4.
- ``kv_cache_from_jax`` carries all six cache kinds (dense or paged,
  bf16, int8 or int4) across with the same bytes (int4: the same codes,
  packed two per byte).
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from k8s_gpu_device_plugin_tpu.models import batching as jbatch
from k8s_gpu_device_plugin_tpu.models import generate as jgen
from k8s_gpu_device_plugin_tpu.models import llama as jllama
from k8s_gpu_device_plugin_torch.models import batching as tbatch
from k8s_gpu_device_plugin_torch.models import generate as tgen
from k8s_gpu_device_plugin_torch.models import llama as tllama
from k8s_gpu_device_plugin_torch.models.convert import (
    kv_cache_from_jax,
    params_from_jax,
)
from k8s_gpu_device_plugin_torch.models.sampling import Sampler
from k8s_gpu_device_plugin_torch.ops.quant import unpack_int4

torch.set_num_threads(1)

PS = 16
MAX_LEN = 128
CHUNK = 16
INT8_ATOL = 5e-4
SPECS = [(5, 9), (16, 6), (40, 12), (70, 7)]  # (prompt length, max_new)


def _configs(layout, quant="int8", dtype="float32"):
    kw = dict(head_dim_override=64, cache_quant=quant, kv_layout=layout,
              kv_page_size=PS)
    return (jllama.LlamaConfig.tiny(dtype=getattr(jnp, dtype), **kw),
            tllama.LlamaConfig.tiny(dtype=getattr(torch, dtype), **kw))


@pytest.fixture(scope="module")
def weights():
    jcfg, tcfg = _configs("dense")
    jparams = jllama.init_params(jax.random.key(0), jcfg)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                              device="cpu")
    return jparams, tparams


def _prompts(vocab):
    rng = np.random.default_rng(11)
    return [rng.integers(1, vocab, n).tolist() for n, _ in SPECS]


def _run(tparams, tcfg, seeded):
    cb = tbatch.ContinuousBatcher(tparams, tcfg, n_slots=2, max_len=MAX_LEN,
                                  chunked_prefill=CHUNK, seed=3)
    sampler = Sampler(temperature=0.9, top_k=50) if seeded else None
    rids = [cb.submit(p, max_new=n, sampler=sampler,
                      seed=100 + i if seeded else None)
            for i, (p, (_, n)) in enumerate(zip(_prompts(tcfg.vocab_size),
                                                SPECS))]
    cb.run()
    return cb, [cb.done_requests[r] for r in rids]


@pytest.mark.parametrize("seeded", [False, True])
def test_int8_paged_equals_int8_dense_bitwise(weights, seeded):
    _, tparams = weights
    dense_cb, dense = _run(tparams, _configs("dense")[1], seeded)
    paged_cb, paged = _run(tparams, _configs("paged")[1], seeded)
    assert dense_cb.state.cache.k.dtype == torch.int8
    assert paged_cb.state.cache.k_scale.shape == (
        2, 2 * (MAX_LEN // PS) + 1, PS, 4, 1)
    for got, want, (_, n) in zip(paged, dense, SPECS):
        assert len(got.out) == n
        assert got.out == want.out
        assert got.out_logp == want.out_logp
    paged_cb.pool.check()
    assert paged_cb.pool.in_use == 0
    # the int8 cache changes the numbers: not the unquantized streams' bits
    _, plain = _run(tparams, _configs("paged", quant="none")[1], seeded)
    assert any(a.out_logp != b.out_logp for a, b in zip(paged, plain))
    ratio = dense_cb.kv_stats()["reserved_bytes"] / (
        2 * MAX_LEN * 2 * 2 * 4 * 64 * 4)  # the f32 cache's bytes
    assert ratio == (64 + 4) / (64 * 4)


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_int8_batcher_matches_reference_int8_batcher(weights, layout):
    jparams, tparams = weights
    jcfg, tcfg = _configs(layout)
    jcb = jbatch.ContinuousBatcher(jparams, jcfg, n_slots=2, max_len=MAX_LEN,
                                   chunked_prefill=CHUNK, pipeline_depth=0)
    jr = [jcb.submit(p, max_new=n)
          for p, (_, n) in zip(_prompts(jcfg.vocab_size), SPECS)]
    jcb.run()
    _, got = _run(tparams, tcfg, seeded=False)
    for rid, mine in zip(jr, got):
        want = jcb.done_requests[rid]
        assert mine.out == want.out
        np.testing.assert_allclose(mine.out_logp, want.out_logp,
                                   atol=INT8_ATOL, rtol=0)


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_int8_forward_cached_logits_within_the_stated_bound(weights, layout):
    jparams, tparams = weights
    jcfg, tcfg = _configs(layout)
    rng = np.random.default_rng(2)
    if layout == "paged":
        table = np.asarray([[3, 7, 2, 0], [5, 1, 8, 4]], np.int32)
        jcache = jgen.KVCache.init_paged(jcfg, 9, PS)
        tcache = tgen.KVCache.init_paged(tcfg, 9, PS, "cpu")
        jkw, tkw = dict(pages=jnp.asarray(table)), \
            dict(pages=torch.from_numpy(table))
    else:
        jcache = jgen.KVCache.init(jcfg, 2, 64)
        tcache = tgen.KVCache.init(tcfg, 2, 64, "cpu")
        jkw, tkw = {}, {}
    for t, length in ((CHUNK, 0), (CHUNK, CHUNK), (1, 32), (1, 33)):
        tokens = rng.integers(1, jcfg.vocab_size, (2, t))
        want, jcache = jgen._forward_cached(
            jparams, jnp.asarray(tokens, jnp.int32), jcache,
            jnp.int32(length), jcfg, **jkw)
        got = tgen._forward_cached(tparams, torch.from_numpy(tokens), tcache,
                                   length, tcfg, **tkw)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=INT8_ATOL, rtol=0)
    live = slice(1, None) if layout == "paged" else slice(None)
    differ = (tcache.k.numpy()[:, live] != np.asarray(jcache.k)[:, live])
    assert differ.mean() < 1e-4  # a handful of boundary codes at most


@pytest.mark.parametrize("layout", ["dense", "paged"])
@pytest.mark.parametrize("quant,dtype", [("none", "bfloat16"),
                                         ("int8", "bfloat16"),
                                         ("int4", "bfloat16")])
def test_kv_cache_from_jax_round_trip(layout, quant, dtype):
    jcfg, tcfg = _configs(layout, quant, dtype)
    rng = np.random.default_rng(4)
    jcache = (jgen.KVCache.init_paged(jcfg, 5, PS) if layout == "paged"
              else jgen.KVCache.init(jcfg, 2, 32))
    leaves = {}
    for name in ("k", "v", "k_scale", "v_scale"):
        leaf = getattr(jcache, name)
        if leaf is None:
            continue
        if leaf.dtype == jnp.int8:
            filled = rng.integers(-127, 128, leaf.shape).astype(np.int8)
        elif leaf.dtype == jnp.int4:
            filled = rng.integers(-8, 8, leaf.shape).astype(ml_dtypes.int4)
        else:
            filled = np.asarray(jnp.asarray(
                rng.standard_normal(leaf.shape), leaf.dtype))
        leaves[name] = filled
    cache = kv_cache_from_jax(leaves, tcfg, device="cpu")
    assert (cache.k_scale is None) == (quant == "none")
    for name, want in leaves.items():
        got = getattr(cache, name)
        if want.dtype.name == "int4":  # packed: hd / 2 bytes a row
            assert got.dtype == torch.uint8
            assert tuple(got.shape) == (*want.shape[:-1], want.shape[-1] // 2)
            np.testing.assert_array_equal(unpack_int4(got).numpy(),
                                          want.astype(np.int8))
            continue
        assert tuple(got.shape) == want.shape
        if want.dtype.name == "bfloat16":
            assert got.dtype == torch.bfloat16
            np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                          want.view(np.int16))
        else:
            np.testing.assert_array_equal(got.numpy(), want)
    # and the port serves from it: one decode step reads the carried rows
    params = tllama.init_params(tcfg, seed=0, device="cpu")
    pages = (torch.tensor([[1, 2], [3, 4]], dtype=torch.int32)
             if layout == "paged" else None)
    logits = tgen._forward_cached(
        params, torch.tensor([[5], [9]]), cache,
        torch.tensor([20, 31], dtype=torch.int32), tcfg, pages=pages)
    assert torch.isfinite(logits).all()
    with pytest.raises(ValueError, match="scale planes"):
        kv_cache_from_jax({"k": leaves["k"], "v": leaves["v"],
                           "k_scale": leaves.get("k_scale")},
                          _configs(layout, "int8" if quant == "none"
                                   else "none", dtype)[1], device="cpu")
