"""The int4 KV cache: the port's packed codes against the reference's
``jnp.int4`` cache.

The reference keeps int4 codes as XLA's native narrow dtype; the port
packs two codes per byte into uint8 (``ops/quant.py`` states the layout).
The pins:

- ``pack_int4``/``unpack_int4`` round-trip every (low, high) pair of
  codes exactly, and widen to the codes JAX's int4 values widen to;
- ``quantize_int4_sym`` gives the reference's codes and scale bits;
- a Llama-3-8B int4 cache row costs 34,816 bytes (``kv_token_bytes``);
- the reference's Pallas kernel in interpret mode over ``jnp.int4``
  codes against the port's plain version on the same codes, packed:
  f32 atol 1e-5 at hd 64, dense and paged (summation order, and the
  scale applied before the product in the kernel and after it in the
  plain version: last bits);
- ``_forward_cached`` from a cache carried across from JAX
  (``kv_cache_from_jax``): logits within 1e-4 in f32 on the same codes;
- the int4 batcher against the reference's int4 batcher: greedy streams
  equal, logprobs within ``INT4_ATOL`` (see there);
- inside the port, the int4 pool gives the int4 dense cache's tokens
  and logprobs bit for bit.

Plain paged against plain dense, ``_quantize_kv`` and ``_cache_write``
at int4 are int4 cases of the int8 tests in
``tests/test_torch_paged_attention.py``; the cache conversion's round
trip is in ``tests/test_torch_quant_kv.py``.
"""

from dataclasses import replace

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from k8s_gpu_device_plugin_tpu.models import batching as jbatch
from k8s_gpu_device_plugin_tpu.models import generate as jgen
from k8s_gpu_device_plugin_tpu.models import llama as jllama
from k8s_gpu_device_plugin_tpu.ops.quant import (
    quantize_int4_sym as jax_quantize_int4_sym,
)
from k8s_gpu_device_plugin_tpu.ops.ragged_paged_attention import (
    ragged_paged_attention as jax_rpa,
)
from k8s_gpu_device_plugin_torch.models import batching as tbatch
from k8s_gpu_device_plugin_torch.models import generate as tgen
from k8s_gpu_device_plugin_torch.models import llama as tllama
from k8s_gpu_device_plugin_torch.models.convert import (
    kv_cache_from_jax,
    params_from_jax,
)
from k8s_gpu_device_plugin_torch.models.paging import kv_token_bytes
from k8s_gpu_device_plugin_torch.models.sampling import Sampler
from k8s_gpu_device_plugin_torch.ops import ragged_paged_attention as rpa
from k8s_gpu_device_plugin_torch.ops.quant import (
    pack_int4,
    quantize_int4_sym,
    unpack_int4,
)

torch.set_num_threads(1)

HD = 64
PS = 16
MAX_LEN = 128
CHUNK = 16
ATOL = 1e-5        # one attention call, f32
LOGITS_ATOL = 1e-4
# The int4 batcher against the reference's: both frameworks quantize the
# K/V rows they computed themselves, and rows that differ in their last
# bits (summation order) could round a value on a boundary to another
# code, a step of 1/7 of its row's largest value. On this workload no
# code of the final caches differs (pinned below, both layouts), the
# streams are equal and the logprobs differed by at most 4.8e-7 when
# measured. So the bound is the unquantized pins' 1e-4: a boundary flip
# would fail here, and is then to be measured and stated.
INT4_ATOL = 1e-4
SPECS = [(5, 9), (16, 6), (40, 12), (70, 7)]  # (prompt length, max_new)


def test_pack_int4_round_trip_is_exact_over_all_codes():
    lo, hi = np.meshgrid(np.arange(-8, 8), np.arange(-8, 8))
    codes = np.stack([lo.ravel(), hi.ravel()], axis=-1).astype(np.int8)
    packed = pack_int4(torch.from_numpy(codes))
    assert packed.dtype == torch.uint8 and packed.shape == (256, 1)
    assert sorted(packed[:, 0].tolist()) == list(range(256))  # a bijection
    np.testing.assert_array_equal(unpack_int4(packed).numpy(), codes)
    # code 2j in the low nibble of byte j, code 2j + 1 in its high one
    assert pack_int4(torch.tensor([[1, -1, -8, 7]], dtype=torch.int8)
                     ).tolist() == [[0xF1, 0x78]]
    # JAX's int4 values widen to the same int8 codes
    jcodes = np.asarray(jnp.asarray(codes.ravel()).astype(jnp.int4))
    np.testing.assert_array_equal(jcodes.astype(np.int8),
                                  unpack_int4(packed).numpy().ravel())
    with pytest.raises(ValueError, match="even"):
        pack_int4(torch.zeros((2, 3), dtype=torch.int8))
    with pytest.raises(ValueError, match="uint8"):
        unpack_int4(torch.zeros((2, 3), dtype=torch.int8))


def test_quantize_int4_sym_gives_the_reference_codes_and_scale_bits():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, HD)).astype(np.float32)
    x[0, 0] = 0.0                              # amax 0: the 1e-8 floor
    x[0, 1] = 0.5 * (np.arange(HD) % 15 - 7)   # amax 7 (below): scale 1,
    x[0, 1, -1] = 7.0                          # so x / scale ties at .5
    for axis in (-1, 0):
        want_q, want_s = jax_quantize_int4_sym(jnp.asarray(x), axis)
        got_q, got_s = quantize_int4_sym(torch.from_numpy(x), axis)
        assert got_q.dtype == torch.int8 and got_s.dtype == torch.float32
        np.testing.assert_array_equal(got_q.numpy(),
                                      np.asarray(want_q).astype(np.int8))
        np.testing.assert_array_equal(got_s.numpy().view(np.uint32),
                                      np.asarray(want_s).view(np.uint32))
    got_q, _ = quantize_int4_sym(torch.from_numpy(x), -1)
    # round half to even: -3.5 -> -4, -2.5 -> -2; clipped at +-7
    assert got_q[0, 1, :4].tolist() == [-4, -3, -2, -2]
    assert int(got_q.abs().max()) == 7


def test_kv_token_bytes_at_llama3_8b():
    """32 layers x 8 kv heads x (K and V) x (64 code bytes + a 4-byte
    scale): the figure both layouts' ``reserved_bytes`` rest on."""
    for quant, want in (("none", 131072), ("int8", 67584), ("int4", 34816)):
        cfg = tllama.LlamaConfig.llama3_8b()
        assert kv_token_bytes(replace(cfg, cache_quant=quant)) == want


def _int4_cache(rng, shape):
    """int4 codes (an ml_dtypes array: ``jnp.int4`` in JAX) and f32
    scale planes for k and for v."""
    k, v = (rng.integers(-8, 8, shape).astype(ml_dtypes.int4)
            for _ in range(2))
    ks, vs = (rng.uniform(0.02, 0.3, (*shape[:-1], 1)).astype(np.float32)
              for _ in range(2))
    return k, v, ks, vs


def _packed(codes):
    return pack_int4(torch.from_numpy(codes.astype(np.int8)))


@pytest.mark.parametrize("layout", ["dense", "paged"])
@pytest.mark.parametrize("window", [0, 8])
@pytest.mark.parametrize("t", [1, 5, 16])
def test_jax_int4_kernel_matches_plain_version(t, window, layout):
    n_slot_pages = MAX_LEN // PS
    bases = [-1, 0, MAX_LEN - t - 3]   # empty, fresh, deep in its cache
    b, hq, hkv = len(bases), 8, 2
    rng = np.random.default_rng(10 * t + window)
    q = rng.standard_normal((b, t, hq, HD)).astype(np.float32)
    if layout == "paged":
        n_pages = 1 + b * n_slot_pages
        table = rng.permutation(np.arange(1, n_pages)).astype(np.int32)
        table = table.reshape(b, n_slot_pages)
        shape = (n_pages, PS, hkv, HD)
    else:
        table, shape = None, (b, MAX_LEN, hkv, HD)
    k, v, ks, vs = _int4_cache(rng, shape)
    base = np.asarray(bases, np.int32)
    opt = {} if table is None else {"pages": jnp.asarray(table)}
    want = jax_rpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                   jnp.asarray(base), scale=HD ** -0.5, window=window,
                   block_k=32, interpret=True, k_scale=jnp.asarray(ks),
                   v_scale=jnp.asarray(vs), **opt)
    got = rpa.ragged_paged_attention(
        torch.from_numpy(q), _packed(k), _packed(v), torch.from_numpy(base),
        None if table is None else torch.from_numpy(table),
        scale=HD ** -0.5, window=window, k_scale=torch.from_numpy(ks),
        v_scale=torch.from_numpy(vs))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)


def _configs(layout, quant="int4"):
    kw = dict(head_dim_override=HD, cache_quant=quant, kv_layout=layout,
              kv_page_size=PS)
    return (jllama.LlamaConfig.tiny(dtype=jnp.float32, **kw),
            tllama.LlamaConfig.tiny(dtype=torch.float32, **kw))


@pytest.fixture(scope="module")
def weights():
    jcfg, tcfg = _configs("dense")
    jparams = jllama.init_params(jax.random.key(0), jcfg)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                              device="cpu")
    return jparams, tparams


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_forward_cached_from_a_carried_int4_cache(weights, layout):
    """JAX fills an int4 cache with two prefill chunks; the port starts
    from it (``kv_cache_from_jax``), then both frameworks run a decode
    step and a 5-token chunk from their own copies."""
    jparams, tparams = weights
    jcfg, tcfg = _configs(layout)
    rng = np.random.default_rng(3)
    if layout == "paged":
        table = np.asarray([[3, 7, 2, 0], [5, 1, 8, 4]], np.int32)
        jcache = jgen.KVCache.init_paged(jcfg, 9, PS)
        jkw, tkw = dict(pages=jnp.asarray(table)), \
            dict(pages=torch.from_numpy(table))
    else:
        jcache = jgen.KVCache.init(jcfg, 2, 64)
        jkw, tkw = {}, {}
    for length in (0, CHUNK):
        tokens = rng.integers(1, jcfg.vocab_size, (2, CHUNK))
        _, jcache = jgen._forward_cached(
            jparams, jnp.asarray(tokens, jnp.int32), jcache,
            jnp.int32(length), jcfg, **jkw)
    leaves = {name: np.asarray(getattr(jcache, name))
              for name in ("k", "v", "k_scale", "v_scale")}
    tcache = kv_cache_from_jax(leaves, tcfg, device="cpu")
    assert tcache.k.dtype == torch.uint8
    assert tcache.k.shape[-1] == HD // 2
    for t, length in ((1, 2 * CHUNK), (5, 2 * CHUNK + 1)):
        tokens = rng.integers(1, jcfg.vocab_size, (2, t))
        want, jcache = jgen._forward_cached(
            jparams, jnp.asarray(tokens, jnp.int32), jcache,
            jnp.int32(length), jcfg, **jkw)
        got = tgen._forward_cached(tparams, torch.from_numpy(tokens), tcache,
                                   length, tcfg, **tkw)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=LOGITS_ATOL, rtol=0)
    live = slice(1, None) if layout == "paged" else slice(None)
    np.testing.assert_array_equal(
        unpack_int4(tcache.k).numpy()[:, live],
        np.asarray(jcache.k).astype(np.int8)[:, live])


def _prompts(vocab):
    rng = np.random.default_rng(11)
    return [rng.integers(1, vocab, n).tolist() for n, _ in SPECS]


def _run(tparams, tcfg, seeded):
    # the synchronous loop, as the reference's batcher runs below: the
    # final caches are compared whole, and the rows inactive slots write
    # (the last row of a dense slot) hold whatever the last step's
    # schedule left there
    cb = tbatch.ContinuousBatcher(tparams, tcfg, n_slots=2, max_len=MAX_LEN,
                                  chunked_prefill=CHUNK, seed=3,
                                  pipeline_depth=0)
    sampler = Sampler(temperature=0.9, top_k=50) if seeded else None
    rids = [cb.submit(p, max_new=n, sampler=sampler,
                      seed=100 + i if seeded else None)
            for i, (p, (_, n)) in enumerate(zip(_prompts(tcfg.vocab_size),
                                                SPECS))]
    cb.run()
    return cb, [cb.done_requests[r] for r in rids]


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_int4_batcher_matches_reference_int4_batcher(weights, layout):
    jparams, tparams = weights
    jcfg, tcfg = _configs(layout)
    jcb = jbatch.ContinuousBatcher(jparams, jcfg, n_slots=2, max_len=MAX_LEN,
                                   chunked_prefill=CHUNK, pipeline_depth=0)
    jr = [jcb.submit(p, max_new=n)
          for p, (_, n) in zip(_prompts(jcfg.vocab_size), SPECS)]
    jcb.run()
    cb, got = _run(tparams, tcfg, seeded=False)
    for rid, mine in zip(jr, got):
        want = jcb.done_requests[rid]
        assert mine.out == want.out
        np.testing.assert_allclose(mine.out_logp, want.out_logp,
                                   atol=INT4_ATOL, rtol=0)
    # no boundary flip on this workload: the final caches hold the same
    # codes (all but the trap page of a pool)
    live = slice(1, None) if layout == "paged" else slice(None)
    for leaf in ("k", "v"):
        np.testing.assert_array_equal(
            unpack_int4(getattr(cb.state.cache, leaf)).numpy()[:, live],
            np.asarray(getattr(jcb.state.cache, leaf)).astype(np.int8)[:, live])


@pytest.mark.parametrize("seeded", [False, True])
def test_int4_paged_equals_int4_dense_bitwise(weights, seeded):
    _, tparams = weights
    dense_cb, dense = _run(tparams, _configs("dense")[1], seeded)
    paged_cb, paged = _run(tparams, _configs("paged")[1], seeded)
    assert dense_cb.state.cache.k.dtype == torch.uint8
    assert paged_cb.state.cache.k.shape == (
        2, 2 * (MAX_LEN // PS) + 1, PS, 4, HD // 2)
    for got, want, (_, n) in zip(paged, dense, SPECS):
        assert len(got.out) == n
        assert got.out == want.out
        assert got.out_logp == want.out_logp
    paged_cb.pool.check()
    assert paged_cb.pool.in_use == 0
    # int4 codes change the numbers: not the int8 cache's bits
    _, int8 = _run(tparams, _configs("paged", quant="int8")[1], seeded)
    assert any(a.out_logp != b.out_logp for a, b in zip(paged, int8))
    # half an int8 cache's code bytes, the same scale bytes
    assert dense_cb.kv_stats()["reserved_bytes"] == (
        2 * MAX_LEN * 2 * 2 * 4 * (HD // 2 + 4))
