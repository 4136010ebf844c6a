"""The paged, int8 and int4 routes of ragged-paged attention against the
JAX reference, and the cache write that feeds them.

``quantized`` names the cache: False (f32), True (int8 codes) or
``"int4"`` (``jnp.int4`` codes in the reference, packed two per byte into
uint8 in the port: ``ops/quant.py``). The reference's Pallas kernel runs
in interpret mode with ``pages=`` (and ``k_scale``/``v_scale`` for codes),
its XLA gather
(``generate._cached_attention``) runs as is; both are held against the
port's plain version, which is what the port's wrapper runs for CPU
tensors. Tolerance: atol 1e-5 in f32 at hd 64. The kernel's online
softmax and the plain softmax differ in summation order; on codes the
kernel also multiplies the scale in before the product where the plain
version applies it after, which moves the last bits only.

Exact pins: the plain version on a pool equals the plain version on the
gathered dense view bit for bit; ``_quantize_kv`` gives the reference's
codes and scale bits from the same f32 input; ``_cache_write`` leaves
the reference's codes (int4: unpacked) and bytes in a dense cache and in
every page of a pool but the trap page (where several rows of one call
may land on one row, and which of them stays is not defined in either
framework).

The CUDA kernel itself needs the card: ``chip_smoke.py`` and
``tests/test_torch_kernel_card.py`` hold it against the same plain
version there.
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from k8s_gpu_device_plugin_tpu.models import generate as jgen
from k8s_gpu_device_plugin_tpu.models import llama as jllama
from k8s_gpu_device_plugin_tpu.ops.ragged_paged_attention import (
    ragged_paged_attention as jax_rpa,
)
from k8s_gpu_device_plugin_torch.models import generate as tgen
from k8s_gpu_device_plugin_torch.ops import kernel_support
from k8s_gpu_device_plugin_torch.ops import ragged_paged_attention as rpa
from k8s_gpu_device_plugin_torch.ops.attention import (
    attention_backend_plan,
    serving_cache_attention,
)
from k8s_gpu_device_plugin_torch.ops.quant import pack_int4, unpack_int4

torch.set_num_threads(1)

HD = 64
PS = 16
N_SLOT_PAGES = 8            # virtual extent 128 rows per slot
S = PS * N_SLOT_PAGES
ATOL = 1e-5


def _pool(seed, t, hq, hkv, bases, quantized):
    """A shuffled pool: each slot reserves the pages its live rows need
    (at least one), the rest of its table row is 0. Every page, the trap
    page included, holds finite random rows."""
    rng = np.random.default_rng(seed)
    b = len(bases)
    n_pages = 1 + b * N_SLOT_PAGES
    ids = rng.permutation(np.arange(1, n_pages))
    table = np.zeros((b, N_SLOT_PAGES), np.int32)
    taken = 0
    for i, base in enumerate(bases):
        n = max(1, -(-(base + t) // PS))
        table[i, :n] = ids[taken:taken + n]
        taken += n
    q = rng.standard_normal((b, t, hq, HD)).astype(np.float32)
    shape = (n_pages, PS, hkv, HD)
    if not quantized:
        k = rng.standard_normal(shape).astype(np.float32)
        v = rng.standard_normal(shape).astype(np.float32)
        return q, k, v, None, None, table
    if quantized == "int4":  # an ml_dtypes int4 array: jnp.int4 in JAX
        k = rng.integers(-8, 8, shape).astype(ml_dtypes.int4)
        v = rng.integers(-8, 8, shape).astype(ml_dtypes.int4)
    else:
        k = rng.integers(-127, 128, shape).astype(np.int8)
        v = rng.integers(-127, 128, shape).astype(np.int8)
    ks = rng.uniform(0.002, 0.02, shape[:-1] + (1,)).astype(np.float32)
    vs = rng.uniform(0.002, 0.02, shape[:-1] + (1,)).astype(np.float32)
    return q, k, v, ks, vs, table


def _t(x):
    """numpy -> torch; int4 codes become the port's packed uint8."""
    if x is None:
        return None
    if x.dtype == ml_dtypes.int4:
        return pack_int4(torch.from_numpy(x.astype(np.int8)))
    return torch.from_numpy(x)


def _plain(q, k, v, ks, vs, table, base, window=0):
    return rpa.ragged_paged_attention_reference(
        _t(q), _t(k), _t(v), _t(base), _t(table), scale=HD ** -0.5,
        window=window, k_scale=_t(ks), v_scale=_t(vs),
    ).numpy()


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("t", [1, 8, 64])
@pytest.mark.parametrize("window", [0, 16])
def test_jax_paged_kernel_matches_plain_version(t, window, quantized):
    # an empty slot (-1), a fresh one (0) and one deep in its cache
    bases = [-1, 0, S - t - 3]
    q, k, v, ks, vs, table = _pool(t + window, t, 8, 2, bases, quantized)
    base = np.asarray(bases, np.int32)
    scales = {} if not quantized else dict(k_scale=jnp.asarray(ks),
                                           v_scale=jnp.asarray(vs))
    want = jax_rpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                   jnp.asarray(base), jnp.asarray(table), scale=HD ** -0.5,
                   window=window, interpret=True, **scales)
    np.testing.assert_allclose(_plain(q, k, v, ks, vs, table, base, window),
                               np.asarray(want), atol=ATOL, rtol=0)


@pytest.mark.parametrize("quantized", [False, True, "int4"])
@pytest.mark.parametrize("t", [1, 8])
@pytest.mark.parametrize("window", [0, 16])
def test_jax_paged_gather_matches_plain_version(t, window, quantized):
    """The reference's own gather branch (no clamp) on live slots."""
    cfg = jllama.LlamaConfig.tiny(
        dtype=jnp.float32, n_heads=8, n_kv_heads=2, head_dim_override=HD,
        sliding_window=window, kv_layout="paged", kv_page_size=PS,
        cache_quant={False: "none", True: "int8"}.get(quantized, quantized),
    )
    bases = [0, 57]
    q, k, v, ks, vs, table = _pool(7 + t, t, 8, 2, bases, quantized)
    base = np.asarray(bases, np.int32)
    want = jgen._cached_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        None if ks is None else jnp.asarray(ks),
        None if vs is None else jnp.asarray(vs),
        jnp.asarray(base), cfg, pages=jnp.asarray(table),
    )
    np.testing.assert_allclose(_plain(q, k, v, ks, vs, table, base, window),
                               np.asarray(want), atol=ATOL, rtol=0)


@pytest.mark.parametrize("quantized", [False, True, "int4"])
@pytest.mark.parametrize("t,window", [(1, 0), (8, 16), (64, 0)])
def test_plain_paged_equals_plain_dense_bitwise(t, window, quantized):
    bases = [-1, 0, S - t - 3]
    q, k, v, ks, vs, table = _pool(3 + t, t, 8, 2, bases, quantized)
    base = np.asarray(bases, np.int32)

    def gathered(pool):
        return None if pool is None else \
            pool[table].reshape(len(bases), S, *pool.shape[-2:])

    dense = rpa.ragged_paged_attention_reference(
        _t(q), _t(gathered(k)), _t(gathered(v)), _t(base), scale=HD ** -0.5,
        window=window, k_scale=_t(gathered(ks)), v_scale=_t(gathered(vs)),
    ).numpy()
    paged = _plain(q, k, v, ks, vs, table, base, window)
    np.testing.assert_array_equal(paged, dense)
    # the CPU wrapper takes the same plain version and counts no launch
    kernel_support.reset_launch_counts()
    got = serving_cache_attention(_t(q), _t(k), _t(v), _t(base), _t(table),
                                  window=window, k_scale=_t(ks),
                                  v_scale=_t(vs)).numpy()
    np.testing.assert_array_equal(got, paged)
    assert kernel_support.launch_counts() == {}


def _kv_rows(seed, b, t, hkv):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, t, hkv, HD)).astype(np.float32)
    x[0, 0, 0] = 0.0                       # amax 0: the 1e-8 floor
    x[0, 1, 0] = np.arange(HD) - 31.5      # exact .5 ties after scaling
    x[0, 1, 0, -1] = 127.0
    return x


def test_quantize_kv_gives_the_reference_codes_and_scale_bits():
    x = _kv_rows(0, 2, 5, 2)
    for jdtype, width, qmax in ((jnp.int8, "int8", 127),
                                (jnp.int4, "int4", 7)):
        want_q, want_s = jgen._quantize_kv(jnp.asarray(x), jdtype)
        got_q, got_s = tgen._quantize_kv(torch.from_numpy(x), width)
        assert got_q.dtype == torch.int8 and got_s.dtype == torch.float32
        np.testing.assert_array_equal(got_q.numpy(),
                                      np.asarray(want_q).astype(np.int8))
        np.testing.assert_array_equal(got_s.numpy().view(np.uint32),
                                      np.asarray(want_s).view(np.uint32))
        assert got_s.shape == (2, 5, 2, 1)
        assert int(got_q.max()) == qmax and int(got_q.min()) >= -qmax
    got_q, _ = tgen._quantize_kv(torch.from_numpy(x))
    # int8 (the default width): round half to even, clipped at +-127
    assert got_q[0, 1, 0, :4].tolist() == [-32, -30, -30, -28]


WRITE_T = 4
# slot 0 decodes deep in its reservation, slot 1 writes across the end of
# its reservation (rows past it go to the trap page), slot 2 is inactive:
# an all-zero table row, parked at the virtual last row
WRITE_LENGTHS = [37, 30, S - 1]
WRITE_PAGES = [[5, 2, 7, 0, 0, 0, 0, 0], [4, 9, 0, 0, 0, 0, 0, 0],
               [0, 0, 0, 0, 0, 0, 0, 0]]


def _filled(shape, dtype, seed):
    rng = np.random.default_rng(seed)
    if dtype == np.int8:
        return rng.integers(-100, 100, shape).astype(np.int8)
    if dtype == ml_dtypes.int4:
        return rng.integers(-8, 8, shape).astype(ml_dtypes.int4)
    return rng.standard_normal(shape).astype(np.float32)


def _codes(x):
    """A cache's values as numpy: packed int4 unpacked to int8 codes."""
    if isinstance(x, torch.Tensor):
        return (unpack_int4(x) if x.dtype == torch.uint8 else x).numpy()
    x = np.asarray(x)
    return x.astype(np.int8) if x.dtype == ml_dtypes.int4 else x


@pytest.mark.parametrize("layout", ["dense", "paged"])
@pytest.mark.parametrize("quantized", [False, True, "int4"])
@pytest.mark.parametrize("vector_length", [True, False])
def test_cache_write_leaves_the_reference_bytes(layout, quantized,
                                                vector_length):
    b, hkv = 3, 2
    x = _kv_rows(1, b, WRITE_T, hkv)
    paged = layout == "paged"
    shape = (10, PS, hkv, HD) if paged else (b, S, hkv, HD)
    cache_dtype = {False: np.float32, True: np.int8}.get(quantized,
                                                         ml_dtypes.int4)
    cache = _filled(shape, cache_dtype, 2)
    scale = _filled(shape[:-1] + (1,), np.float32, 3) if quantized else None
    pages = np.asarray(WRITE_PAGES, np.int32) if paged else None
    if vector_length:
        lengths = WRITE_LENGTHS if paged else [37, 30, S - WRITE_T]
        jlen, tlen = jnp.asarray(lengths, jnp.int32), \
            torch.tensor(lengths, dtype=torch.int32)
    else:
        jlen, tlen = 30, 30
    want_c, want_s = jgen._cache_write(
        jnp.asarray(cache), None if scale is None else jnp.asarray(scale),
        jnp.asarray(x), jlen, None if pages is None else jnp.asarray(pages),
        PS if paged else 0,
    )
    got_c = _t(cache.copy())
    got_s = None if scale is None else torch.from_numpy(scale.copy())
    tgen._cache_write(got_c, got_s, torch.from_numpy(x), tlen, _t(pages))
    live = slice(1, None) if paged else slice(None)  # all but the trap page
    np.testing.assert_array_equal(_codes(got_c)[live], _codes(want_c)[live])
    if quantized:
        np.testing.assert_array_equal(
            got_s.numpy()[live].view(np.uint32),
            np.asarray(want_s)[live].view(np.uint32))
    if paged:
        # no live page is written outside its own slot's rows: only the
        # (page, offset) pairs of in-reservation positions changed
        changed = np.argwhere(
            (_codes(got_c) != _codes(cache)).any(axis=(-1, -2)))
        wrote = set()
        for s_, start in enumerate(lengths if vector_length else [30] * b):
            for p in range(start, start + WRITE_T):
                p = min(p, S - 1)
                wrote.add((WRITE_PAGES[s_][p // PS], p % PS))
        assert {tuple(r) for r in changed if r[0] != 0} == \
            {w for w in wrote if w[0] != 0}


def test_wrapper_refusals_on_the_new_routes():
    q, k, v, ks, vs, table = _pool(0, 1, 8, 2, [5, 9], True)
    q, k, v, ks, vs, table = map(_t, (q, k, v, ks, vs, table))
    base = torch.tensor([5, 9], dtype=torch.int32)
    call = rpa.ragged_paged_attention
    with pytest.raises(ValueError, match="together"):
        call(q, k, v, base, table, scale=1.0, k_scale=ks)
    with pytest.raises(ValueError, match="int8 cache needs"):
        call(q, k, v, base, table, scale=1.0)
    with pytest.raises(ValueError, match="int8 codes"):
        call(q, k.float(), v.float(), base, table, scale=1.0, k_scale=ks,
             v_scale=vs)
    with pytest.raises(ValueError, match="k_scale must be f32"):
        call(q, k, v, base, table, scale=1.0, k_scale=ks[..., 0], v_scale=vs)
    # uint8 is packed int4: rows of hd / 2 bytes, with scales
    with pytest.raises(ValueError, match="does not match"):
        call(q, k.view(torch.uint8), v.view(torch.uint8), base, table,
             scale=1.0, k_scale=ks, v_scale=vs)
    k4, v4 = (pack_int4(torch.clamp(x, -8, 7)) for x in (k, v))
    with pytest.raises(ValueError, match="int4 cache needs"):
        call(q, k4, v4, base, table, scale=1.0)
    with pytest.raises(ValueError, match="cache_quant"):
        rpa.route_name(True, "int2")
    with pytest.raises(ValueError, match="int32"):
        call(q, k, v, base, table.long(), scale=1.0, k_scale=ks, v_scale=vs)
    with pytest.raises(ValueError, match="n_slot_pages"):
        call(q, k, v, base, table[:1], scale=1.0, k_scale=ks, v_scale=vs)
    for bad_ps in (12, 4):  # not a power of two; below the smallest page
        pool = torch.zeros((5, bad_ps, 2, HD))
        with pytest.raises(ValueError, match="power of two"):
            call(q, pool, pool, base, table, scale=1.0)
    assert rpa.page_size_refusal(8) is None
    assert rpa.page_size_refusal(256) is None
    with pytest.raises(ValueError, match="verify window"):
        serving_cache_attention(q, k, v, base, table, verify=True,
                                k_scale=ks, v_scale=vs)


def test_backend_plan_names_the_route_and_the_page_gate():
    kw = dict(n_heads=32, n_kv_heads=8, head_dim=128, chunk=256)
    plan = attention_backend_plan(device="cuda", kv_layout="paged",
                                  page_size=64, cache_quant="int8", **kw)
    assert set(plan) == {"decode", "verify", "prefill"}
    assert all(p["backend"] == "cuda" and p["route"] == "int8_paged"
               for p in plan.values())
    assert "int8_paged" in plan["decode"]["reason"]
    odd = attention_backend_plan(device="cuda", kv_layout="paged",
                                 page_size=48, **kw)
    assert odd["prefill"]["backend"] == "unsupported"
    assert "power of two" in odd["prefill"]["reason"]
    int4 = attention_backend_plan(device="cuda", cache_quant="int4", **kw)
    assert int4["decode"]["backend"] == "cuda"
    assert int4["decode"]["route"] == "int4_dense"
    cpu = attention_backend_plan(device="cpu", kv_layout="paged",
                                 page_size=16, **kw)
    assert cpu["decode"]["backend"] == "plain"
    assert cpu["decode"]["route"] == "paged"
    assert [rpa.route_name(p, q) for q in ("none", "int8", "int4")
            for p in (False, True)] == list(rpa.ROUTES)
    assert rpa.route_key("paged") == "ragged_paged_attention{paged}"
