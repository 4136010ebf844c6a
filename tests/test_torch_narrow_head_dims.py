"""The kernels' plain versions at head dims 16 and 32 against the reference.

The port's kernels take hd 16 and 32 by running them in their 64-column
tiles, zero-padded (``ops/kernel_support.py``); on the CPU their wrappers
run the plain versions, which this file holds against the JAX package:

- K2-K4 (flash forward, dK dV, dQ): the reference's flash gate takes only
  hd 64 and 128, so at these head dims the reference runs
  ``mha_reference`` and differentiates it with ``jax.vjp``. The port's
  ``flash_attention`` entry (forward ``flash_fwd``, backward delta and
  ``flash_bwd_dkv`` / ``flash_bwd_dq``) is held to it in f32, with GQA,
  causal and windowed: atol 1e-5 on o and the gradients (f32, summation
  order only).
- K1 (ragged-paged attention): the reference's serving-cache path
  (``generate._cached_attention``, its XLA gather) on decode, a verify
  window and a prefill chunk, dense and paged, bf16-free f32 rows, int8
  codes and int4 codes: atol 1e-5.

The gates that now take these head dims (and still refuse others) are
pinned here too. The CUDA kernels themselves need the card:
``chip_smoke.py`` holds them against these plain versions there.
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from k8s_gpu_device_plugin_tpu.models import generate as jgen
from k8s_gpu_device_plugin_tpu.models import llama as jllama
from k8s_gpu_device_plugin_tpu.ops import flash_attention as jfa
from k8s_gpu_device_plugin_tpu.ops.attention import mha_reference as jmha
from k8s_gpu_device_plugin_torch.ops import flash_attention as tfa
from k8s_gpu_device_plugin_torch.ops import kernel_support
from k8s_gpu_device_plugin_torch.ops import ragged_paged_attention as rpa
from k8s_gpu_device_plugin_torch.ops.attention import attention_backend_plan
from k8s_gpu_device_plugin_torch.ops.quant import pack_int4

# the suite runs in several worker processes on shared cores: one
# intra-op thread each keeps torch's OpenMP pool from spinning against
# them (these shapes gain nothing from more)
torch.set_num_threads(1)

NARROW = (16, 32)
ATOL = 1e-5


# --- K2-K4 -------------------------------------------------------------------


@pytest.mark.parametrize("hd", NARROW)
@pytest.mark.parametrize("hq,hkv,window", [(4, 2, 0), (4, 4, 48), (8, 2, 0)])
def test_flash_plain_versions_match_the_reference(hd, hq, hkv, window):
    b, s = 2, 128
    rng = np.random.default_rng(hd + hq + window)
    q = rng.standard_normal((b, s, hq, hd)).astype(np.float32)
    k = rng.standard_normal((b, s, hkv, hd)).astype(np.float32)
    v = rng.standard_normal((b, s, hkv, hd)).astype(np.float32)
    do = rng.standard_normal((b, s, hq, hd)).astype(np.float32)
    jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
    # the reference's kernel gate refuses these head dims: it runs
    # mha_reference, as the port's CPU path does
    assert not jfa.supports(jq, jk, jv)
    want, vjp = jax.vjp(lambda a, b_, c: jmha(a, b_, c, window=window),
                        jq, jk, jv)
    wdq, wdk, wdv = vjp(jnp.asarray(do))

    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    assert tfa.supports(tq, tk, tv)
    kernel_support.reset_launch_counts()
    got = tfa.flash_attention(tq, tk, tv, window=window)
    got.backward(torch.from_numpy(do))
    assert kernel_support.launch_counts() == {}  # CPU: the plain versions
    for g, w in ((got, want), (tq.grad, wdq), (tk.grad, wdk),
                 (tv.grad, wdv)):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   atol=ATOL, rtol=0)


@pytest.mark.parametrize("hd", NARROW)
def test_flash_lse_and_plain_gradients_at_the_tiny_shape(hd):
    """The (B*H, S, hd) plain versions at the tiny preset's training
    heads (Hq 8, Hkv 4, S 128): lse is each row's logsumexp, and the
    p_bf16 versions (what the tensor cores round) stay within one bf16
    rounding of the f32 ones."""
    rng = np.random.default_rng(hd)
    b, s, hq, hkv = 2, 128, 8, 4
    q, do = (torch.from_numpy(rng.standard_normal((b * hq, s, hd))
                              .astype(np.float32)) for _ in range(2))
    k, v = (torch.from_numpy(rng.standard_normal((b * hkv, s, hd))
                             .astype(np.float32)) for _ in range(2))
    kw = dict(scale=hd ** -0.5, causal=True)
    o, lse = tfa.flash_fwd(q, k, v, **kw)
    scores = tfa._scores(q, tfa._expand(k, 2), scale=hd ** -0.5,
                         causal=True, window=0)
    torch.testing.assert_close(lse, torch.logsumexp(scores, -1, True),
                               atol=ATOL, rtol=0)
    o_p, _ = tfa.flash_fwd_reference(q, k, v, p_bf16=True, **kw)
    assert float((o_p - o).abs().max()) <= tfa.P_BF16_VBOUND * float(
        v.abs().max()) + ATOL
    delta = (do * o).sum(-1, keepdim=True)
    bwd = (q, k, v, do, lse, delta)
    dk, dv = tfa.flash_bwd_dkv(*bwd, **kw)
    dq = tfa.flash_bwd_dq(*bwd, **kw)
    mag = tfa.flash_bwd_magnitudes(*bwd, **kw)
    rounded = dict(zip(("dk", "dv"), tfa.flash_bwd_dkv_reference(
        *bwd, p_bf16=True, **kw)))
    rounded["dq"] = tfa.flash_bwd_dq_reference(*bwd, p_bf16=True, **kw)
    for name, g in (("dk", dk), ("dv", dv), ("dq", dq)):
        assert g.shape == (q.shape[0] if name == "dq" else k.shape[0], s, hd)
        assert not bool(((rounded[name] - g).abs()
                         > kernel_support.grad_wide_tol(mag[name])).any())


# --- K1 ----------------------------------------------------------------------

PS = 16
N_SLOT_PAGES = 8            # virtual extent 128 rows per slot
S = PS * N_SLOT_PAGES
# (kind, T, the batcher's verify tag)
WINDOWS = [("decode", 1, False), ("verify", 4, True), ("chunk", 16, False)]


def _pool(seed, hd, t, hq, hkv, bases, quantized):
    """A shuffled pool of pages: each slot reserves the pages its live
    rows need, the rest of its table row is 0 (the trap page)."""
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
    q = rng.standard_normal((b, t, hq, hd)).astype(np.float32)
    shape = (n_pages, PS, hkv, hd)
    if quantized == "none":
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


def _j(x):
    return None if x is None else jnp.asarray(x)


@pytest.mark.parametrize("hd", NARROW)
@pytest.mark.parametrize("quantized", ["none", "int8", "int4"])
@pytest.mark.parametrize("layout", ["dense", "paged"])
@pytest.mark.parametrize("kind,t,verify", WINDOWS,
                         ids=[w[0] for w in WINDOWS])
def test_rpa_plain_version_matches_the_reference(hd, quantized, layout, kind,
                                                 t, verify):
    bases = [0, 57, S - t - 1]
    q, k, v, ks, vs, table = _pool(hd + t, hd, t, 8, 2, bases, quantized)
    base = np.asarray(bases, np.int32)
    if layout == "dense":  # the same rows, gathered into per-slot caches
        k, v, ks, vs = (None if x is None else
                        x[table].reshape(len(bases), S, *x.shape[-2:])
                        for x in (k, v, ks, vs))
        table = None
    cfg = jllama.LlamaConfig.tiny(
        dtype=jnp.float32, n_heads=8, n_kv_heads=2, head_dim_override=hd,
        kv_layout=layout, kv_page_size=PS, cache_quant=quantized)
    want = jgen._cached_attention(_j(q), _j(k), _j(v), _j(ks), _j(vs),
                                  _j(base), cfg, pages=_j(table),
                                  verify=verify)
    got = rpa.ragged_paged_attention(
        _t(q), _t(k), _t(v), _t(base), _t(table), scale=hd ** -0.5,
        k_scale=_t(ks), v_scale=_t(vs), verify=verify)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)


# --- the gates ---------------------------------------------------------------


def test_gates_take_the_narrow_head_dims_and_refuse_the_rest():
    # hd 256 (Gemma-2B's) is taken too, in instantiations of its own
    assert kernel_support.LANE_ALIGNED_HEAD_DIMS == (16, 32, 64, 128, 256)
    assert [kernel_support.tile_head_dim(hd) for hd in (16, 32, 64, 128, 256)] \
        == [64, 64, 64, 128, 256]
    for hd in (16, 32, 256):
        assert tfa.shape_refusal(seq_len=128, n_heads=8, n_kv_heads=4,
                                 head_dim=hd, dtype=torch.bfloat16) is None
        plan = attention_backend_plan(device="cuda", n_heads=8, n_kv_heads=4,
                                      head_dim=hd, chunk=256)
        assert {p["backend"] for p in plan.values()} == {"cuda"}
    for hd in (8, 48, 96, 512):
        why = tfa.shape_refusal(seq_len=128, n_heads=8, n_kv_heads=4,
                                head_dim=hd, dtype=torch.bfloat16)
        assert f"head_dim={hd}" in why and "(16, 32, 64, 128, 256)" in why
        plan = attention_backend_plan(device="cuda", n_heads=8, n_kv_heads=4,
                                      head_dim=hd)
        assert plan["decode"]["backend"] == "unsupported"
        assert f"head_dim={hd}" in plan["decode"]["reason"]
