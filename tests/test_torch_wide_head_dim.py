"""Head dim 256 (Gemma-2B) and a GQA group of 7 (Qwen2-7B) against the
reference, on the CPU.

K1-K4 take hd 256 in instantiations of their own and a group of 7 like
any other (``ops/kernel_support.py``, ``csrc/``); on the CPU their
wrappers run the plain versions, which this file holds against the JAX
package's path for these shapes. That path is XLA: the reference's Pallas
gate takes hd 64 and 128 only, and its serving cache attention is an XLA
gather off the TPU.

- K2-K4: the port's ``flash_attention`` entry (forward ``flash_fwd``,
  backward delta, ``flash_bwd_dkv`` and ``flash_bwd_dq``) against the
  reference's ``mha_reference`` differentiated by ``jax.vjp``, f32, at
  Gemma's heads (8 over 1), at a group of 7 and windowed: atol 1e-5.
- K1: ``ragged_paged_attention``'s plain version against the reference's
  ``generate._cached_attention`` on decode, a verify window and a prefill
  chunk, dense and paged, f32 rows, int8 and int4 codes (atol 1e-5), and
  bf16 rows (atol 2e-2: one bf16 ulp of an output near 1, the rounding of
  the probabilities before the V product).
- Tiny Gemma (hd 256, tied head, GeGLU, (1 + w) norms, scaled embeddings)
  and tiny Qwen2 (group 7, random q/k/v biases), f32: logits within 1e-4
  of the reference's forward, greedy streams equal to its ``generate``,
  and a train step's gradients equal to ``jax.grad``'s; Gemma's tied head
  has one leaf, whose gradient sums both roles.

The CUDA kernels need the card: ``chip_smoke.py`` phase 9 holds them
against these plain versions there.
"""

import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from k8s_gpu_device_plugin_tpu.models import generate as jgen
from k8s_gpu_device_plugin_tpu.models import llama as jllama
from k8s_gpu_device_plugin_tpu.models import train as jtrain
from k8s_gpu_device_plugin_tpu.ops import flash_attention as jfa
from k8s_gpu_device_plugin_tpu.ops.attention import mha_reference as jmha
from k8s_gpu_device_plugin_torch.models import generate as tgen
from k8s_gpu_device_plugin_torch.models import llama as tllama
from k8s_gpu_device_plugin_torch.models import train as ttrain
from k8s_gpu_device_plugin_torch.models.convert import (
    params_from_jax,
    params_to_numpy,
)
from k8s_gpu_device_plugin_torch.ops import flash_attention as tfa
from k8s_gpu_device_plugin_torch.ops import kernel_support
from k8s_gpu_device_plugin_torch.ops import ragged_paged_attention as rpa
from k8s_gpu_device_plugin_torch.ops.quant import pack_int4

torch.set_num_threads(1)

HD = 256
ATOL = 1e-5
BF16_ATOL = 2e-2
LOGITS_ATOL = 1e-4


# --- K2-K4 -------------------------------------------------------------------


@pytest.mark.parametrize("hq,hkv,window", [(8, 1, 0), (7, 1, 0), (14, 2, 48)],
                         ids=["gemma_heads", "group7", "group7_window"])
def test_flash_plain_versions_match_the_reference(hq, hkv, window):
    b, s = 1, 128
    rng = np.random.default_rng(hq + window)
    q = rng.standard_normal((b, s, hq, HD)).astype(np.float32)
    k = rng.standard_normal((b, s, hkv, HD)).astype(np.float32)
    v = rng.standard_normal((b, s, hkv, HD)).astype(np.float32)
    do = rng.standard_normal((b, s, hq, HD)).astype(np.float32)
    jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
    assert not jfa.supports(jq, jk, jv)  # the reference runs XLA here
    want, (wdq, wdk, wdv) = jax.jit(lambda a, b_, c, g: (
        lambda out, vjp: (out, vjp(g)))(*jax.vjp(
            lambda x, y, z: jmha(x, y, z, window=window), a, b_, c)))(
        jq, jk, jv, jnp.asarray(do))

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


def test_flash_p_bf16_versions_stay_within_their_bounds():
    """At hd 256 and a group of 7 the plain versions that round where the
    tensor cores do stay within the bounds the card holds the kernels to:
    o within P_BF16_VBOUND max|v| of the f32 one, each gradient within
    ``grad_wide_tol`` of its magnitude."""
    rng = np.random.default_rng(7)
    s, hq, hkv = 128, 7, 1
    q, do = (torch.from_numpy(rng.standard_normal((hq, s, HD))
                              .astype(np.float32)) for _ in range(2))
    k, v = (torch.from_numpy(rng.standard_normal((hkv, s, HD))
                             .astype(np.float32)) for _ in range(2))
    kw = dict(scale=HD ** -0.5, causal=True)
    o, lse = tfa.flash_fwd(q, k, v, **kw)
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
        assert g.shape == (hq if name == "dq" else hkv, s, HD)
        assert not bool(((rounded[name] - g).abs()
                         > kernel_support.grad_wide_tol(mag[name])).any())


# --- K1 ----------------------------------------------------------------------

PS = 16
N_SLOT_PAGES = 8            # virtual extent 128 rows per slot
S = PS * N_SLOT_PAGES
WINDOWS = [("decode", 1, False), ("verify", 4, True), ("chunk", 16, False)]


def _pool(seed, t, hq, hkv, bases, quantized):
    """A shuffled pool of pages at hd 256: each slot reserves the pages its
    live rows need, the rest of its table row is 0 (the trap page)."""
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


def _t(x, dtype=None):
    """numpy -> torch; int4 codes become the port's packed uint8."""
    if x is None:
        return None
    if x.dtype == ml_dtypes.int4:
        return pack_int4(torch.from_numpy(x.astype(np.int8)))
    t = torch.from_numpy(x)
    return t.to(dtype) if dtype is not None and t.is_floating_point() else t


def _j(x, dtype=None):
    if x is None:
        return None
    a = jnp.asarray(x)
    return a.astype(dtype) if dtype is not None and x.dtype == np.float32 \
        and x.ndim == 4 and x.shape[-1] == HD else a


@pytest.mark.parametrize("rows", ["float32", "int8", "int4", "bfloat16"])
@pytest.mark.parametrize("layout", ["dense", "paged"])
@pytest.mark.parametrize("kind,t,verify", WINDOWS,
                         ids=[w[0] for w in WINDOWS])
def test_rpa_plain_version_matches_the_reference(rows, layout, kind, t,
                                                 verify):
    """Gemma-2B's heads (8 over 1) at hd 256, three slots: one at the
    start, one mid-page, one ending at the extent."""
    quantized = rows if rows.startswith("int") else "none"
    dtype = "bfloat16" if rows == "bfloat16" else "float32"
    bases = [0, 57, S - t - 1]
    q, k, v, ks, vs, table = _pool(t + len(rows), t, 8, 1, bases, quantized)
    base = np.asarray(bases, np.int32)
    if layout == "dense":  # the same rows, gathered into per-slot caches
        k, v, ks, vs = (None if x is None else
                        x[table].reshape(len(bases), S, *x.shape[-2:])
                        for x in (k, v, ks, vs))
        table = None
    cfg = jllama.LlamaConfig.tiny(
        dtype=getattr(jnp, dtype), n_heads=8, n_kv_heads=1,
        head_dim_override=HD, kv_layout=layout, kv_page_size=PS,
        cache_quant=quantized)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want = jgen._cached_attention(_j(q, jd), _j(k, jd), _j(v, jd), _j(ks),
                                  _j(vs), _j(base), cfg, pages=_j(table),
                                  verify=verify)
    got = rpa.ragged_paged_attention(
        _t(q, td), _t(k, td), _t(v, td), _t(base), _t(table),
        scale=HD ** -0.5, k_scale=_t(ks), v_scale=_t(vs), verify=verify)
    assert got.dtype == td
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=BF16_ATOL if dtype == "bfloat16" else ATOL,
                               rtol=0)


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_rpa_plain_version_at_a_group_of_seven(layout):
    """Qwen2-7B's group (28 over 4, here 14 over 2) at hd 128: 63 of a
    64-row tile live on the chunk engine, 7 of 8 on the split one."""
    bases = [0, 57, S - 17]
    rng_t = 16
    q, k, v, _, _, table = _pool(7, rng_t, 14, 2, bases, "none")
    q, k, v = q[..., :128].copy(), k[..., :128].copy(), v[..., :128].copy()
    base = np.asarray(bases, np.int32)
    if layout == "dense":
        k, v = (x[table].reshape(len(bases), S, *x.shape[-2:]) for x in (k, v))
        table = None
    cfg = jllama.LlamaConfig.tiny(
        dtype=jnp.float32, n_heads=14, n_kv_heads=2, head_dim_override=128,
        kv_layout=layout, kv_page_size=PS)
    for t in (1, rng_t):
        want = jgen._cached_attention(_j(q[:, :t]), _j(k), _j(v), None, None,
                                      _j(base), cfg, pages=_j(table))
        got = rpa.ragged_paged_attention(
            _t(q[:, :t].copy()), _t(k), _t(v), _t(base), _t(table),
            scale=128 ** -0.5)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                                   rtol=0)


# --- the tiny models ---------------------------------------------------------

MODELS = {
    # Gemma-2B's family at hd 256: two q heads over one kv head
    "gemma": dict(d_model=128, n_heads=2, n_kv_heads=1,
                  head_dim_override=256, act="gelu_tanh", norm_offset=True,
                  tied_embeddings=True, scale_embed=True, norm_eps=1e-6),
    # Qwen2-7B's family: a group of 7, q/k/v biases
    "qwen2": dict(d_model=224, n_heads=14, n_kv_heads=2, attn_bias=True,
                  rope_theta=1e6),
}


def _models(name: str):
    """(reference cfg, params) and (port cfg, params) from one draw, f32;
    Qwen2's biases and Gemma's norm weights randomized (zeros would hide a
    dropped bias or offset)."""
    jcfg = jllama.LlamaConfig.tiny(n_layers=2, vocab_size=256,
                                   dtype=jnp.float32, **MODELS[name])
    tcfg = tllama.LlamaConfig.tiny(n_layers=2, vocab_size=256,
                                   dtype=torch.float32, **MODELS[name])
    # the port's draw (the reference's layout and distribution), shared
    np_params = params_to_numpy(tllama.init_params(tcfg, seed=3,
                                                   device="cpu"))
    rng = np.random.default_rng(4)
    layers = np_params["layers"]
    for leaf in ("bq", "bk", "bv", "attn_norm", "mlp_norm"):
        if leaf in layers:
            layers[leaf] = rng.normal(0, 0.3, layers[leaf].shape).astype(
                np.float32)
    jparams = jax.tree.map(jnp.asarray, np_params)
    return (jcfg, jparams), (tcfg, params_from_jax(np_params, tcfg,
                                                   device="cpu"))


@pytest.mark.parametrize("name", list(MODELS))
def test_tiny_model_matches_the_reference(name):
    (jcfg, jparams), (tcfg, tparams) = _models(name)
    assert tcfg.head_dim == (256 if name == "gemma" else 16)
    tokens = np.random.default_rng(5).integers(0, 256, (2, 16), np.int32)
    want = np.asarray(jllama.forward(jparams, jnp.asarray(tokens), jcfg))
    with torch.no_grad():
        got = tllama.forward(tparams, torch.from_numpy(tokens).long(), tcfg)
    np.testing.assert_allclose(got.numpy(), want, atol=LOGITS_ATOL, rtol=0)
    prompt = tokens[:, :7]
    want = np.asarray(jgen.generate(jparams, jnp.asarray(prompt), jcfg,
                                    max_new=8))
    with torch.no_grad():
        got = tgen.generate(tparams, torch.from_numpy(prompt).long(), tcfg,
                            max_new=8)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("name", list(MODELS))
def test_tiny_model_gradients_match_the_reference(name):
    """One batch's gradients, leaf for leaf, against ``jax.grad`` of the
    reference's loss; Gemma's tied head is one leaf (``embed``), whose
    gradient sums its two roles, so it differs from the gradient of the
    embedding lookup alone."""
    (jcfg, jparams), (tcfg, tparams) = _models(name)
    jcfg = dataclasses.replace(jcfg, remat=False)
    tcfg = dataclasses.replace(tcfg, remat=False)
    tokens = np.random.default_rng(6).integers(0, 256, (2, 17), np.int32)
    batch = {"inputs": tokens[:, :-1], "targets": tokens[:, 1:]}
    want = jax.jit(jax.grad(lambda p: jtrain.loss_fn(
        p, {k: jnp.asarray(v) for k, v in batch.items()}, jcfg, None)[0]))(
        jparams)
    leaves = ttrain.param_leaves(tparams)
    for x in leaves:
        x.requires_grad_(True)
    loss, _ = ttrain.loss_fn(tparams, {k: torch.from_numpy(v).long()
                                       for k, v in batch.items()}, tcfg)
    loss.backward()
    assert ("lm_head" in tparams) == (name != "gemma")
    got = {"embed": tparams["embed"].grad,
           **{f"layers.{k}": v.grad for k, v in tparams["layers"].items()}}
    ref = {"embed": want["embed"],
           **{f"layers.{k}": v for k, v in want["layers"].items()}}
    for key, g in got.items():
        np.testing.assert_allclose(g.numpy(), np.asarray(ref[key]),
                                   atol=ATOL, rtol=1e-4, err_msg=key)
    if name == "gemma":  # the head's role reaches rows no token looked up
        unused = np.setdiff1d(np.arange(256), tokens[:, :-1])
        assert float(got["embed"][torch.from_numpy(unused)].abs().max()) > 0
