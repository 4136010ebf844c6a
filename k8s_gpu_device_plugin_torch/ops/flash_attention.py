"""Flash attention for training: the forward and backward kernels'
wrappers, their plain PyTorch versions and the autograd entry.

Port of ``k8s_gpu_device_plugin_tpu/ops/flash_attention.py``. Three
hand-written kernels (``csrc/flash_attention.cu``) replace its three
Pallas kernels:

- ``flash_fwd`` (``_fwd_kernel``): o and the f32 row logsumexp;
- ``flash_bwd_dkv`` (``_bwd_dkv_kernel``): dK and dV in f32, the GQA
  group's q heads summed inside the kernel;
- ``flash_bwd_dq`` (``_bwd_dq_kernel``): dQ in f32.

Each has two engines (:func:`engine`): bf16 on the tensor cores
(``csrc/attention_tile.cuh``'s ``wgmma`` mainloop; P rounded to bf16
before P V, p and dS before the gradient products), f32 on the CUDA
cores. Each launch is also counted under its engine.

They work in the reference's (B*H, S, hd) layout, with lse and delta
(B*H, S, 1) f32; q row r reads kv row ``r // group`` (the reference's
``_kv_row``), so K/V are never expanded. CUDA tensors launch the kernels
(built at first use, counted in ``kernel_support.launch_counts()``) or
raise; CPU tensors take the plain versions below. Nothing gives way from
a kernel to its plain version.

:func:`flash_attention` is the (B, S, H, hd) entry: a
``torch.library`` custom op with a registered autograd (forward = K2,
backward = delta, K3, K4), so a selective-checkpoint policy can name it
(``models/llama.py`` saves its outputs under ``save_dots_attn``).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from k8s_gpu_device_plugin_torch.ops import kernel_support

SOURCE = kernel_support.CSRC_DIR / "flash_attention.cu"

#: q and kv rows per kernel tile; divides every S that supports() accepts
TILE = 64

_NEG_BIG = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = {
    # pointers, (dtype, rows, group, S, hd), scale, causal, window, stream
    "flash_fwd": [_P] * 5 + [_I] * 5 + [_F, _I, _I, _P],
    "flash_bwd_dkv": [_P] * 8 + [_I] * 5 + [_F, _I, _I, _P],
    "flash_bwd_dq": [_P] * 7 + [_I] * 5 + [_F, _I, _I, _P],
}


@functools.cache
def load_kernel() -> ctypes.CDLL:
    """Build (once per source hash) and load the kernel library."""
    lib = kernel_support.load_library("flash_attention", [SOURCE])
    for name, argtypes in _ARGTYPES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def shape_refusal(*, seq_len: int, n_heads: int, n_kv_heads: int,
                  head_dim: int, dtype: torch.dtype) -> "str | None":
    """Why the kernels cannot take this geometry, or None when they can:
    whole GQA groups, hd in ``kernel_support.LANE_ALIGNED_HEAD_DIMS`` (16,
    32, 64, 128, 256), S a positive multiple of TILE, bf16 or f32. Every
    shape the reference's gate accepts (S a multiple of 128) passes. A
    trainer checks its config here at startup."""
    if not kernel_support.gqa_ok(n_heads, n_kv_heads):
        return (f"n_heads={n_heads} is not a multiple of "
                f"n_kv_heads={n_kv_heads}")
    if not kernel_support.lane_aligned(head_dim):
        return (f"head_dim={head_dim} not in "
                f"{kernel_support.LANE_ALIGNED_HEAD_DIMS}")
    if seq_len < TILE or seq_len % TILE:
        return f"seq_len={seq_len} is not a positive multiple of {TILE}"
    if dtype not in _DTYPES:
        return f"dtype {dtype} not in {list(_DTYPES)}"
    return None


def refusal(q: torch.Tensor, k: torch.Tensor,
            v: torch.Tensor) -> "str | None":
    """:func:`shape_refusal` for (B, S, H, hd) tensors, plus one shape
    for k and v beside q and one dtype for all three."""
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        return (f"q must be (B, S, H, hd) and k/v one (B, S, Hkv, hd); got "
                f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, s, h, d = q.shape
    if (k.shape[0], k.shape[1], k.shape[3]) != (b, s, d):
        return f"k {tuple(k.shape)} does not match q {tuple(q.shape)}"
    if k.dtype != q.dtype or v.dtype != q.dtype:
        return f"q/k/v dtypes differ: {q.dtype}, {k.dtype}, {v.dtype}"
    return shape_refusal(seq_len=s, n_heads=h, n_kv_heads=k.shape[2],
                         head_dim=d, dtype=q.dtype)


def supports(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> bool:
    """(B, S, H, hd) shapes the kernels take (see :func:`refusal`)."""
    return refusal(q, k, v) is None


# --- plain versions -----------------------------------------------------------


def _group(q: torch.Tensor, k: torch.Tensor) -> int:
    if q.shape[0] % k.shape[0]:
        raise ValueError(
            f"{q.shape[0]} q rows do not fold onto {k.shape[0]} kv rows"
        )
    return q.shape[0] // k.shape[0]


def _expand(x: torch.Tensor, group: int) -> torch.Tensor:
    """(B*Hkv, S, hd) -> (B*Hq, S, hd): kv row r // group for q row r
    (an expand and a copy: no host sync, so CUDA graphs can capture it)."""
    if group == 1:
        return x
    return x[:, None].expand(-1, group, -1, -1).reshape(-1, *x.shape[1:])


def _scores(q, k, *, scale, causal, window) -> torch.Tensor:
    """(BH, S, S) f32 scores, masked to -1e30 like the kernels."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if causal:
        pos = torch.arange(q.shape[1], device=q.device)
        keep = pos[:, None] >= pos[None, :]
        if window > 0:
            keep &= pos[:, None] - pos[None, :] < window
        s = torch.where(keep, s, torch.full_like(s, _NEG_BIG))
    return s


#: |o - o_p_bf16| <= P_BF16_VBOUND * max|v| (before o's own rounding):
#: rounding each weight p to bf16 moves it by at most half its spacing,
#: 2^-8 of a weight just above a power of two (the spacing is 2^-7 there),
#: and the weights sum to l, so o = sum p v / l moves by at most
#: 2^-8 max|v|
P_BF16_VBOUND = 2.0 ** -8


def o_wide_tol(v: torch.Tensor) -> dict:
    """The bf16 tensor-core forward's bound against the f32 plain version:
    one ulp (``kernel_support.O_TOL_BF16``) plus :data:`P_BF16_VBOUND`
    ``* max|v|``; the ``wide`` of ``kernel_support.bf16_o_mismatch``."""
    tight = kernel_support.O_TOL_BF16
    return dict(atol=tight["atol"] + P_BF16_VBOUND * float(v.abs().max()),
                rtol=tight["rtol"])


def flash_fwd_reference(q, k, v, *, scale: float, causal: bool = True,
                        window: int = 0, p_bf16: bool = False):
    """The plain forward: materialised f32 scores, softmax with the
    reference's ``l == 0`` guard. Returns (o in q's dtype, lse (BH, S, 1)
    f32).

    ``p_bf16`` rounds the weights where the tensor-core kernel does: each
    64-column tile's ``exp(s - m_j)``, with ``m_j`` the row's running max
    over tiles ``<= j``, to bf16 before the V product (then rescaled to
    the final max in f32: ``kernel_support.p_bf16_weights``); l stays the
    sum of the unrounded weights. The kernel is held to this version at
    one bf16 ulp of o, and to the f32 one within :func:`o_wide_tol`
    (``kernel_support.bf16_o_mismatch``)."""
    group = _group(q, k)
    s = _scores(q, _expand(k, group), scale=scale, causal=causal,
                window=window)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    l_safe = torch.where(l == 0, torch.ones_like(l), l)
    if p_bf16:
        p = kernel_support.p_bf16_weights(s, m, TILE)
    o = torch.matmul(p, _expand(v, group).float()) / l_safe
    return o.to(q.dtype), m + torch.log(l_safe)


def _bwd_probs(q, k, v, do, lse, delta, *, scale, causal, window,
               p_bf16=False):
    """p = exp(s - lse) and dS = p * (dO v^T - delta) * scale, (BH, S, S);
    with ``p_bf16`` each rounded once to bf16 after dS is computed from
    the f32 p, as the tensor-core kernels round their A operands."""
    group = _group(q, k)
    p = torch.exp(_scores(q, _expand(k, group), scale=scale, causal=causal,
                          window=window) - lse)
    dp = torch.matmul(do.float(), _expand(v, group).float().transpose(-1, -2))
    ds = p * (dp - delta) * scale
    if p_bf16:
        return p.bfloat16().float(), ds.bfloat16().float()
    return p, ds


def _group_sum(x: torch.Tensor, k: torch.Tensor, group: int) -> torch.Tensor:
    """(B*Hq, S, hd) -> (B*Hkv, S, hd): the sum over each group's q heads."""
    return x.reshape(k.shape[0], group, *k.shape[1:]).sum(1)


def flash_bwd_dkv_reference(q, k, v, do, lse, delta, *, scale: float,
                            causal: bool = True, window: int = 0,
                            p_bf16: bool = False):
    """The plain dK, dV: (B*Hkv, S, hd) f32 each, the group's q heads
    summed. ``p_bf16`` rounds p (for dV) and dS (for dK) to bf16 where
    the tensor-core kernel does (lse is final: no running max); the
    kernel is held to this version and to the f32 one by
    ``kernel_support.bf16_grad_mismatch``."""
    group = _group(q, k)
    p, ds = _bwd_probs(q, k, v, do, lse, delta, scale=scale, causal=causal,
                       window=window, p_bf16=p_bf16)
    dv = torch.matmul(p.transpose(-1, -2), do.float())
    dk = torch.matmul(ds.transpose(-1, -2), q.float())
    return _group_sum(dk, k, group), _group_sum(dv, k, group)


def flash_bwd_dq_reference(q, k, v, do, lse, delta, *, scale: float,
                           causal: bool = True, window: int = 0,
                           p_bf16: bool = False):
    """The plain dQ: (B*Hq, S, hd) f32; ``p_bf16`` rounds dS to bf16 as
    :func:`flash_bwd_dkv_reference` does."""
    _, ds = _bwd_probs(q, k, v, do, lse, delta, scale=scale, causal=causal,
                       window=window, p_bf16=p_bf16)
    return torch.matmul(ds, _expand(k, _group(q, k)).float())


def _largest_term(a: torch.Tensor, b: torch.Tensor,
                  rows: int = 8) -> torch.Tensor:
    """``max_i |a[..., r, i]| |b[..., i, d]|`` (batched), ``rows`` rows of
    ``a`` at a time."""
    a, b = a.abs(), b.abs()
    out = a.new_empty((*a.shape[:-1], b.shape[-1]))
    for r in range(0, a.shape[-2], rows):
        out[..., r:r + rows, :] = (a[..., r:r + rows, :, None]
                                   * b[..., None, :, :]).amax(-2)
    return out


def flash_bwd_magnitudes(q, k, v, do, lse, delta, *, scale: float,
                         causal: bool = True, window: int = 0) -> dict:
    """Each gradient element's (sum of |terms|, largest |term|) as the
    tensor-core kernels sum it: ``bf16(p)^T dO`` for dV, ``bf16(dS)^T Q``
    for dK (over the group's q heads too), ``bf16(dS) K`` for dQ. The
    ``magnitude`` that ``kernel_support.bf16_grad_mismatch`` scales its
    tolerances by; ``{"dk", "dv", "dq"}``, each a pair shaped as the
    gradient."""
    group = _group(q, k)
    p, ds = _bwd_probs(q, k, v, do, lse, delta, scale=scale, causal=causal,
                       window=window, p_bf16=True)
    p, ds = p.abs(), ds.abs()
    qa, doa = q.float().abs(), do.float().abs()
    ka, va = (_expand(x, group).float().abs() for x in (k, v))
    # dP = dO v^T sums hd products in another order in the kernel: at most
    # hd 2^-24 of their sum of |terms| apart. Where dP - delta cancels (row
    # 0 of a causal head: delta = dP), dS is that noise, so the largest
    # term counts an operand dS as the larger of itself and its noise over
    # the flip allowance (GRAD_TIGHT["flip"] = 2^-7).
    dp_noise = torch.matmul(doa, va.transpose(-1, -2))
    ds_big = torch.maximum(ds, p * scale * q.shape[-1] * 2.0 ** -17 * dp_noise)

    def per_kv_head(x):  # (B*Hq, S, hd) -> (B*Hkv, group, S, hd)
        return x.reshape(k.shape[0], group, *k.shape[1:])

    pt, dst = p.transpose(-1, -2), ds.transpose(-1, -2)
    return {
        "dk": (_group_sum(torch.matmul(dst, qa), k, group),
               per_kv_head(_largest_term(ds_big.transpose(-1, -2), qa))
               .amax(1)),
        "dv": (_group_sum(torch.matmul(pt, doa), k, group),
               per_kv_head(_largest_term(pt, doa)).amax(1)),
        "dq": (torch.matmul(ds, ka), _largest_term(ds_big, ka)),
    }


# --- kernel wrappers ----------------------------------------------------------


def _check(q, k, v, *rows: torch.Tensor) -> None:
    """Layouts every route needs: q (BH, S, hd), k/v (BHkv, S, hd), whole
    groups, and (BH, S, 1) row tensors (lse, delta) beside q or dO."""
    if q.dim() != 3 or k.dim() != 3 or k.shape != v.shape:
        raise ValueError(
            f"q must be (BH, S, hd) and k/v one (BHkv, S, hd); got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    if k.shape[1:] != q.shape[1:]:
        raise ValueError(f"k {tuple(k.shape)} does not match q {tuple(q.shape)}")
    _group(q, k)
    devs = {x.device for x in (q, k, v, *rows)}
    if len(devs) != 1:
        raise ValueError(f"inputs on different devices: {devs}")


def _check_kernel(q, k, v, *others: torch.Tensor,
                  rows: tuple = ()) -> None:
    """What the kernels take: a CUDA device, one dtype of bf16/f32 for q,
    k, v (and dO among ``others``), hd 16/32/64/128/256, S a multiple of
    TILE, contiguous 16-byte-aligned operands, f32 (BH, S, 1) ``rows``."""
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    bh, s, hd = q.shape
    why = shape_refusal(seq_len=s, n_heads=bh, n_kv_heads=k.shape[0],
                        head_dim=hd, dtype=q.dtype)
    if why is not None:
        raise ValueError(why)
    if any(x.dtype != q.dtype for x in (k, v, *others)):
        raise ValueError(
            f"q/k/v/dO must share one dtype of {list(_DTYPES)}; got "
            f"{[str(x.dtype) for x in (q, k, v, *others)]}"
        )
    for x in rows:
        if x.dtype != torch.float32 or tuple(x.shape) != (bh, s, 1):
            raise ValueError(
                f"lse/delta must be f32 {(bh, s, 1)}, got {x.dtype} "
                f"{tuple(x.shape)}"
            )
    for x in (q, k, v, *others, *rows):
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError("kernel operands must be contiguous and "
                             "16-byte aligned")


def engine(dtype: torch.dtype) -> str:
    """The engine of a launch of any of the three kernels: the tensor
    cores for bf16, the CUDA cores for f32 (its pins need f32 products).
    The C interface picks the kernel by the same dtype."""
    return "tensor_cores" if dtype == torch.bfloat16 else "cuda_cores"


def _launch(name: str, q: torch.Tensor, *args) -> None:
    """Launch kernel ``name`` on q's device and dtype (``args`` after the
    pointers: dtype first), counted under its name and its engine."""
    err = getattr(load_kernel(), name)(
        *args, torch.cuda.current_stream(q.device).cuda_stream
    )
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")
    kernel_support.count_launch(name)
    kernel_support.count_launch(
        kernel_support.engine_key(name, engine(q.dtype)))


def flash_fwd(q, k, v, *, scale: float, causal: bool = True,
              window: int = 0):
    """(o (BH, S, hd) in q's dtype, lse (BH, S, 1) f32): K2 on a CUDA
    tensor, :func:`flash_fwd_reference` on a CPU one."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return flash_fwd_reference(q, k, v, scale=scale, causal=causal,
                                   window=window)
    _check_kernel(q, k, v)
    bh, s, hd = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((bh, s, 1), dtype=torch.float32, device=q.device)
    _launch("flash_fwd", q, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            o.data_ptr(), lse.data_ptr(), _DTYPES[q.dtype], bh,
            _group(q, k), s, hd, float(scale), int(causal), int(window))
    return o, lse


def flash_bwd_dkv(q, k, v, do, lse, delta, *, scale: float,
                  causal: bool = True, window: int = 0):
    """(dk, dv), (BHkv, S, hd) f32 each: K3 on a CUDA tensor,
    :func:`flash_bwd_dkv_reference` on a CPU one."""
    _check(q, k, v, do, lse, delta)
    if q.device.type == "cpu":
        return flash_bwd_dkv_reference(q, k, v, do, lse, delta, scale=scale,
                                       causal=causal, window=window)
    _check_kernel(q, k, v, do, rows=(lse, delta))
    dk = torch.empty(k.shape, dtype=torch.float32, device=k.device)
    dv = torch.empty_like(dk)
    _launch("flash_bwd_dkv", q, q.data_ptr(), k.data_ptr(),
            v.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), _DTYPES[q.dtype], k.shape[0],
            _group(q, k), q.shape[1], q.shape[2], float(scale), int(causal),
            int(window))
    return dk, dv


def flash_bwd_dq(q, k, v, do, lse, delta, *, scale: float,
                 causal: bool = True, window: int = 0):
    """dq, (BH, S, hd) f32: K4 on a CUDA tensor,
    :func:`flash_bwd_dq_reference` on a CPU one."""
    _check(q, k, v, do, lse, delta)
    if q.device.type == "cpu":
        return flash_bwd_dq_reference(q, k, v, do, lse, delta, scale=scale,
                                      causal=causal, window=window)
    _check_kernel(q, k, v, do, rows=(lse, delta))
    dq = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    _launch("flash_bwd_dq", q, q.data_ptr(), k.data_ptr(),
            v.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            dq.data_ptr(), _DTYPES[q.dtype], q.shape[0], _group(q, k),
            q.shape[1], q.shape[2], float(scale), int(causal), int(window))
    return dq


# --- the (B, S, H, hd) autograd entry ----------------------------------------


def _to_bhsd(x: torch.Tensor) -> torch.Tensor:
    """(B, S, H, hd) -> contiguous (B*H, S, hd) (for B = 1 the reshape
    alone would be a strided view)."""
    b, s, h, d = x.shape
    return x.transpose(1, 2).reshape(b * h, s, d).contiguous()


def _from_bhsd(x: torch.Tensor, b: int, h: int) -> torch.Tensor:
    return x.reshape(b, h, *x.shape[1:]).transpose(1, 2)


@torch.library.custom_op("k8s_gpu_device_plugin_torch::flash_attention",
                         mutates_args=())
def flash_attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       scale: float, causal: bool,
                       window: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(o (B, S, H, hd), lse (B, H, S) f32) through :func:`flash_fwd`."""
    b, s, h, _ = q.shape
    o, lse = flash_fwd(_to_bhsd(q), _to_bhsd(k), _to_bhsd(v), scale=scale,
                       causal=causal, window=window)
    return _from_bhsd(o, b, h).contiguous(), lse.reshape(b, h, s)


@flash_attention_op.register_fake
def _(q, k, v, scale, causal, window):
    b, s, h, _ = q.shape
    return torch.empty_like(q), q.new_empty((b, h, s), dtype=torch.float32)


def _setup_context(ctx, inputs, output) -> None:
    q, k, v, scale, causal, window = inputs
    o, lse = output
    ctx.save_for_backward(q, k, v, o, lse)
    ctx.kw = dict(scale=scale, causal=causal, window=window)


def _backward(ctx, do, dlse):
    """delta = rowsum(dO * o) - dlse in plain PyTorch (the reference's
    XLA reduce), then K3 and K4; f32 grads cast to the inputs' dtypes,
    as ``_flash_bwd_impl`` does."""
    q, k, v, o, lse = ctx.saved_tensors
    b, s, h, _ = q.shape
    hkv = k.shape[2]
    qb, kb, vb, ob = (_to_bhsd(x) for x in (q, k, v, o))
    dob = _to_bhsd(do.to(q.dtype))
    delta = (dob.float() * ob.float()).sum(dim=-1, keepdim=True)
    if dlse is not None:  # the lse cotangent folds into delta
        delta = delta - dlse.float().reshape(b * h, s, 1)
    lse_b = lse.reshape(b * h, s, 1)
    dk, dv = flash_bwd_dkv(qb, kb, vb, dob, lse_b, delta, **ctx.kw)
    dq = flash_bwd_dq(qb, kb, vb, dob, lse_b, delta, **ctx.kw)
    return (_from_bhsd(dq, b, h).to(q.dtype), _from_bhsd(dk, b, hkv).to(k.dtype),
            _from_bhsd(dv, b, hkv).to(v.dtype), None, None, None)


flash_attention_op.register_autograd(_backward, setup_context=_setup_context)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, scale: "float | None" = None,
                    window: int = 0, return_lse: bool = False):
    """(B, S, H, hd) flash attention; K/V may have grouped heads.
    ``window > 0`` keeps keys in (i - window, i] (causal only). With
    ``return_lse`` also returns the differentiable row logsumexp
    (B, H, S) f32. Raises, on any device, on shapes the kernels do not
    take (:func:`refusal`)."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    if window > 0 and not causal:
        raise ValueError("sliding window requires causal attention")
    why = refusal(q, k, v)
    if why is not None:
        raise ValueError(f"flash_attention: {why}")
    o, lse = flash_attention_op(q, k, v, float(scale), bool(causal),
                                int(window))
    return (o, lse) if return_lse else o
