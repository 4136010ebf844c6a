"""Parity of the port's flash attention with the JAX reference's kernels.

The port's plain versions of K2 (forward), K3 (dK, dV) and K4 (dQ) in
``k8s_gpu_device_plugin_torch/ops/flash_attention.py`` are held against
the reference's Pallas kernels run in interpret mode on the CPU
(``flash_attention(..., interpret=True, block_q=128, block_k=128)``, as
``tests/test_flash_attention.py`` runs them), on the same numpy inputs.
Tolerance: f32 atol 1e-4 — both sides compute in f32; the kernels'
online softmax over 128-row blocks and the plain version's one-pass
softmax differ only in summation order and exp/log rounding.

The port's ``flash_attention`` autograd entry (CPU: the plain versions)
is held against ``mha_reference`` under autograd at f32 atol 1e-5 (same
arithmetic, different association).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.checkpoint import checkpoint

from k8s_gpu_device_plugin_tpu.ops import flash_attention as jfa
from k8s_gpu_device_plugin_tpu.ops.attention import mha_reference as jmha
from k8s_gpu_device_plugin_torch.models import llama as tllama
from k8s_gpu_device_plugin_torch.ops import attention as tattn
from k8s_gpu_device_plugin_torch.ops import flash_attention as tfa
from k8s_gpu_device_plugin_torch.ops import kernel_support

# the suite runs in several worker processes on shared cores: one
# intra-op thread each keeps torch's OpenMP pool from spinning against
# them (these shapes gain nothing from more)
torch.set_num_threads(1)

ATOL = 1e-4
MODES = {"causal": (True, 0), "noncausal": (False, 0), "window100": (True, 100)}


def _inputs(b, s, hq, hkv, hd, seed):
    rng = np.random.default_rng(seed)
    shapes = [(b, s, hq, hd), (b, s, hkv, hd), (b, s, hkv, hd), (b, s, hq, hd)]
    return [rng.standard_normal(sh).astype(np.float32) for sh in shapes]


def _bhsd(x: np.ndarray) -> torch.Tensor:
    return tfa._to_bhsd(torch.from_numpy(x)).contiguous()


def _close(got: torch.Tensor, want, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=atol, rtol=0)


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("hq,hkv", [(4, 4), (8, 2)])
@pytest.mark.parametrize("hd", [64, 128])
def test_plain_versions_match_the_interpret_kernels(hd, hq, hkv, mode):
    causal, window = MODES[mode]
    b, s = 1, 256
    q, k, v, do = _inputs(b, s, hq, hkv, hd, seed=hd + hq + window)
    scale = hd ** -0.5

    def jfn(q, k, v):
        return jfa.flash_attention(q, k, v, causal=causal, window=window,
                                   block_q=128, block_k=128,
                                   block_q_bwd=128, block_k_bwd=128,
                                   interpret=True, return_lse=True)

    (jo, jlse), vjp = jax.vjp(jfn, *(jnp.asarray(x) for x in (q, k, v)))
    jdq, jdk, jdv = vjp((jnp.asarray(do), jnp.zeros_like(jlse)))

    qb, kb, vb, dob = (_bhsd(x) for x in (q, k, v, do))
    kw = dict(scale=scale, causal=causal, window=window)
    o, lse = tfa.flash_fwd_reference(qb, kb, vb, **kw)
    _close(tfa._from_bhsd(o, b, hq), jo)
    _close(lse.reshape(b, hq, s), jlse)
    delta = (dob * o).sum(-1, keepdim=True)
    dk, dv = tfa.flash_bwd_dkv_reference(qb, kb, vb, dob, lse, delta, **kw)
    dq = tfa.flash_bwd_dq_reference(qb, kb, vb, dob, lse, delta, **kw)
    _close(tfa._from_bhsd(dq, b, hq), jdq)
    _close(tfa._from_bhsd(dk, b, hkv), jdk)
    _close(tfa._from_bhsd(dv, b, hkv), jdv)
    # the wrappers take the plain versions for CPU tensors
    o2, lse2 = tfa.flash_fwd(qb, kb, vb, **kw)
    assert torch.equal(o2, o) and torch.equal(lse2, lse)


@pytest.mark.parametrize("mode", list(MODES))
def test_p_bf16_plain_version_stays_within_its_bound(mode):
    """The tensor-core forward rounds each tile's weights to bf16 before
    the V product; its plain version (``p_bf16=True``) moves o by at most
    2^-8 max|v| from the f32 one (f32 q, so no output rounding), leaves
    lse as it is, and does round something."""
    causal, window = MODES[mode]
    q, k, v, _ = (_bhsd(x) for x in _inputs(1, 192, 8, 2, 64, seed=5))
    kw = dict(scale=64 ** -0.5, causal=causal, window=window)
    o, lse = tfa.flash_fwd_reference(q, k, v, **kw)
    o16, lse16 = tfa.flash_fwd_reference(q, k, v, p_bf16=True, **kw)
    assert torch.equal(lse, lse16)
    diff = float((o - o16).abs().max())
    assert 0 < diff <= tfa.P_BF16_VBOUND * float(v.abs().max())


def test_p_bf16_plain_version_rounds_the_running_tile_weights():
    """Two kv tiles, the second's scores higher: the first tile's weights
    are rounded against its own running max, then rescaled."""
    s_len, hd = 128, 64
    rng = np.random.default_rng(9)
    q = torch.from_numpy(rng.standard_normal((1, s_len, hd)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((1, s_len, hd)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((1, s_len, hd)).astype(np.float32))
    o16, _ = tfa.flash_fwd_reference(q, k, v, scale=0.3, causal=False,
                                     p_bf16=True)
    s = (q @ k.transpose(1, 2)) * 0.3
    m1 = s[..., :64].amax(-1, keepdim=True)
    m = s.amax(-1, keepdim=True)
    p1 = torch.exp(s[..., :64] - m1).bfloat16().float() * torch.exp(m1 - m)
    p2 = torch.exp(s[..., 64:] - m).bfloat16().float()
    want = (p1 @ v[:, :64] + p2 @ v[:, 64:]) / torch.exp(s - m).sum(-1, keepdim=True)
    torch.testing.assert_close(o16, want, atol=1e-6, rtol=1e-5)


def test_bf16_o_check_allows_isolated_flips_only():
    """The tensor-core engine's o check: one ulp of the p_bf16 plain
    version but for at most FLIP_ROWS rows (a flipped weight moves its
    whole row), every element within the wide bound of the f32 one (K2's:
    2^-8 max|v| more)."""
    rng = np.random.default_rng(4)
    o_r = torch.from_numpy(rng.standard_normal((4, 64, 64)).astype(np.float32))
    v = torch.full((1, 64, 64), 2.0)
    wide = tfa.o_wide_tol(v)
    assert wide == dict(atol=1e-3 + 2 * tfa.P_BF16_VBOUND, rtol=8e-3)
    o_p = o_r + 1e-3                     # within 2^-8 * 2 of o_r
    check = kernel_support.bf16_o_mismatch
    assert check(o_p.bfloat16(), o_p, o_r, wide) is None
    flips = o_p.clone()
    flips[0, :kernel_support.FLIP_ROWS] += 0.003  # weights rounded the other way
    assert kernel_support.off_one_ulp(flips, o_p)[1] == kernel_support.FLIP_ROWS
    assert check(flips, o_p, o_r, wide) is None
    flips[1, 0] += 0.003                 # one row more than allowed
    assert "5 rows" in check(flips, o_p, o_r, wide)
    biased = o_p.clone()
    biased[:, :, :8] += 0.003            # a systematic fault
    assert "of the p_bf16 plain version" in check(biased, o_p, o_r, wide)
    far = o_p.clone()
    far[0, 0, 0] += 0.05                 # past the f32 version's bound
    assert "plain version by" in check(far, o_p, o_r, wide)


def test_forward_engine_follows_the_dtype(monkeypatch):
    """One engine rule for the three kernels, and each wrapper counts its
    launch under it (a stub library and meta tensors stand in for the
    card)."""
    assert tfa.engine(torch.bfloat16) == "tensor_cores"
    assert tfa.engine(torch.float32) == "cuda_cores"

    class Lib:
        def __getattr__(self, name):
            return lambda *args: 0

    class Stream:
        cuda_stream = 0

    monkeypatch.setattr(tfa, "load_kernel", Lib)
    monkeypatch.setattr(tfa, "_check_kernel", lambda *a, **kw: None)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device: Stream())
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v, do = (torch.empty((rows, 128, 64), dtype=dtype, device="meta")
                       for rows in (4, 2, 2, 4))
        rows = torch.empty((4, 128, 1), device="meta")
        kernel_support.reset_launch_counts()
        tfa.flash_fwd(q, k, v, scale=0.1)
        tfa.flash_bwd_dkv(q, k, v, do, rows, rows, scale=0.1)
        tfa.flash_bwd_dq(q, k, v, do, rows, rows, scale=0.1)
        engine = tfa.engine(dtype)
        assert kernel_support.launch_counts() == {
            key: 1 for name in ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq")
            for key in (name, kernel_support.engine_key(name, engine))}


def _bwd_args(b, s, hq, hkv, hd, mode, seed):
    """bf16-valued f32 inputs of the backward, with the plain forward's lse
    and delta = rowsum(dO o)."""
    causal, window = MODES[mode]
    q, k, v, do = (_bhsd(x) for x in _inputs(b, s, hq, hkv, hd, seed=seed))
    q, k, v, do = (x.bfloat16().float() for x in (q, k, v, do))
    kw = dict(scale=hd ** -0.5, causal=causal, window=window)
    o, lse = tfa.flash_fwd_reference(q, k, v, **kw)
    delta = (do * o).sum(-1, keepdim=True)
    return (q, k, v, do, lse, delta), kw


def _bwd_grads(args, kw, **extra):
    dk, dv = tfa.flash_bwd_dkv_reference(*args, **kw, **extra)
    return {"dk": dk, "dv": dv,
            "dq": tfa.flash_bwd_dq_reference(*args, **kw, **extra)}


@pytest.mark.parametrize("mode", list(MODES))
def test_p_bf16_backward_stays_within_its_bound(mode):
    """The tensor-core backward rounds p and dS to bf16 before its
    gradient products; the plain versions that round them there
    (``p_bf16=True``) move each gradient from the f32 ones by at most
    2^-8 of its sum of |terms| (kernel_support.GRAD_WIDE), and do round
    something; ``p_bf16=False`` is the default."""
    args, kw = _bwd_args(1, 192, 8, 2, 64, mode, seed=11)
    want, got = _bwd_grads(args, kw), _bwd_grads(args, kw, p_bf16=True)
    assert all(torch.equal(want[n], g)
               for n, g in _bwd_grads(args, kw, p_bf16=False).items())
    mag = tfa.flash_bwd_magnitudes(*args, **kw)
    for name in ("dk", "dv", "dq"):
        diff = (got[name] - want[name]).abs()
        assert float(diff.max()) > 0
        assert (diff <= kernel_support.grad_wide_tol(mag[name])).all(), name


def test_bwd_magnitudes_sum_and_bound_every_term():
    """flash_bwd_magnitudes against the terms written out: the sum and the
    largest |term| of each gradient element, over the group's q heads."""
    args, kw = _bwd_args(1, 64, 4, 2, 64, "window100", seed=12)
    q, k, v, do = args[:4]
    p, ds = tfa._bwd_probs(*args, **kw, p_bf16=True)
    kx = tfa._expand(k, 2)
    terms = {  # [bh, row, term, hd]
        "dq": ds.abs()[..., None] * kx.abs()[:, None],
        "dv": p.transpose(1, 2).abs()[..., None] * do.abs()[:, None],
        "dk": ds.transpose(1, 2).abs()[..., None] * q.abs()[:, None],
    }
    mag = tfa.flash_bwd_magnitudes(*args, **kw)
    for name, x in terms.items():
        if name != "dq":  # the group's heads are terms of one kv head's sum
            x = x.reshape(2, 2, *x.shape[1:]).transpose(1, 2).flatten(2, 3)
        total, largest = mag[name]
        torch.testing.assert_close(total, x.sum(2), atol=1e-5, rtol=1e-5)
        # dS's noise may stand in for a dS smaller than it (row 0)
        assert (largest >= x.amax(2)).all()
        assert float((largest - x.amax(2)).abs().sum()) > 0 if name == "dq" \
            else torch.equal(largest, x.amax(2))


@pytest.mark.parametrize("mode", list(MODES))
def test_bf16_grad_check_passes_another_order_and_flags_truncation(mode):
    """The gradients' check against what a sound kernel can differ by: p
    and dS from float64 scores and dP, rounded to bf16, summed in float64
    (another order, another last bit before rounding) pass it; dS cut to
    bf16 instead of rounded fails it in most rows."""
    args, kw = _bwd_args(1, 256, 8, 2, 128, mode, seed=13)
    want, want16 = _bwd_grads(args, kw), _bwd_grads(args, kw, p_bf16=True)
    mag = tfa.flash_bwd_magnitudes(*args, **kw)
    q, k, v, do, lse, delta = (x.double() for x in args)
    kx, vx = tfa._expand(k, 4), tfa._expand(v, 4)
    p = torch.exp(tfa._scores(q, kx, **kw) - lse)
    ds = p * (do @ vx.transpose(1, 2) - delta) * kw["scale"]

    def as_bf16(x, cut=False):
        x = x.float()
        if cut:
            x = (x.view(torch.int32) & ~0xFFFF).view(torch.float32)
        return x.bfloat16().double()

    def grads(p16, ds16):
        return {"dq": (ds16 @ kx).float(),
                "dk": tfa._group_sum(ds16.transpose(1, 2) @ q, k, 4).float(),
                "dv": tfa._group_sum(p16.transpose(1, 2) @ do, k, 4).float()}

    sound = grads(as_bf16(p), as_bf16(ds))
    cut = grads(as_bf16(p), as_bf16(ds, cut=True))
    check = kernel_support.bf16_grad_mismatch
    for name in ("dk", "dv", "dq"):
        assert check(sound[name], want16[name], want[name], mag[name]) is None
    for name in ("dk", "dq"):
        assert "rows" in check(cut[name], want16[name], want[name], mag[name])
        rows = kernel_support.off_grad_tight(cut[name], want16[name],
                                             mag[name])[1]
        assert rows > cut[name][..., 0].numel() // 2


def test_bf16_grad_check_allows_isolated_flips_only():
    """The gradients' check: within GRAD_TIGHT of the p_bf16 plain version
    but for at most FLIP_ROWS rows, every element within GRAD_WIDE of the
    f32 one."""
    rng = np.random.default_rng(14)
    g_r = torch.from_numpy(rng.standard_normal((4, 64, 64)).astype(np.float32))
    total = torch.full_like(g_r, 8.0)
    largest = torch.full_like(g_r, 0.5)
    mag = (total, largest)
    tight = kernel_support.grad_tight_tol(mag)
    assert torch.allclose(tight, torch.tensor(1e-7 + 8 * 2.0 ** -14
                                              + 0.5 * 2.0 ** -7))
    g_p = g_r + 0.01                     # within 2^-8 * 8 of g_r
    check = kernel_support.bf16_grad_mismatch
    assert check(g_p + 0.5 * tight, g_p, g_r, mag) is None
    flips = g_p.clone()
    flips[0, :kernel_support.FLIP_ROWS] += 2 * tight[0, 0, 0]
    assert kernel_support.off_grad_tight(flips, g_p, mag)[1] == \
        kernel_support.FLIP_ROWS
    assert check(flips, g_p, g_r, mag) is None
    flips[1, 0] += 2 * tight[0, 0, 0]    # one row more than allowed
    assert "5 rows" in check(flips, g_p, g_r, mag)
    biased = g_p.clone()
    biased[:, :, :8] += 2 * tight[0, 0, 0]   # a systematic fault
    assert "p_bf16 plain version" in check(biased, g_p, g_r, mag)
    far = g_p.clone()
    far[0, 0, 0] += 0.05                 # past the f32 version's bound
    assert "f32 plain version" in check(far, g_p, g_r, mag)


def test_lse_cotangent_folds_into_delta():
    """``return_lse`` with a nonzero lse cotangent: the port's autograd
    entry against the reference kernel's vjp (``_flash_lse_bwd``)."""
    b, s, hq, hkv, hd = 1, 256, 4, 2, 64
    q, k, v, do = _inputs(b, s, hq, hkv, hd, seed=7)
    dlse = np.random.default_rng(8).standard_normal((b, hq, s)).astype(np.float32)

    def jfn(q, k, v):
        return jfa.flash_attention(q, k, v, block_q=128, block_k=128,
                                   block_q_bwd=128, block_k_bwd=128,
                                   interpret=True, return_lse=True)

    _, vjp = jax.vjp(jfn, *(jnp.asarray(x) for x in (q, k, v)))
    want = vjp((jnp.asarray(do), jnp.asarray(dlse)))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    o, lse = tfa.flash_attention(tq, tk, tv, return_lse=True)
    got = torch.autograd.grad((o, lse), (tq, tk, tv),
                              (torch.from_numpy(do), torch.from_numpy(dlse)))
    for g, w in zip(got, want):
        _close(g, w)


def _mha_grads(q, k, v, do, **kw):
    out = tattn.mha_reference(q, k, v, **kw)
    return out, torch.autograd.grad(out, (q, k, v), do)


@pytest.mark.parametrize("mode", list(MODES))
def test_autograd_entry_matches_mha_reference_autograd(mode):
    causal, window = MODES[mode]
    q, k, v, do = _inputs(2, 128, 8, 2, 64, seed=3)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    tdo = torch.from_numpy(do)
    o = tfa.flash_attention(tq, tk, tv, causal=causal, window=window)
    grads = torch.autograd.grad(o, (tq, tk, tv), tdo)
    want_o, want = _mha_grads(tq, tk, tv, tdo, causal=causal, window=window)
    torch.testing.assert_close(o, want_o, atol=1e-5, rtol=0)
    for g, w in zip(grads, want):
        torch.testing.assert_close(g, w, atol=1e-5, rtol=0)


def test_mha_reference_matches_the_reference():
    q, k, v, _ = _inputs(2, 96, 8, 2, 64, seed=4)
    for causal, window in MODES.values():
        want = jmha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                    causal=causal, window=window)
        got = tattn.attention(*(torch.from_numpy(x) for x in (q, k, v)),
                              causal=causal, window=window)
        _close(got, want, atol=1e-5)


def test_cpu_dispatch_takes_mha_reference_uncounted():
    kernel_support.reset_launch_counts()
    q, k, v, _ = _inputs(1, 128, 4, 2, 64, seed=5)
    tattn.attention(*(torch.from_numpy(x) for x in (q, k, v)))
    assert kernel_support.launch_counts() == {}


@pytest.mark.parametrize("shape", [
    (1, 256, 4, 2, 64), (2, 128, 8, 8, 128),   # accepted by both
    (1, 200, 4, 2, 64), (1, 64, 4, 2, 64),     # S not a multiple of 128
    (1, 256, 4, 2, 32), (1, 256, 6, 4, 64),    # head dim, partial groups
    (1, 192, 4, 2, 64),                        # S a multiple of 64 only
])
def test_gate_accepts_what_the_reference_accepts(shape):
    """Every shape the reference's gate takes passes the port's; the
    port's own tiles also take S a multiple of 64."""
    b, s, hq, hkv, hd = shape
    q, k, v, _ = _inputs(b, s, hq, hkv, hd, seed=6)
    want = jfa.supports(*(jnp.asarray(x) for x in (q, k, v)))
    got = tfa.supports(*(torch.from_numpy(x) for x in (q, k, v)))
    assert got or not want
    assert got == (s % tfa.TILE == 0 and hd in (64, 128) and hq % hkv == 0)
    bf = [torch.from_numpy(x).bfloat16() for x in (q, k, v)]
    assert tfa.supports(*bf) == got
    assert not tfa.supports(bf[0].half(), bf[1].half(), bf[2].half())


@pytest.mark.parametrize("change,why", [
    (dict(), None), (dict(seq_len=192), None),
    (dict(seq_len=1000), "seq_len=1000"), (dict(seq_len=0), "seq_len=0"),
    (dict(head_dim=16), "head_dim=16"), (dict(n_heads=6), "n_heads=6"),
    (dict(dtype=torch.float16), "dtype"),
])
def test_shape_refusal_names_what_the_kernels_do_not_take(change, why):
    geometry = {**dict(seq_len=2048, n_heads=32, n_kv_heads=8, head_dim=128,
                       dtype=torch.bfloat16), **change}
    got = tfa.shape_refusal(**geometry)
    assert got is None if why is None else why in got


def test_entry_refuses_what_the_tiles_do_not_divide():
    q, k, v, _ = _inputs(1, 100, 4, 2, 64, seed=9)
    with pytest.raises(ValueError, match="multiple of"):
        tfa.flash_attention(*(torch.from_numpy(x) for x in (q, k, v)))
    with pytest.raises(ValueError, match="causal"):
        tfa.flash_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                            causal=False, window=8)


@pytest.mark.parametrize("policy,forwards", [("save_dots_attn", 1),
                                             ("save_dots", 2)])
def test_remat_policy_saves_the_flash_output(monkeypatch, policy, forwards):
    """Under ``save_dots_attn`` the backward reuses the saved flash
    outputs (one forward); under ``save_dots`` it runs the forward again."""
    calls = []
    plain = tfa.flash_fwd_reference

    def counted(*a, **kw):
        calls.append(1)
        return plain(*a, **kw)

    monkeypatch.setattr(tfa, "flash_fwd_reference", counted)
    q, k, v, _ = _inputs(1, 128, 4, 2, 64, seed=10)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    w = torch.randn(256, 256, generator=torch.Generator().manual_seed(0))

    def block(q, k, v):
        return (tfa.flash_attention(q * 2, k, v).reshape(1, 128, 256) @ w).sin()

    out = checkpoint(block, tq, tk, tv, use_reentrant=False,
                     context_fn=tllama._remat_context_fn(policy))
    grads = torch.autograd.grad(out.sum(), (tq, tk, tv))
    assert len(calls) == forwards
    plain_grads = torch.autograd.grad(block(tq, tk, tv).sum(), (tq, tk, tv))
    for g, w_ in zip(grads, plain_grads):
        assert torch.equal(g, w_)


def _tool(name):
    """A module of ``tools/`` (its functions that need a card are not run)."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "tools" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_train_profile_books_every_flash_kernel():
    """The train-step profile counts each engine of K2, K3 and K4 as flash
    time, and nothing else."""
    flash = _tool("torch_train_profile").FLASH
    for kernel in ("flash_fwd_kernel", "flash_fwd_tc_kernel",
                   "flash_bwd_dkv_kernel", "flash_bwd_dkv_tc_kernel",
                   "flash_bwd_dq_kernel", "flash_bwd_dq_tc_kernel"):
        assert flash.search(f"void (anonymous namespace)::{kernel}<128>(int)")
    for other in ("void (anonymous namespace)::rpa_tc_kernel<float>()",
                  "sm90_xmma_gemm_bf16bf16_bf16f32", "elementwise_kernel"):
        assert not flash.search(other)


def test_planted_faults_and_variants_edit_the_sources_once():
    """Every edit of the fault tool and of the producer A/B tool finds its
    text exactly once in the kernel sources, as their builds require."""
    fault = _tool("torch_flash_fault")
    edits = {name: e for name, (_, e) in fault.FAULTS.items()}
    ab = _tool("torch_flash_producer_ab")
    edits.update({name: ab.variant_edits(n) for name, n in ab.VARIANTS.items()})
    assert {"ds_truncated", "drop_group_head"} <= set(edits)
    for name, changes in edits.items():
        for path, old, _ in changes:
            text = (kernel_support.CSRC_DIR / path).read_text()
            assert text.count(old) == 1, (name, path, old[:60])
