"""The port's fused lm_head + cross-entropy (``ops/fused_ce.py``) against
the JAX reference's (``k8s_gpu_device_plugin_tpu/ops/fused_ce.py``).

On the CPU the chunk passes take their plain versions (K6's and K7's
arithmetic in PyTorch). Inputs are numpy arrays from a seed, handed to
both. Tolerances: f32 loss, dx and dw atol 1e-5 (the same f32 sums in
another order); bf16 the reference test's own bounds
(``tests/test_fused_ce.py``: loss atol/rtol 2e-3, each gradient within 5%
relative L2 of the unfused path), here against the reference's fused
loss.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_gpu_device_plugin_tpu.models import llama as jllama
from k8s_gpu_device_plugin_tpu.models import train as jtrain
from k8s_gpu_device_plugin_tpu.ops import fused_ce as jce
from k8s_gpu_device_plugin_torch.models import llama as tllama
from k8s_gpu_device_plugin_torch.models import train as ttrain
from k8s_gpu_device_plugin_torch.models.convert import params_from_jax
from k8s_gpu_device_plugin_torch.ops import fused_ce as tce

# one intra-op thread a worker: the suite runs in several processes
torch.set_num_threads(1)


def _inputs(vocab, seed=0, b=2, s=16, d=64):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, d)).astype(np.float32)
    w = (rng.standard_normal((d, vocab)) * 0.1).astype(np.float32)
    t = rng.integers(0, vocab, (b, s)).astype(np.int32)
    return x, w, t


def _port(x, w, t, chunk, dtype):
    xt = torch.from_numpy(x).to(dtype).requires_grad_()
    wt = torch.from_numpy(w).to(dtype).requires_grad_()
    loss = tce.fused_linear_cross_entropy(xt, wt, torch.from_numpy(t),
                                          chunk=chunk)
    dx, dw = torch.autograd.grad(loss, (xt, wt))
    return float(loss.detach()), dx.float().numpy(), dw.float().numpy()


def _reference(x, w, t, chunk, dtype):
    xj, wj = jnp.asarray(x, dtype), jnp.asarray(w, dtype)
    fn = lambda a, b: jce.fused_linear_cross_entropy(  # noqa: E731
        a, b, jnp.asarray(t), chunk=chunk)
    loss, (dx, dw) = jax.value_and_grad(fn, argnums=(0, 1))(xj, wj)
    return (float(loss), np.asarray(dx.astype(jnp.float32)),
            np.asarray(dw.astype(jnp.float32)))


@pytest.mark.parametrize("vocab,chunk", [(512, 128), (500, 128), (512, 512)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_matches_reference_loss_and_grads(vocab, chunk, dtype):
    x, w, t = _inputs(vocab)
    got = _port(x, w, t, chunk, getattr(torch, dtype))
    want = _reference(x, w, t, chunk, getattr(jnp, dtype))
    if dtype == "float32":
        np.testing.assert_allclose(got[0], want[0], atol=1e-5, rtol=0)
        for g, r in zip(got[1:], want[1:]):
            np.testing.assert_allclose(g, r, atol=1e-5, rtol=0)
        return
    np.testing.assert_allclose(got[0], want[0], atol=2e-3, rtol=2e-3)
    for g, r in zip(got[1:], want[1:]):
        assert np.linalg.norm(g - r) / (np.linalg.norm(r) + 1e-12) < 0.05


def test_pad_chunks_and_bounds():
    for vocab, chunk, want in ((32000, 4096, (8, 8 * 4096)),
                               (4096, 4096, (1, 4096)),
                               (50257, 4096, (13, 13 * 4096)),
                               (7, 4096, (1, 7)), (128256, 4096, (32, 131072))):
        assert tce._pad_chunks(vocab, chunk) == jce._pad_chunks(vocab, chunk)
        assert tce._pad_chunks(vocab, chunk) == want
        bounds = tce.chunk_bounds(vocab, chunk)
        assert len(bounds) == want[0] and bounds[-1][1] == vocab
        assert all(a1 == b0 for (_, a1), (b0, _) in zip(bounds, bounds[1:]))
    assert tce.chunk_bounds(128256, 4096)[-1] == (126976, 128256)  # 1280 wide


def test_chunk_passes_against_their_definitions():
    """K6's plain version folds chunks into the logsumexp of the whole
    row and finds each target; K7's is the cross-entropy's cotangent."""
    rng = np.random.default_rng(3)
    n, v, chunk = 6, 50, 16
    logits = torch.from_numpy(rng.standard_normal((n, v)).astype(np.float32) * 3)
    t = torch.from_numpy(rng.integers(0, v, n))
    m = torch.full((n,), float("-inf"))
    s, tl = torch.zeros(n), torch.zeros(n)
    for c0, c1 in tce.chunk_bounds(v, chunk):
        tce.ce_chunk_fwd(logits[:, c0:c1].contiguous(), t, c0, m, s, tl)
    lse = m + torch.log(s)
    torch.testing.assert_close(lse, torch.logsumexp(logits, -1), atol=1e-6,
                               rtol=0)
    assert torch.equal(tl, logits[torch.arange(n), t])
    g = torch.tensor(2.0)
    z = 1e-4
    want = torch.func.grad(lambda l: g * ((torch.logsumexp(l, -1) - l[
        torch.arange(n), t]) + z * torch.logsumexp(l, -1) ** 2).mean())(logits)
    got = torch.cat([tce.ce_chunk_bwd(logits[:, c0:c1].contiguous(), t, c0,
                                      lse, g, z, torch.float32)
                     for c0, c1 in tce.chunk_bounds(v, chunk)], dim=1)
    torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-5)


DIMS = dict(d_model=256, n_heads=4, n_kv_heads=2)


def _batch(vocab, seed=1, b=2, s=32):
    t = np.random.default_rng(seed).integers(0, vocab, (b, s + 1),
                                             dtype=np.int32)
    return {"inputs": t[:, :-1], "targets": t[:, 1:]}


@pytest.mark.parametrize("moe", [False, True], ids=["dense", "moe"])
def test_loss_fn_fused_matches_reference_and_unfused(moe):
    """``loss_fn`` with ``fused_ce`` and no accuracy: the fused path,
    accuracy -1, the loss and a MoE's router losses equal the reference's
    fused ``loss_fn`` (f32 atol 1e-5) and the port's unfused path; with
    accuracy asked for it falls back to the unfused path."""
    extra = dict(n_experts=4) if moe else {}
    jcfg = jllama.LlamaConfig.tiny(dtype=jnp.float32, fused_ce=True, **DIMS,
                                   **extra)
    tcfg = tllama.LlamaConfig.tiny(dtype=torch.float32, fused_ce=True, **DIMS,
                                   **extra)
    np_params = jax.tree.map(np.asarray,
                             jllama.init_params(jax.random.key(0), jcfg))
    params = params_from_jax(np_params, tcfg, device="cpu")
    batch = _batch(tcfg.vocab_size)
    tbatch = {k: torch.from_numpy(v).long() for k, v in batch.items()}
    jloss, jm = jtrain.loss_fn(jax.tree.map(jnp.asarray, np_params),
                               {k: jnp.asarray(v) for k, v in batch.items()},
                               jcfg, None, with_accuracy=False)
    loss, m = ttrain.loss_fn(params, tbatch, tcfg, with_accuracy=False)
    assert float(m["accuracy"]) == -1.0 == float(jm["accuracy"])
    np.testing.assert_allclose(float(loss), float(jloss), atol=1e-5, rtol=0)
    for name in ("loss", *(("moe_load_balance", "moe_router_z") if moe
                           else ())):
        np.testing.assert_allclose(float(m[name]), float(jm[name]),
                                   atol=1e-5, rtol=0)
    unfused = dataclasses.replace(tcfg, fused_ce=False)
    loss_u, _ = ttrain.loss_fn(params, tbatch, unfused, with_accuracy=False)
    np.testing.assert_allclose(float(loss), float(loss_u), atol=1e-5, rtol=0)
    loss_a, m_a = ttrain.loss_fn(params, tbatch, tcfg, with_accuracy=True)
    assert float(m_a["accuracy"]) >= 0.0
    assert float(loss_a) == float(loss_u)


def test_fused_grads_match_unfused_through_the_model():
    """The fused path's parameter gradients equal the unfused path's
    through the whole tiny f32 model (atol 1e-5), and the eval step stays
    unfused (it reports an accuracy)."""
    cfg = tllama.LlamaConfig.tiny(dtype=torch.float32, fused_ce=True, **DIMS)
    params = tllama.init_params(cfg, seed=0, device="cpu")
    batch = {k: torch.from_numpy(v).long()
             for k, v in _batch(cfg.vocab_size, seed=4).items()}
    got, _ = ttrain._grads(params, batch, cfg, with_accuracy=False)
    want, _ = ttrain._grads(params, batch,
                            dataclasses.replace(cfg, fused_ce=False),
                            with_accuracy=False)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=1e-5, rtol=0)
    ev = ttrain.make_eval_step(cfg)(params, batch)
    assert float(ev["accuracy"]) >= 0.0
