"""The port's int8 training products (``ops/quant.py``: ``int8_matmul``,
``int8_expert_matmul``, ``bf16_ste_bwd``) and ``quant="int8"`` training
against the JAX reference's, plus the serving refusals an int8 config
meets.

Inputs are numpy arrays from a seed, handed to both. Codes and scales
are held bit for bit; the products' outputs and straight-through
gradients at f32 atol 1e-6 plus rtol 1e-6 (the same int32 sums and f32
rescale; the gradients are the same f32 products summed in another
order). The tiny f32 model's three int8 steps: the first step's loss,
accuracy and ``grad_norm`` at ``test_torch_train.py``'s tolerances (the
same codes); every step's loss atol 5e-4 and ``grad_norm`` rtol 1e-3,
because the two frameworks' f32 activations differ in their last bits
(norm statistics, rope, softmax sums) and an int8 code whose input lies
within that of a rounding boundary rounds the other way, moving its
product by one step of the row's amax / 127 (a few codes a forward at
these shapes, about 1e-5 of the loss each: 5.6e-5 seen at step 2);
parameters atol 1e-4 at a learning rate of 1e-5 (Adam moves an element
by about the learning rate whatever its gradient's size, so a flipped
small gradient moves it the other way).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_gpu_device_plugin_tpu.models import llama as jllama
from k8s_gpu_device_plugin_tpu.models import train as jtrain
from k8s_gpu_device_plugin_tpu.ops import quant as jquant
from k8s_gpu_device_plugin_tpu.parallel.mesh import MeshSpec, make_mesh
from k8s_gpu_device_plugin_torch.models import beam as tbeam
from k8s_gpu_device_plugin_torch.models import generate as tgenerate
from k8s_gpu_device_plugin_torch.models import llama as tllama
from k8s_gpu_device_plugin_torch.models import rolling as trolling
from k8s_gpu_device_plugin_torch.models import speculative as tspec
from k8s_gpu_device_plugin_torch.models import train as ttrain
from k8s_gpu_device_plugin_torch.models.convert import (
    params_from_jax,
    params_to_numpy,
)
from k8s_gpu_device_plugin_torch.ops import quant as tquant

# one intra-op thread a worker: the suite runs in several processes
torch.set_num_threads(1)


def _rand(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


@pytest.mark.parametrize("shape,axis", [((3, 5, 64), -1), ((64, 24), 0),
                                        ((4, 32, 24), 1)])
def test_codes_and_scales_equal_reference(shape, axis):
    x = _rand(np.random.default_rng(0), shape)
    qj, sj = jquant.quantize_int8(jnp.asarray(x), axis=axis)
    qt, st = tquant.quantize_int8(torch.from_numpy(x), axis=axis)
    assert np.array_equal(qt.numpy(), np.asarray(qj))
    assert np.array_equal(st.numpy().view(np.uint32),
                          np.asarray(sj).view(np.uint32))


def _grads_both(jfn, tfn, x, w, g):
    jout, vjp = jax.vjp(jfn, jnp.asarray(x), jnp.asarray(w))
    jdx, jdw = vjp(jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    tout = tfn(xt, wt)
    tdx, tdw = torch.autograd.grad(tout, (xt, wt), torch.from_numpy(g))
    return ((tout.detach().numpy(), tdx.numpy(), tdw.numpy()),
            (np.asarray(jout), np.asarray(jdx), np.asarray(jdw)))


def test_int8_matmul_and_its_straight_through_grads():
    rng = np.random.default_rng(1)
    x, w, g = _rand(rng, (2, 9, 64)), _rand(rng, (64, 48), 0.1), \
        _rand(rng, (2, 9, 48))
    got, want = _grads_both(jquant.int8_matmul, tquant.int8_matmul, x, w, g)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, atol=1e-6, rtol=1e-6)
    # straight through: the gradients are the float product's
    dx, dw = tquant.bf16_ste_bwd(torch.from_numpy(x), torch.from_numpy(w),
                                 torch.from_numpy(g))
    np.testing.assert_allclose(got[1], dx.numpy(), atol=0, rtol=0)
    np.testing.assert_allclose(got[2], dw.numpy(), atol=0, rtol=0)


def test_int8_expert_matmul_and_its_grads():
    rng = np.random.default_rng(2)
    x, w, g = _rand(rng, (4, 10, 32)), _rand(rng, (4, 32, 24), 0.1), \
        _rand(rng, (4, 10, 24))
    got, want = _grads_both(jquant.int8_expert_matmul,
                            tquant.int8_expert_matmul, x, w, g)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, atol=1e-6, rtol=1e-6)


def test_int_mm_limits_are_refused_by_name():
    assert tquant.int8_mm_refusal(4096, 4096, 14336) is None
    assert "exceed 16" in tquant.int8_mm_refusal(16, 64, 64)
    assert "multiples of 8" in tquant.int8_mm_refusal(32, 60, 64)
    assert "multiples of 8" in tquant.int8_mm_refusal(32, 64, 4)


DIMS = dict(d_model=256, n_heads=4, n_kv_heads=2)
OPT = dict(learning_rate=1e-5, warmup_steps=2, total_steps=10)
B, S = 4, 32


def test_int8_train_steps_match_reference():
    """Three ``quant="int8"`` steps of the tiny f32 model against the
    reference's at the tolerances above; the parameters move."""
    jcfg = jllama.LlamaConfig.tiny(dtype=jnp.float32, quant="int8", **DIMS)
    tcfg = tllama.LlamaConfig.tiny(dtype=torch.float32, quant="int8", **DIMS)
    np_params = jax.tree.map(np.asarray,
                             jllama.init_params(jax.random.key(0), jcfg))
    mesh = make_mesh(MeshSpec(), jax.devices()[:1])
    jopt = jtrain.make_optimizer(**OPT)
    jstep = jtrain.make_train_step(jcfg, mesh, jopt)
    jparams = jax.tree.map(jnp.asarray, np_params)
    jstate = {"params": jparams, "opt_state": jopt.init(jparams),
              "step": jnp.zeros((), jnp.int32)}
    topt = ttrain.make_optimizer(**OPT)
    tstate = ttrain.init_train_state(
        tcfg, topt, params=params_from_jax(np_params, tcfg, device="cpu"))
    tstep = ttrain.make_train_step(tcfg, topt)
    rng = np.random.default_rng(2)
    for step in range(3):
        t = rng.integers(0, jcfg.vocab_size, (B, S + 1), dtype=np.int32)
        batch = {"inputs": t[:, :-1], "targets": t[:, 1:]}
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        tstate, tm = tstep(tstate, {k: torch.from_numpy(v).long()
                                    for k, v in batch.items()})
        first = step == 0
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   atol=1e-5 if first else 5e-4, rtol=0)
        if first:
            np.testing.assert_allclose(float(tm["accuracy"]),
                                       float(jm["accuracy"]), atol=1e-6)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]),
                                   rtol=1e-5 if first else 1e-3)
    got = params_to_numpy(tstate["params"])
    want = jax.tree.map(np.asarray, jstate["params"])
    assert np.abs(got["layers"]["wq"] - np_params["layers"]["wq"]).max() > 5e-6
    for (path, a), (_, b) in zip(jax.tree_util.tree_leaves_with_path(got),
                                 jax.tree_util.tree_leaves_with_path(want)):
        np.testing.assert_allclose(a, b, atol=1e-4, rtol=0, err_msg=str(path))


@pytest.mark.parametrize("policy,moe", [("save_dots", False),
                                        ("save_dots_attn", True)])
def test_backward_reruns_no_quantized_product(monkeypatch, policy, moe):
    """Under a saving remat policy the int8 products' outputs are saved:
    the backward recomputes the block but runs no quantization and no
    int8 product again (the count after the backward is the forward's),
    and its gradients equal ``remat=False``'s bit for bit."""
    calls = []
    product = tquant._int_product

    def counting(qx, qw):
        calls.append(qx.shape)
        return product(qx, qw)

    monkeypatch.setattr(tquant, "_int_product", counting)
    extra = dict(n_experts=4) if moe else {}
    cfg = tllama.LlamaConfig.tiny(dtype=torch.float32, quant="int8",
                                  remat=True, remat_policy=policy, **DIMS,
                                  **extra)
    params = tllama.init_params(cfg, seed=0, device="cpu")
    t = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (2, 33)))
    batch = {"inputs": t[:, :-1], "targets": t[:, 1:]}
    got, _ = ttrain._grads(params, batch, cfg)
    # 7 projections a dense block; a MoE block's 4 attention projections
    # and 3 expert products of 4 experts each
    per_layer = 4 + 3 * 4 if moe else 7
    assert len(calls) == per_layer * cfg.n_layers
    calls.clear()
    want, _ = ttrain._grads(params, batch,
                            dataclasses.replace(cfg, remat=False))
    assert len(calls) == per_layer * cfg.n_layers
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_an_int8_config_is_refused_by_the_decode_paths():
    cfg = tllama.LlamaConfig.tiny(dtype=torch.float32, quant="int8",
                                  sliding_window=8)
    params = tllama.init_params(cfg, seed=0, device="cpu")
    prompt = torch.tensor([[1, 2, 3]])
    bf16_only = "decode path is bf16-only"
    with pytest.raises(NotImplementedError, match=bf16_only):
        tgenerate.generate(params, prompt, cfg, 4)
    with pytest.raises(NotImplementedError, match=bf16_only):
        tbeam.beam_search(params, prompt, cfg, 4, beam=2)
    with pytest.raises(NotImplementedError, match=bf16_only):
        trolling.rolling_generate(params, prompt, cfg, 4)
    with pytest.raises(NotImplementedError,
                       match="speculative decode is bf16-only"):
        tspec.speculative_generate(params, cfg, params, cfg, prompt, 4)
    with pytest.raises(ValueError, match="'none' or 'int8'"):
        tllama.LlamaConfig.tiny(quant="int4")
