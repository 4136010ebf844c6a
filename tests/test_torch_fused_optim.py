"""The port's fused AdamW (``ops/fused_optim.py``) against the JAX
reference's (``k8s_gpu_device_plugin_tpu/ops/fused_optim.py``).

On the CPU ``FusedAdamW.update`` takes the plain version, the kernels'
arithmetic in PyTorch. Inputs are numpy arrays from a seed, handed to
both. Tolerances: f32 atol 1e-6 (the same f32 operations; XLA may fuse a
multiply and an add where PyTorch rounds both), bf16 within one bf16 ulp
of the reference's value (a value within that f32 difference of a bf16
rounding boundary rounds the other way), ``grad_norm`` rtol 1e-6
(summation order). The port takes the global norm in f32 whatever the
grads' dtype, where the reference's ``optax.global_norm`` sums bf16 grads
in bf16: the reference gets the same grad values widened to f32, which
changes nothing else of its update (it widens each grad to f32 first).
The train step with ``impl="fused"`` is held to the reference's at
``test_torch_train.py``'s tolerances.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_gpu_device_plugin_tpu.models import llama as jllama
from k8s_gpu_device_plugin_tpu.models import train as jtrain
from k8s_gpu_device_plugin_tpu.ops import fused_optim as jfused
from k8s_gpu_device_plugin_tpu.parallel.mesh import MeshSpec, make_mesh
from k8s_gpu_device_plugin_torch.models import llama as tllama
from k8s_gpu_device_plugin_torch.models import train as ttrain
from k8s_gpu_device_plugin_torch.models import trainer as ttrainer
from k8s_gpu_device_plugin_torch.models.convert import (
    params_from_jax,
    params_to_numpy,
)
from k8s_gpu_device_plugin_torch.ops import fused_optim as tfused

# one intra-op thread a worker: the suite runs in several processes
torch.set_num_threads(1)

SHAPES = {"a": (7, 33), "b": (129,), "c": (4, 8, 16)}
HYPER = dict(b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1)
SCHEDULE = ttrain.warmup_cosine_decay_schedule(0.0, 1e-2, 2, 10)


def _bf16_ulp(x: np.ndarray) -> np.ndarray:
    """The spacing of bf16 values at |x| (8 significant bits)."""
    mag = np.maximum(np.abs(x), np.finfo(np.float32).tiny)
    return 2.0 ** (np.floor(np.log2(mag)) - 7)


def _close(got: torch.Tensor, want, dtype) -> None:
    got = got.float().numpy()
    want = np.asarray(jnp.asarray(want, jnp.float32))
    if dtype == torch.float32:
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    else:
        assert (np.abs(got - want) <= _bf16_ulp(want)).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("clip", [1e-2, 1e3], ids=["clipped", "unclipped"])
def test_fused_update_matches_reference(dtype, clip):
    tdtype, jdtype = getattr(torch, dtype), getattr(jnp, dtype)
    rng = np.random.default_rng(0)
    p0 = {k: rng.standard_normal(s).astype(np.float32) for k, s in
          SHAPES.items()}
    jparams = {k: jnp.asarray(v, jdtype) for k, v in p0.items()}
    jmu = {k: jnp.zeros_like(v) for k, v in jparams.items()}
    jnu = {k: jnp.zeros_like(v) for k, v in jparams.items()}
    jcount = jnp.zeros((), jnp.int32)
    opt = tfused.FusedAdamW(SCHEDULE, clip=clip, **HYPER)
    tparams = [torch.from_numpy(p0[k]).to(tdtype) for k in SHAPES]
    state = opt.init(tparams)
    for step in range(4):
        g = {k: (rng.standard_normal(s) * 0.1).astype(np.float32)
             for k, s in SHAPES.items()}
        lr = SCHEDULE(step)
        jparams, jmu, jnu, jcount = jfused.fused_adamw_update(
            jparams, {k: jnp.asarray(v, jdtype).astype(jnp.float32)
                      for k, v in g.items()},
            jmu, jnu, jcount, lr=lr, clip=clip, **HYPER)
        norm = opt.update([torch.from_numpy(g[k]).to(tdtype) for k in SHAPES],
                          state, tparams)
        want_norm = float(jnp.sqrt(sum(
            jnp.sum(jnp.square(jnp.asarray(v, jdtype).astype(jnp.float32)))
            for v in g.values())))
        np.testing.assert_allclose(float(norm), want_norm, rtol=1e-6)
        assert state["count"] == int(jcount) == step + 1
        for i, k in enumerate(SHAPES):
            _close(tparams[i], jparams[k], tdtype)
            _close(state["mu"][i], jmu[k], tdtype)
            _close(state["nu"][i], jnu[k], tdtype)
        assert all(t.dtype == tdtype for t in
                   tparams + state["mu"] + state["nu"])


def test_plain_version_takes_a_given_scale_and_free_step():
    """``fused_adamw_update`` with the scale the norm gives equals it
    without; ``fused_adamw_step`` is ``update``; the first update has
    learning rate 0."""
    rng = np.random.default_rng(1)
    make = lambda: [torch.from_numpy(rng.standard_normal((5, 8)).astype(
        np.float32)) for _ in range(2)]  # noqa: E731
    params, grads = make(), make()
    copies = [p.clone() for p in params]
    opt = tfused.FusedAdamW(SCHEDULE, clip=0.5, **HYPER)
    state = opt.init(params)
    norm = tfused.fused_adamw_step(opt, params, grads, state)
    assert all(torch.equal(p, c) for p, c in zip(params, copies))  # lr 0
    mu, nu = [torch.zeros_like(p) for p in copies], [
        torch.zeros_like(p) for p in copies]
    scale = tfused.clip_scale(tfused.global_norm(grads), 0.5)
    again = tfused.fused_adamw_update(copies, grads, mu, nu, 0, lr=0.0,
                                      clip=0.5, scale=scale, **HYPER)
    assert torch.equal(norm, again)
    assert all(torch.equal(a, b) for a, b in zip(mu, state["mu"]))
    assert float(scale) < 1
    assert tfused.launches_per_update(12) == {tfused.NAME: 12,
                                              tfused.NORM_NAME: 13}


DIMS = dict(d_model=256, n_heads=4, n_kv_heads=2)
OPT = dict(learning_rate=1e-3, warmup_steps=2, total_steps=10)
B, S = 4, 32


def _batches(n, vocab, seed):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        t = rng.integers(0, vocab, (B, S + 1), dtype=np.int32)
        out.append({"inputs": t[:, :-1], "targets": t[:, 1:]})
    return out


def test_fused_train_step_matches_reference():
    """Three steps of the tiny f32 model, the port's ``impl="fused"``
    step against the reference's: loss and accuracy atol 1e-5,
    ``grad_norm`` rtol 1e-5, parameters atol 1e-4 (``test_torch_train``'s
    tolerances)."""
    jcfg = jllama.LlamaConfig.tiny(dtype=jnp.float32, **DIMS)
    tcfg = tllama.LlamaConfig.tiny(dtype=torch.float32, **DIMS)
    np_params = jax.tree.map(np.asarray,
                             jllama.init_params(jax.random.key(0), jcfg))
    mesh = make_mesh(MeshSpec(), jax.devices()[:1])
    jopt = jtrain.make_optimizer(impl="fused", **OPT)
    jstep = jtrain.make_train_step(jcfg, mesh, jopt)
    jparams = jax.tree.map(jnp.asarray, np_params)
    jstate = {"params": jparams, "opt_state": jopt.init(jparams),
              "step": jnp.zeros((), jnp.int32)}
    topt = ttrain.make_optimizer(impl="fused", **OPT)
    assert isinstance(topt, tfused.FusedAdamW)
    tstate = ttrain.init_train_state(
        tcfg, topt, params=params_from_jax(np_params, tcfg, device="cpu"))
    tstep = ttrain.make_train_step(tcfg, topt)
    for batch in _batches(3, jcfg.vocab_size, seed=2):
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        tstate, tm = tstep(tstate, {k: torch.from_numpy(v).long()
                                    for k, v in batch.items()})
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   atol=1e-5, rtol=0)
        np.testing.assert_allclose(float(tm["accuracy"]),
                                   float(jm["accuracy"]), atol=1e-6, rtol=0)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-5)
    got = params_to_numpy(tstate["params"])
    want = jax.tree.map(np.asarray, jstate["params"])
    for (path, x), (_, y) in zip(jax.tree_util.tree_leaves_with_path(got),
                                 jax.tree_util.tree_leaves_with_path(want)):
        np.testing.assert_allclose(x, y, atol=1e-4, rtol=0, err_msg=str(path))
    assert tstate["step"] == tstate["opt_state"]["count"] == 3


class _Preempted(Exception):
    pass


def test_a_torn_fused_update_is_not_saved(tmp_path):
    """An exception inside ``FusedAdamW.update`` after its first leaf
    leaves the update counted and the step not: the trainer's forced save
    on the way out skips that state, and a fresh run resumes from the
    last whole step and ends where an uninterrupted run does."""
    armed = []

    class Tripwire(list):
        def __iter__(self):
            if armed:
                yield from super().__iter__()
                return
            armed.append(True)
            yield self[0]
            raise _Preempted

    def trainer(**kw):
        return ttrainer.Trainer(ttrainer.TrainerConfig(
            seq_len=16, batch_size=2, total_steps=4, device="cpu",
            opt_impl="fused", **kw))

    d = str(tmp_path)
    first = trainer(checkpoint_dir=d, checkpoint_interval=2)

    def arm(step, metrics):
        if step == 3:
            opt = first.state["opt_state"]
            opt["mu"] = Tripwire(opt["mu"])

    with pytest.raises(_Preempted):
        first.run(on_step=arm)
    torn = first.state
    assert (torn["step"], torn["opt_state"]["count"]) == (3, 4)
    assert first.ckpt.all_steps() == [2]
    second = trainer(checkpoint_dir=d, checkpoint_interval=2)
    assert second.run().resumed_from == 2
    straight = trainer()
    straight.run()
    leaves = [ttrain.param_leaves(s["params"]) + s["opt_state"]["mu"]
              + s["opt_state"]["nu"] for s in (straight.state, second.state)]
    assert all(torch.equal(x, y) for x, y in zip(*leaves))


def test_master_weights_fused_keeps_f32_storage():
    cfg = dataclasses.replace(tllama.LlamaConfig.tiny(**DIMS),
                              param_dtype=torch.float32)
    opt = ttrain.make_optimizer(impl="fused", **OPT)
    state = ttrain.init_train_state(cfg, opt, seed=0, device="cpu")
    step = ttrain.make_train_step(cfg, opt)
    for batch in _batches(2, cfg.vocab_size, seed=5):
        state, metrics = step(state, {k: torch.from_numpy(v).long()
                                      for k, v in batch.items()})
        assert np.isfinite(float(metrics["loss"]))
    assert all(p.dtype == torch.float32 for p in
               ttrain.param_leaves(state["params"]) + state["opt_state"]["nu"])


def test_train_profile_books_the_fused_kernels():
    """The train-step profile books K5's three kernels, K6 and K7 as the
    fused ops' time, and neither the flash kernels nor the GEMMs."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "tools/torch_train_profile.py"
    spec = importlib.util.spec_from_file_location("torch_train_profile", path)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    for kernel in ("adamw_sumsq<__nv_bfloat16>", "adamw_finalize",
                   "adamw_update<float>", "ce_chunk_fwd_kernel<true>",
                   "ce_chunk_bwd_kernel<__nv_bfloat16, false>"):
        name = f"void (anonymous namespace)::{kernel}(int)"
        assert tool.FUSED.search(name) and not tool.FLASH.search(name)
    for other in ("void (anonymous namespace)::flash_fwd_tc_kernel<128>()",
                  "sm90_xmma_gemm_bf16bf16_bf16f32", "elementwise_kernel"):
        assert not tool.FUSED.search(other)
