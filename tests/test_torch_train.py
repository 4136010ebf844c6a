"""Parity of the port's training path with the JAX reference.

``LlamaConfig.tiny(dtype=f32, d_model=256, n_heads=4, n_kv_heads=2)``
(hd 64) in both packages; the JAX parameters move across with
``params_from_jax`` and come back with ``params_to_numpy``; the batches
are numpy arrays handed to both. On the CPU both sides attend through
``mha_reference``.

Tolerances: f32 atol 1e-5 for logits and losses (same f32 arithmetic;
summation order and transcendental rounding differ), 1e-4 for the
parameters after the steps (Adam divides each gradient by its own root
mean square: an element whose gradient nearly cancels can move by a
sizeable part of a 1e-3 learning-rate step on a 1e-6 relative gradient
difference), rtol 1e-5 for ``grad_norm``.
Inside the port, the remat policies are held bitwise to ``remat=False``
(the same operations, rescheduled).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_gpu_device_plugin_tpu.models import llama as jllama
from k8s_gpu_device_plugin_tpu.models import train as jtrain
from k8s_gpu_device_plugin_tpu.parallel.mesh import MeshSpec, make_mesh
from k8s_gpu_device_plugin_torch.models import llama as tllama
from k8s_gpu_device_plugin_torch.models import train as ttrain
from k8s_gpu_device_plugin_torch.models.convert import (
    params_from_jax,
    params_to_numpy,
)

# the suite runs in several worker processes on shared cores: one
# intra-op thread each keeps torch's OpenMP pool from spinning against
# them (these shapes gain nothing from more)
torch.set_num_threads(1)

DIMS = dict(d_model=256, n_heads=4, n_kv_heads=2)
OPT = dict(learning_rate=1e-3, warmup_steps=2, total_steps=10)
B, S = 4, 32


@pytest.fixture(scope="module")
def jcfg():
    return jllama.LlamaConfig.tiny(dtype=jnp.float32, **DIMS)


@pytest.fixture(scope="module")
def tcfg():
    return tllama.LlamaConfig.tiny(dtype=torch.float32, **DIMS)


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(MeshSpec(), jax.devices()[:1])


@pytest.fixture(scope="module")
def np_params(jcfg):
    params = jllama.init_params(jax.random.key(0), jcfg)
    return jax.tree.map(np.asarray, params)


def _batches(n, vocab, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        t = rng.integers(0, vocab, (B, S + 1), dtype=np.int32)
        out.append({"inputs": t[:, :-1], "targets": t[:, 1:]})
    return out


def _torch_batch(batch):
    return {k: torch.from_numpy(v).long() for k, v in batch.items()}


def _assert_params_close(got: dict, want: dict, atol=1e-4):
    flat_got = jax.tree_util.tree_leaves_with_path(got)
    flat_want = dict(jax.tree_util.tree_leaves_with_path(want))
    assert len(flat_got) == len(flat_want)
    for path, x in flat_got:
        np.testing.assert_allclose(x, np.asarray(flat_want[path]), atol=atol,
                                   rtol=0, err_msg=str(path))


def test_forward_logits_match_reference(jcfg, tcfg, np_params):
    tokens = _batches(1, jcfg.vocab_size)[0]["inputs"]
    want = jllama.forward(np_params, jnp.asarray(tokens), jcfg)
    got = tllama.forward(params_from_jax(np_params, tcfg, device="cpu"),
                         torch.from_numpy(tokens).long(), tcfg)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-5, rtol=0)


def test_return_hidden_stops_before_the_head(jcfg, tcfg, np_params):
    tokens = _batches(1, jcfg.vocab_size)[0]["inputs"]
    want, _ = jllama.forward_with_aux(np_params, jnp.asarray(tokens), jcfg,
                                      return_hidden=True)
    got, aux = tllama.forward_with_aux(
        params_from_jax(np_params, tcfg, device="cpu"),
        torch.from_numpy(tokens).long(), tcfg, return_hidden=True)
    assert aux == {}
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-5, rtol=0)


@pytest.mark.parametrize("with_accuracy", [True, False])
def test_cross_entropy_matches_reference(with_accuracy):
    rng = np.random.default_rng(1)
    logits = (rng.standard_normal((3, 7, 50)) * 4).astype(np.float32)
    targets = rng.integers(0, 50, (3, 7)).astype(np.int32)
    want = jtrain.cross_entropy(jnp.asarray(logits), jnp.asarray(targets),
                                with_accuracy=with_accuracy)
    got = ttrain.cross_entropy(torch.from_numpy(logits),
                               torch.from_numpy(targets).long(),
                               with_accuracy=with_accuracy)
    for g, w in zip(got, want):
        np.testing.assert_allclose(float(g), float(w), atol=1e-5, rtol=0)


def test_schedule_matches_optax():
    import optax

    for warmup, total in ((2, 10), (0, 5), (100, 20)):
        want = optax.warmup_cosine_decay_schedule(
            0.0, 3e-4, warmup, max(total, warmup + 1))
        got = ttrain.warmup_cosine_decay_schedule(
            0.0, 3e-4, warmup, max(total, warmup + 1))
        for count in range(0, max(total, warmup + 1) + 3):
            # optax evaluates in f32, the port in float64
            np.testing.assert_allclose(got(count), float(want(count)),
                                       rtol=1e-5, atol=1e-12)


def _run_both(jcfg, tcfg, mesh, np_params, n_steps, grad_accum=1):
    """n_steps of the JAX step and the port's step from the same
    parameters and batches: (jax metrics, port metrics, jax params,
    port params) after each step."""
    jopt = jtrain.make_optimizer(**OPT)
    jstep = jtrain.make_train_step(jcfg, mesh, jopt, grad_accum=grad_accum)
    jparams = jax.tree.map(jnp.asarray, np_params)
    jstate = {"params": jparams, "opt_state": jopt.init(jparams),
              "step": jnp.zeros((), jnp.int32)}
    topt = ttrain.make_optimizer(**OPT)
    tstate = ttrain.init_train_state(
        tcfg, topt, params=params_from_jax(np_params, tcfg, device="cpu"))
    tstep = ttrain.make_train_step(tcfg, topt, grad_accum=grad_accum)
    out = []
    for batch in _batches(n_steps, jcfg.vocab_size, seed=2):
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        tstate, tm = tstep(tstate, _torch_batch(batch))
        out.append((jax.device_get(jm), tm,
                    jax.tree.map(np.asarray, jstate["params"]),
                    params_to_numpy(tstate["params"])))
    assert tstate["step"] == n_steps
    return out


def _assert_metrics_close(jm, tm):
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(float(tm["accuracy"]), float(jm["accuracy"]),
                               atol=1e-6, rtol=0)
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]),
                               rtol=1e-5)


@pytest.mark.parametrize("n_steps", [1, 3])
def test_train_steps_match_reference(jcfg, tcfg, mesh, np_params, n_steps):
    runs = _run_both(jcfg, tcfg, mesh, np_params, n_steps)
    for jm, tm, _, _ in runs:
        _assert_metrics_close(jm, tm)
    _, _, jp, tp = runs[-1]
    _assert_params_close(tp, jp)
    if n_steps == 1:
        # the first update has learning rate 0: the weights do not move
        _assert_params_close(tp, np_params, atol=0)
    else:
        moved = np.abs(tp["layers"]["wq"] - np_params["layers"]["wq"]).max()
        assert moved > 5e-4


def test_grad_accum_matches_reference(jcfg, tcfg, mesh, np_params):
    runs = _run_both(jcfg, tcfg, mesh, np_params, 2, grad_accum=2)
    for jm, tm, _, _ in runs:
        _assert_metrics_close(jm, tm)
    _assert_params_close(runs[-1][3], runs[-1][2])


def test_grad_accum_two_equals_one(tcfg, np_params):
    """Two microbatches of 2 rows average to the gradient of 4 rows."""
    results = []
    for ga in (1, 2):
        opt = ttrain.make_optimizer(**OPT)
        state = ttrain.init_train_state(
            tcfg, opt, params=params_from_jax(np_params, tcfg, device="cpu"))
        step = ttrain.make_train_step(tcfg, opt, grad_accum=ga)
        metrics = [step(state, _torch_batch(b))[1]
                   for b in _batches(3, tcfg.vocab_size, seed=3)]
        results.append((metrics, params_to_numpy(state["params"])))
    (m1, p1), (m2, p2) = results
    for a, b in zip(m1, m2):
        np.testing.assert_allclose(float(a["loss"]), float(b["loss"]),
                                   atol=1e-5, rtol=0)
        np.testing.assert_allclose(float(a["grad_norm"]),
                                   float(b["grad_norm"]), rtol=1e-5)
    _assert_params_close(p2, p1)


def test_remat_policies_equal_no_remat(tcfg, np_params):
    params = params_from_jax(np_params, tcfg, device="cpu")
    batch = _torch_batch(_batches(1, tcfg.vocab_size, seed=4)[0])
    want, want_m = ttrain._grads(params, batch,
                                 dataclasses.replace(tcfg, remat=False))
    for policy in tllama.REMAT_POLICIES:
        cfg = dataclasses.replace(tcfg, remat=True, remat_policy=policy)
        got, got_m = ttrain._grads(params, batch, cfg)
        assert torch.equal(got_m["loss"], want_m["loss"]), policy
        assert all(torch.equal(g, w) for g, w in zip(got, want)), policy


def test_master_weights_keep_f32_storage(np_params):
    cfg = tllama.LlamaConfig.tiny(param_dtype=torch.float32, **DIMS)
    opt = ttrain.make_optimizer(**OPT)
    state = ttrain.init_train_state(
        cfg, opt, params=params_from_jax(np_params, cfg, device="cpu"))
    step = ttrain.make_train_step(cfg, opt)
    for batch in _batches(3, cfg.vocab_size, seed=5):
        state, metrics = step(state, _torch_batch(batch))
        assert np.isfinite(float(metrics["loss"]))
    leaves = ttrain.param_leaves(state["params"])
    assert all(p.dtype == torch.float32 for p in leaves)
    assert all(m.dtype == torch.float32 for m in state["opt_state"]["mu"])
    assert state["opt_state"]["count"] == 3


def test_config_refuses_what_is_not_ported():
    for kw, item in ((dict(fused_ce=True), "A8"), (dict(quant="int8"), "A8"),
                     (dict(attn_impl="ring"), "A12"),
                     (dict(attn_impl="ulysses"), "A12"),
                     (dict(n_experts=8), "A10"),
                     (dict(n_microbatches=4), "A12")):
        with pytest.raises(NotImplementedError, match=item):
            tllama.LlamaConfig.tiny(**kw)
    with pytest.raises(ValueError, match="remat_policy"):
        tllama.LlamaConfig.tiny(remat_policy="save_everything")
    for impl in ("full", "flash"):
        with pytest.raises(ValueError, match="'auto'"):
            tllama.LlamaConfig.tiny(attn_impl=impl)
    with pytest.raises(NotImplementedError, match="A8"):
        ttrain.make_optimizer(impl="fused")


def test_flops_per_token_matches_reference():
    for name in ("tiny", "llama3_8b", "mistral_7b"):
        want = getattr(jllama.LlamaConfig, name)().flops_per_token()
        assert getattr(tllama.LlamaConfig, name)().flops_per_token() == want
