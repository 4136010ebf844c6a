"""The port's Mixture-of-Experts (``models/moe.py``, the MoE config and
forward of ``models/llama.py``, the MoE loss of ``models/train.py``)
against the reference's.

A tiny f32 config (2 layers, 4 experts, top 2); the JAX weights are
carried across with ``params_from_jax``, inputs are numpy-seeded. Every
function is held to its JAX twin within 1e-5 (f32), the loss and its
gradients within 1e-4.

Top-k near ties: XLA's f32 router product and the port's (f64, rounded
once to f32) differ in their last bits, so where two experts'
probabilities tie within rounding the two may choose differently. Where
a selection differs, its margin (the k-th minus the (k+1)-th probability)
must be below ``TIE``; outputs are compared where the selections agree.
The order within the top k does not matter (each gate is summed into its
expert's column).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_gpu_device_plugin_tpu.models import llama as jllama
from k8s_gpu_device_plugin_tpu.models import moe as jmoe
from k8s_gpu_device_plugin_tpu.models import train as jtrain
from k8s_gpu_device_plugin_torch.models import llama as tllama
from k8s_gpu_device_plugin_torch.models import moe as tmoe
from k8s_gpu_device_plugin_torch.models import train as ttrain
from k8s_gpu_device_plugin_torch.models.convert import params_from_jax

torch.set_num_threads(1)

ATOL = 1e-5        # one function, f32
LOSS_ATOL = 1e-4   # the loss and its gradients, f32
TIE = 1e-5         # the largest margin at which a top-k selection may differ
E, K = 4, 2


def _configs(**kw):
    kw = {"n_layers": 2, "n_experts": E, "n_experts_per_token": K, **kw}
    return (jllama.LlamaConfig.tiny(dtype=jnp.float32, **kw),
            tllama.LlamaConfig.tiny(dtype=torch.float32, **kw))


@pytest.fixture(scope="module")
def models():
    jcfg, tcfg = _configs(capacity_factor=8.0)
    jparams = jllama.init_params(jax.random.key(0), jcfg)
    np_params = jax.tree.map(np.asarray, jparams)
    tparams = params_from_jax(np_params, tcfg, device="cpu")
    return jcfg, jparams, tcfg, tparams


def _h(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _layer(jparams, i=0):
    return {k: v[i] for k, v in jparams["layers"].items()}


def selections_agree(want_idx, got_idx, probs, k=K) -> np.ndarray:
    """(..., k) expert choices of the reference and the port, and the
    (..., E) probabilities -> where the chosen sets agree. Asserts that
    every disagreement is a near tie (margin below TIE)."""
    want = np.sort(np.asarray(want_idx), axis=-1)
    got = np.sort(np.asarray(got_idx), axis=-1)
    agree = (want == got).all(axis=-1)
    ranked = -np.sort(-np.asarray(probs), axis=-1)
    margin = ranked[..., k - 1] - ranked[..., k]
    assert (margin[~agree] < TIE).all(), margin[~agree]
    return agree


def _by_expert(idx, gates):
    """Gates reordered by expert index (the top-k order may differ)."""
    order = np.argsort(np.asarray(idx), axis=-1)
    return np.take_along_axis(np.asarray(gates), order, axis=-1)


# --- config ---------------------------------------------------------------


def test_mixtral_preset_and_moe_fields_match_the_reference():
    fields = ("vocab_size", "d_model", "n_layers", "n_heads", "n_kv_heads",
              "d_ff", "rope_theta", "max_seq", "sliding_window", "n_experts",
              "n_experts_per_token", "capacity_factor", "moe_aux_weight",
              "moe_z_weight", "moe_group_size")
    j, t = jllama.LlamaConfig.mixtral_8x7b(), tllama.LlamaConfig.mixtral_8x7b()
    assert [getattr(j, f) for f in fields] == [getattr(t, f) for f in fields]
    assert t.is_moe and not tllama.LlamaConfig.tiny().is_moe
    assert t.with_group_size(0).moe_group_size == 0
    with pytest.raises(NotImplementedError, match="silu"):
        tllama.LlamaConfig.tiny(n_experts=4, act="gelu_tanh")


@pytest.mark.parametrize("name", ["mixtral_8x7b", "tiny_moe"])
def test_flops_per_token_matches_the_reference(name):
    if name == "tiny_moe":
        j, t = _configs()
    else:
        j, t = jllama.LlamaConfig.mixtral_8x7b(), \
            tllama.LlamaConfig.mixtral_8x7b()
    assert t.flops_per_token() == j.flops_per_token()


def test_init_layout_and_the_router_stays_f32():
    """The MoE layout is the reference's; the router is f32 in every tree
    the port builds or converts, and the compute cast passes it
    through."""
    jcfg, tcfg = _configs(param_dtype=None)
    jp = jax.eval_shape(lambda: jllama.init_params(jax.random.key(0), jcfg))
    tp = tllama.init_params(tcfg, seed=0, device="cpu")
    assert set(tp["layers"]) == set(jp["layers"])
    assert "w1" not in tp["layers"]
    for name, leaf in jp["layers"].items():
        assert tuple(tp["layers"][name].shape) == leaf.shape, name
    bf = dataclasses.replace(tcfg, dtype=torch.bfloat16)
    mixed = dataclasses.replace(bf, param_dtype=torch.float32)
    for cfg in (bf, mixed):
        p = tllama.init_params(cfg, seed=0, device="cpu")
        assert p["layers"]["router"].dtype == torch.float32
        assert p["layers"]["moe_w1"].dtype == cfg.p_dtype
        cast = tllama.cast_params_for_compute(p, cfg)
        assert cast["layers"]["router"].dtype == torch.float32
        assert cast["layers"]["moe_w2"].dtype == torch.bfloat16
    jbf = dataclasses.replace(jcfg, dtype=jnp.bfloat16)
    jparams = jllama.init_params(jax.random.key(1), jbf)
    got = params_from_jax(jax.tree.map(np.asarray, jparams), bf, device="cpu")
    assert got["layers"]["router"].dtype == torch.float32
    np.testing.assert_array_equal(got["layers"]["router"].numpy(),
                                  np.asarray(jparams["layers"]["router"]))
    assert got["layers"]["moe_w1"].dtype == torch.bfloat16
    bad = jax.tree.map(np.asarray, jparams)
    bad["layers"]["moe_w2"] = bad["layers"]["moe_w1"]
    with pytest.raises(ValueError, match="moe_w2"):
        params_from_jax(bad, bf, device="cpu")


# --- models/moe.py ---------------------------------------------------------


def test_router_logits_and_topk_match_the_reference(models):
    jcfg, jparams, _, tparams = models
    h = _h((3, 40, jcfg.d_model))
    router = jparams["layers"]["router"][0]
    want_logits = jnp.asarray(h) @ router
    got_logits = tmoe.router_logits(torch.from_numpy(h),
                                    tparams["layers"]["router"][0])
    assert got_logits.dtype == torch.float32
    np.testing.assert_allclose(got_logits.numpy(), np.asarray(want_logits),
                               atol=ATOL, rtol=0)
    # the same logits into both top-k's
    logits = _h((3, 40, E), seed=1) * 3
    jg, ji, jp = jmoe.router_topk(jnp.asarray(logits), K)
    tg, ti, tp = tmoe.router_topk(torch.from_numpy(logits), K)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=ATOL, rtol=0)
    agree = selections_agree(ji, ti.numpy(), jp)
    assert agree.mean() > 0.9
    np.testing.assert_allclose(_by_expert(ti.numpy(), tg.numpy())[agree],
                               _by_expert(ji, jg)[agree], atol=ATOL, rtol=0)
    np.testing.assert_allclose(tg.sum(-1).numpy(), 1.0, atol=ATOL)


@pytest.mark.parametrize("routing", ["uniform", "collapsed", "random"])
def test_load_balance_loss_matches_the_reference(routing):
    b, s = 2, 16
    if routing == "uniform":
        probs = np.full((b, s, E), 1.0 / E, np.float32)
        idx = (np.arange(s * K).reshape(1, s, K) % E).repeat(b, 0)
        expect = 1.0
    elif routing == "collapsed":
        probs = np.zeros((b, s, E), np.float32)
        probs[..., 0] = 1.0
        idx = np.zeros((b, s, K), np.int64)
        expect = float(E)
    else:
        probs = np.array(jax.nn.softmax(jnp.asarray(_h((b, s, E))), -1))
        idx = np.random.default_rng(2).integers(0, E, (b, s, K))
        expect = None
    want = jmoe.load_balance_loss(jnp.asarray(probs), jnp.asarray(idx), E)
    got = tmoe.load_balance_loss(torch.from_numpy(probs),
                                 torch.from_numpy(idx), E)
    np.testing.assert_allclose(got.item(), float(want), atol=ATOL, rtol=0)
    if expect is not None:
        np.testing.assert_allclose(got.item(), expect, atol=ATOL, rtol=0)


def test_capacity_floor_and_group_size_divide():
    for cf in (0.1, 1.0, 1.25, 8.0):
        jcfg, tcfg = _configs(capacity_factor=cf)
        for s in (1, 3, 7, 64, 100, 4096):
            got = tmoe.expert_capacity(tcfg, s)
            assert got == jmoe.expert_capacity(jcfg, s)
            assert got >= K
    for req, s in ((0, 40), (16, 40), (40, 40), (64, 40), (7, 97), (6, 36),
                   (4096, 10000)):
        g = tmoe._group_size(req, s)
        assert g == jmoe._group_size(req, s)
        assert s % g == 0 and (g <= req or req <= 0 or req >= s)


@pytest.mark.parametrize("capacity", [2, 5, 32])
def test_dispatch_and_combine_match_the_reference(capacity):
    """The mask is 0/1 and equal; a kept slot carries its gate; a token's
    combine mass is the sum of its kept gates (1 when nothing of it was
    dropped); at most ``capacity`` slots per expert and row."""
    b, s = 2, 12
    rng = np.random.default_rng(3)
    idx = np.stack([rng.permutation(E)[:K] for _ in range(b * s)]).reshape(
        b, s, K)
    gates = rng.random((b, s, K)).astype(np.float32)
    gates /= gates.sum(-1, keepdims=True)
    jd, jc = jmoe.make_dispatch_combine(jnp.asarray(gates), jnp.asarray(idx),
                                        E, capacity)
    td, tc = tmoe.make_dispatch_combine(torch.from_numpy(gates),
                                        torch.from_numpy(idx), E, capacity)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=ATOL, rtol=0)
    assert set(np.unique(td.numpy())) <= {0.0, 1.0}
    assert (td.numpy().sum(axis=(1, 3)) <= capacity).all()
    mass = tc.numpy().sum(axis=(2, 3))
    assert (mass <= 1.0 + ATOL).all()
    if capacity >= s * K:
        np.testing.assert_allclose(mass, 1.0, atol=ATOL)
    else:
        assert (mass < 1.0 - ATOL).any()


def _routing(jparams, tparams, h, layer=0):
    """The reference's and the port's top-k on the same h: (agree mask,
    the reference's probs)."""
    jl = jnp.asarray(h) @ jparams["layers"]["router"][layer]
    _, ji, jp = jmoe.router_topk(jl, K)
    tl = tmoe.router_logits(torch.from_numpy(h),
                            tparams["layers"]["router"][layer])
    _, ti, _ = tmoe.router_topk(tl, K)
    return selections_agree(ji, ti.numpy(), jp), jp


@pytest.mark.parametrize("capacity_factor,group", [
    (8.0, 0), (8.0, 8), (0.5, 0), (0.5, 8)],
    ids=["ample", "ample_grouped", "tight", "tight_grouped"])
def test_moe_mlp_matches_the_reference(models, capacity_factor, group):
    """moe_mlp's output and aux against the reference's, at ample
    capacity (where grouping changes nothing) and at a tight one (where
    tokens drop). Rows whose routing differs by a near tie are left out
    of the output comparison."""
    jcfg, jparams, tcfg, tparams = models
    jcfg = dataclasses.replace(jcfg, capacity_factor=capacity_factor,
                               moe_group_size=group)
    tcfg = dataclasses.replace(tcfg, capacity_factor=capacity_factor,
                               moe_group_size=group)
    h = _h((2, 32, jcfg.d_model), seed=4)
    jout, jaux = jmoe.moe_mlp(jnp.asarray(h), _layer(jparams), jcfg)
    tl = {k: v[0] for k, v in tparams["layers"].items()}
    tout, taux = tmoe.moe_mlp(torch.from_numpy(h), tl, tcfg)
    agree, _ = _routing(jparams, tparams, h)
    rows = agree.all(axis=-1)
    assert rows.any()
    np.testing.assert_allclose(tout.numpy()[rows], np.asarray(jout)[rows],
                               atol=ATOL, rtol=0)
    if rows.all():
        for name in ("moe_load_balance", "moe_router_z"):
            np.testing.assert_allclose(taux[name].item(), float(jaux[name]),
                                       atol=ATOL, rtol=0)
    if capacity_factor == 8.0 and group:
        whole, _ = tmoe.moe_mlp(torch.from_numpy(h), tl,
                                tcfg.with_group_size(0))
        np.testing.assert_allclose(tout.numpy(), whole.numpy(), atol=ATOL,
                                   rtol=0)
    if capacity_factor < 1.0:
        # a dropped token's mass is lost: some rows' outputs shrink to
        # part of their kept gates, some vanish
        dropped = np.abs(tout.numpy()).sum(-1) == 0
        full, _ = tmoe.moe_mlp(torch.from_numpy(h), tl, dataclasses.replace(
            tcfg, capacity_factor=8.0))
        assert not np.allclose(tout.numpy(), full.numpy(), atol=ATOL)
        assert dropped.any() or (np.abs(tout.numpy() - full.numpy()) > ATOL
                                 ).any()


def test_forward_with_aux_matches_the_reference(models):
    jcfg, jparams, tcfg, tparams = models
    tokens = np.random.default_rng(5).integers(0, jcfg.vocab_size, (2, 24))
    want, jaux = jllama.forward_with_aux(jparams, jnp.asarray(tokens), jcfg)
    got, taux = tllama.forward_with_aux(tparams, torch.from_numpy(tokens),
                                        tcfg)
    assert set(taux) == set(jaux) == {"moe_load_balance", "moe_router_z"}
    for name in taux:
        np.testing.assert_allclose(taux[name].item(), float(jaux[name]),
                                   atol=ATOL, rtol=0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=LOSS_ATOL,
                               rtol=0)


def test_loss_fn_value_and_gradients_match_the_reference(models):
    """The MoE loss adds ``moe_aux_weight * load balance + moe_z_weight
    * router z`` to the cross-entropy; value and every gradient within
    LOSS_ATOL of the reference's."""
    jcfg, jparams, tcfg, tparams = models
    rng = np.random.default_rng(6)
    seq = rng.integers(0, jcfg.vocab_size, (2, 17))
    jbatch = {"inputs": jnp.asarray(seq[:, :-1]),
              "targets": jnp.asarray(seq[:, 1:])}
    tbatch = {"inputs": torch.from_numpy(seq[:, :-1]),
              "targets": torch.from_numpy(seq[:, 1:])}

    def jloss(p):
        return jtrain.loss_fn(p, jbatch, jcfg, None)

    (want, jm), jgrads = jax.value_and_grad(jloss, has_aux=True)(jparams)
    tgrads, tm = ttrain._grads(tparams, tbatch, tcfg)
    got, _ = ttrain.loss_fn(tparams, tbatch, tcfg)
    np.testing.assert_allclose(got.item(), float(want), atol=LOSS_ATOL,
                               rtol=0)
    for name in ("loss", "moe_load_balance", "moe_router_z"):
        np.testing.assert_allclose(tm[name].item(), float(jm[name]),
                                   atol=LOSS_ATOL, rtol=0)
    assert got.item() > tm["loss"].item()
    jleaves = ttrain.param_leaves(jax.tree.map(np.asarray, jgrads))
    assert len(jleaves) == len(tgrads)
    for w, g in zip(jleaves, tgrads):
        np.testing.assert_allclose(g.numpy(), w, atol=LOSS_ATOL, rtol=0)
