"""LoRA training in the port (``models/lora.py``: ``init_lora_state``,
``make_lora_train_step``), held against the JAX package's, twins of the
reference's ``tests/test_lora.py``.

Both packages start from the same numbers: the reference's base weights
through ``params_from_jax`` and the factors its ``init_lora_state`` drew
(A random, B zero) through ``lora_params_from_jax``; each package's
``make_optimizer`` with the same settings; the same numpy batch. Every
step's loss within f32 atol 1e-5 and ``grad_norm`` within rtol 1e-5 of
the reference's (the tolerances of ``tests/test_torch_train.py``), the
final factors within its parameter tolerance, atol 1e-4; the base tree
equal to itself bit for bit after training.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_gpu_device_plugin_torch.models import llama as tllama
from k8s_gpu_device_plugin_torch.models import lora as tlora
from k8s_gpu_device_plugin_torch.models import train as ttrain
from k8s_gpu_device_plugin_torch.models.convert import (
    lora_params_from_jax,
    params_from_jax,
)
from k8s_gpu_device_plugin_tpu.models import llama as jllama
from k8s_gpu_device_plugin_tpu.models import lora as jlora
from k8s_gpu_device_plugin_tpu.models import train as jtrain
from k8s_gpu_device_plugin_tpu.parallel.mesh import MeshSpec, make_mesh

torch.set_num_threads(1)

OPT = dict(learning_rate=1e-2, warmup_steps=1, total_steps=10)
STEPS, B, S = 4, 4, 32
LOSS_ATOL, NORM_RTOL, FACTOR_ATOL = 1e-5, 1e-5, 1e-4


@pytest.fixture(scope="module")
def base():
    jcfg = jllama.LlamaConfig.tiny(dtype=jnp.float32)
    tcfg = tllama.LlamaConfig.tiny(dtype=torch.float32)
    np_params = jax.tree.map(np.asarray,
                             jllama.init_params(jax.random.key(0), jcfg))
    tokens = np.random.default_rng(2).integers(0, jcfg.vocab_size,
                                               (B, S + 1), dtype=np.int32)
    batch = {"inputs": tokens[:, :-1], "targets": tokens[:, 1:]}
    return jcfg, tcfg, np_params, batch


def _port_cfg(lc):
    return tlora.LoraConfig(rank=lc.rank, alpha=lc.alpha,
                            targets=tuple(lc.targets))


def test_zero_init_is_identity(base):
    """B = 0: the merged model is the base model exactly at step 0."""
    _, tcfg, np_params, batch = base
    params = params_from_jax(np_params, tcfg, device="cpu")
    state = tlora.init_lora_state(tcfg, tlora.LoraConfig(rank=4, alpha=8.0),
                                  ttrain.make_optimizer(**OPT), seed=1,
                                  device="cpu")
    tokens = torch.from_numpy(batch["inputs"]).long()
    lc = tlora.LoraConfig(rank=4, alpha=8.0)
    want = tllama.forward(params, tokens, tcfg)
    got = tllama.forward(tlora.merge_lora(params, state["lora"], lc), tokens,
                         tcfg)
    assert torch.equal(got, want)


@pytest.mark.parametrize("targets", [("wq", "wk", "wv", "wo"),
                                     ("w1", "w2", "w3")],
                         ids=["attention", "mlp"])
def test_lora_training_matches_the_reference_and_freezes_base(base, targets):
    """``STEPS`` steps of each package's LoRA step on one batch from the
    same base and factors: losses, grad norms and the final factors held
    to the reference's; the loss falls (the factors overfit the batch),
    every B factor moves off zero, and the base is untouched."""
    jcfg, tcfg, np_params, batch = base
    jlc = jlora.LoraConfig(rank=4, alpha=8.0, targets=targets)
    mesh = make_mesh(MeshSpec(dp=1), jax.devices()[:1])
    jopt = jtrain.make_optimizer(**OPT)
    jparams = jax.tree.map(jnp.asarray, np_params)
    jstate = jlora.init_lora_state(jax.random.key(1), jcfg, jlc, jopt)
    np_lora = jax.tree.map(np.asarray, jstate["lora"])
    jstep = jlora.make_lora_train_step(jparams, jcfg, mesh, jlc, jopt)

    lc = _port_cfg(jlc)
    topt = ttrain.make_optimizer(**OPT)
    tparams = params_from_jax(np_params, tcfg, device="cpu")
    before = [p.clone() for p in ttrain.param_leaves(tparams)]
    tstate = {"lora": lora_params_from_jax(np_lora, tcfg, device="cpu"),
              "opt_state": None, "step": 0}
    tstate["opt_state"] = topt.init(ttrain.param_leaves(tstate["lora"]))
    tstep = tlora.make_lora_train_step(tparams, tcfg, lc, topt)

    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v).long() for k, v in batch.items()}
    losses = []
    for _ in range(STEPS):
        jstate, jm = jstep(jstate, jb)
        tstate, tm = tstep(tstate, tb)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   atol=LOSS_ATOL, rtol=0)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=NORM_RTOL)
        assert float(tm["accuracy"]) == -1.0  # with_accuracy=False
        losses.append(float(tm["loss"]))
    assert tstate["step"] == int(jstate["step"]) == STEPS
    assert losses[-1] < losses[0]
    jl = jax.tree.map(np.asarray, jstate["lora"])
    for t in targets:
        for k in ("a", "b"):
            np.testing.assert_allclose(tstate["lora"][t][k].numpy(),
                                       jl[t][k], atol=FACTOR_ATOL, rtol=0,
                                       err_msg=f"{t}.{k}")
        assert float(tstate["lora"][t]["b"].abs().sum()) > 0
    after = ttrain.param_leaves(tparams)
    assert all(torch.equal(a, b) and not b.requires_grad
               for a, b in zip(before, after))
    assert not any(p.requires_grad
                   for p in ttrain.param_leaves(tstate["lora"]))


def test_init_lora_state_and_validation(base):
    _, tcfg, _, _ = base
    opt = ttrain.make_optimizer(**OPT)
    lc = tlora.LoraConfig(rank=4, alpha=8.0, targets=("wq", "w2"))
    s1 = tlora.init_lora_state(tcfg, lc, opt, seed=3, device="cpu")
    assert set(s1) == {"lora", "opt_state", "step"} and s1["step"] == 0
    assert set(s1["lora"]) == {"wq", "w2"}
    assert s1["opt_state"]["count"] == 0
    assert len(s1["opt_state"]["mu"]) == 4  # a and b of two targets
    gen = torch.Generator()
    gen.manual_seed(3)
    s2 = tlora.init_lora_state(tcfg, lc, opt, generator=gen, device="cpu")
    for a, b in zip(ttrain.param_leaves(s1["lora"]),
                    ttrain.param_leaves(s2["lora"])):
        assert torch.equal(a, b)
    moe = tllama.LlamaConfig.tiny(n_layers=1, n_experts=4)
    with pytest.raises(NotImplementedError, match="MoE"):
        tlora.init_lora_state(moe, tlora.LoraConfig(targets=("w1",)), opt,
                              device="cpu")
    attn = tlora.init_lora_state(moe, tlora.LoraConfig(), opt, device="cpu")
    assert set(attn["lora"]) == {"wq", "wk", "wv", "wo"}
