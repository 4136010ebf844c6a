"""Parity of the port's model building blocks with the JAX reference.

Same inputs (numpy, from a seed) through ``k8s_gpu_device_plugin_tpu``
and ``k8s_gpu_device_plugin_torch`` on the CPU, in f32. Tolerance: atol
1e-5 — both sides compute the same f32 arithmetic, so only summation
order and transcendental rounding (rsqrt, cos/sin, exp) differ.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_gpu_device_plugin_tpu.models import generate as jgen
from k8s_gpu_device_plugin_tpu.models import llama as jllama
from k8s_gpu_device_plugin_torch.models import generate as tgen
from k8s_gpu_device_plugin_torch.models import llama as tllama

# the suite runs in several worker processes on shared cores: one
# intra-op thread each keeps torch's OpenMP pool from spinning against
# them (these shapes gain nothing from more)
torch.set_num_threads(1)

ATOL = 1e-5


def _configs(**kw):
    jcfg = jllama.LlamaConfig.tiny(dtype=jnp.float32, **kw)
    tcfg = tllama.LlamaConfig.tiny(dtype=torch.float32, **kw)
    return jcfg, tcfg


def _close(got: torch.Tensor, want) -> None:
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)


@pytest.mark.parametrize("offset", [False, True])
def test_rms_norm_matches_reference(offset):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    w = rng.standard_normal(64).astype(np.float32)
    want = jllama.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5, offset)
    got = tllama.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-5,
                          offset)
    _close(got, want)


@pytest.mark.parametrize("per_row", [False, True])
def test_rope_matches_reference(per_row):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 7, 4, 64)).astype(np.float32)
    if per_row:
        pos = rng.integers(0, 120, (3, 7)).astype(np.int32)
    else:
        pos = np.arange(40, 47, dtype=np.int32)
    want = jllama.rope(jnp.asarray(x), jnp.asarray(pos), 10000.0)
    got = tllama.rope(torch.from_numpy(x), torch.from_numpy(pos), 10000.0)
    _close(got, want)


@pytest.mark.parametrize("act", ["silu", "gelu_tanh"])
def test_mlp_act_matches_reference(act):
    jcfg, tcfg = _configs(act=act)
    x = np.random.default_rng(2).standard_normal((4, 33)).astype(np.float32)
    _close(tllama.mlp_act(torch.from_numpy(x), tcfg),
           jllama.mlp_act(jnp.asarray(x), jcfg))


@pytest.mark.parametrize("per_row", [False, True])
def test_project_qkv_matches_reference(per_row):
    jcfg, tcfg = _configs(head_dim_override=64)
    params = jllama.init_params(jax.random.key(0), jcfg)
    layer = {k: np.array(v[0]) for k, v in params["layers"].items()}
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 6, jcfg.d_model)).astype(np.float32)
    pos = (rng.integers(0, 90, (2, 6)) if per_row
           else np.arange(10, 16)).astype(np.int32)
    want = jgen._project_qkv(
        jnp.asarray(x), {k: jnp.asarray(v) for k, v in layer.items()},
        jnp.asarray(pos), jcfg,
    )
    rot = tllama.rope_angles(torch.from_numpy(pos), tcfg.head_dim,
                             tcfg.rope_theta)
    got = tgen._project_qkv(
        torch.from_numpy(x), {k: torch.from_numpy(v) for k, v in layer.items()},
        rot, tcfg,
    )
    for g, w in zip(got, want):
        _close(g, w)


def test_config_refuses_what_the_slice_does_not_serve():
    for field, value in (("n_experts", 8), ("tp", 2), ("quant", "int8")):
        with pytest.raises(NotImplementedError, match=field):
            tllama.LlamaConfig.tiny(**{field: value})
    for field, value in (("cache_quant", "fp8"), ("kv_layout", "ragged"),
                         ("kv_page_size", 0)):
        with pytest.raises(ValueError, match=field):
            tllama.LlamaConfig.tiny(**{field: value})
    served = tllama.LlamaConfig.tiny(kv_layout="paged", cache_quant="int8",
                                     kv_page_size=16)
    assert (served.kv_layout, served.cache_quant) == ("paged", "int8")
    assert tllama.LlamaConfig.tiny(cache_quant="int4").cache_quant == "int4"


def test_presets_match_reference_dims():
    fields = ("vocab_size", "d_model", "n_layers", "n_heads", "n_kv_heads",
              "d_ff", "rope_theta", "max_seq", "sliding_window")
    for name in ("llama3_8b", "llama3_70b", "mistral_7b"):
        j = getattr(jllama.LlamaConfig, name)()
        t = getattr(tllama.LlamaConfig, name)()
        assert [getattr(j, f) for f in fields] == [getattr(t, f) for f in fields]
    assert tllama.LlamaConfig.llama3_8b().dtype == torch.bfloat16


def test_init_params_layout_matches_reference():
    jcfg, tcfg = _configs()
    jp = jax.eval_shape(lambda: jllama.init_params(jax.random.key(0), jcfg))
    tp = tllama.init_params(tcfg, seed=0, device="cpu")
    assert set(tp) == set(jp)
    assert set(tp["layers"]) == set(jp["layers"])
    for name, leaf in jp["layers"].items():
        assert tuple(tp["layers"][name].shape) == leaf.shape, name
    for name in ("embed", "final_norm", "lm_head"):
        assert tuple(tp[name].shape) == jp[name].shape, name
    again = tllama.init_params(tcfg, seed=0, device="cpu")
    assert torch.equal(tp["layers"]["wq"], again["layers"]["wq"])
