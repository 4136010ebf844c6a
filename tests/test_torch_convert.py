"""HF checkpoint conversion (``models/convert.py``) against the reference
and against ``transformers``.

The reference's ``tests/test_convert.py`` pins its ``config_from_hf``,
``params_from_hf`` and ``params_to_hf`` against ``transformers``'
random-init models, built from in-memory configs (nothing downloaded).
Here the port's copies are held to both, for the four families the
reference converts (Llama, Mistral, Qwen2 with random q/k/v biases,
Gemma) and a Gemma at head dim 256 (Gemma-2B's):

- ``config_from_hf`` gives the reference's config, field for field;
- ``params_from_hf`` gives the reference's params exactly, leaf for leaf,
  in f32 and in bf16 (one rounding of the f32 weights in both);
- the port's f32 forward (the plain attention, on the CPU) is within
  1e-4 of ``transformers``' logits, and its greedy ``generate`` equals
  HF's ``generate`` token for token;
- ``params_to_hf`` inverts ``params_from_hf`` exactly, returns contiguous
  f32 CPU tensors, and loads back into HF with the same logits;
- every refusal of the reference is a refusal here.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")

from k8s_gpu_device_plugin_tpu.models import convert as jconvert  # noqa: E402
from k8s_gpu_device_plugin_torch.models import convert  # noqa: E402
from k8s_gpu_device_plugin_torch.models import generate as tgen  # noqa: E402
from k8s_gpu_device_plugin_torch.models import llama as tllama  # noqa: E402

torch.set_num_threads(1)

BASE = dict(vocab_size=64, hidden_size=64, intermediate_size=128,
            num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
            rope_theta=10000.0, max_position_embeddings=128)
TOKENS = np.array([[3, 17, 42, 7, 23, 11, 60, 2]], np.int64)
PROMPT = np.array([[5, 9, 33, 12]], np.int64)
#: f32 logits, the port's plain forward against transformers'
LOGITS_ATOL = 1e-4


def _hf(family: str):
    """(model, config) of a tiny random-init HF model of ``family``."""
    if family == "llama":
        cfg = transformers.LlamaConfig(**BASE, rms_norm_eps=1e-5,
                                       tie_word_embeddings=False)
        torch.manual_seed(0)
        return transformers.LlamaForCausalLM(cfg).eval(), cfg
    if family == "mistral":
        cfg = transformers.MistralConfig(**BASE, rms_norm_eps=1e-5,
                                         tie_word_embeddings=False,
                                         sliding_window=8)
        torch.manual_seed(0)
        return transformers.MistralForCausalLM(cfg).eval(), cfg
    if family in ("qwen2", "qwen2_tied"):
        cfg = transformers.Qwen2Config(
            **BASE, rms_norm_eps=1e-5,
            tie_word_embeddings=family == "qwen2_tied")
        torch.manual_seed(1)
        m = transformers.Qwen2ForCausalLM(cfg).eval()
        with torch.no_grad():  # zero biases would hide a dropped one
            for layer in m.model.layers:
                for proj in ("q_proj", "k_proj", "v_proj"):
                    getattr(layer.self_attn, proj).bias.normal_(0.0, 0.5)
        return m, cfg
    if family == "gemma":
        cfg = transformers.GemmaConfig(**{**BASE, "num_key_value_heads": 2},
                                       head_dim=16, rms_norm_eps=1e-6)
    elif family == "gemma_hd256":  # Gemma-2B's head dim, one kv head
        cfg = transformers.GemmaConfig(
            **{**BASE, "hidden_size": 128, "num_attention_heads": 2,
               "num_key_value_heads": 1}, head_dim=256, rms_norm_eps=1e-6)
    else:
        raise ValueError(family)
    torch.manual_seed(3)
    return transformers.GemmaForCausalLM(cfg).eval(), cfg


FAMILIES = ("llama", "mistral", "qwen2", "gemma", "gemma_hd256")


def _hf_logits(hf, tokens) -> np.ndarray:
    with torch.no_grad():
        return hf(torch.from_numpy(tokens)).logits.float().numpy()


def _np(x) -> np.ndarray:
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x,
                      np.float32)


@pytest.mark.parametrize("family", FAMILIES)
def test_config_matches_the_reference(family):
    _, hf_cfg = _hf(family)
    got = convert.config_from_hf(hf_cfg)
    want = jconvert.config_from_hf(hf_cfg)
    fields = ("vocab_size", "d_model", "n_layers", "n_heads", "n_kv_heads",
              "d_ff", "rope_theta", "norm_eps", "max_seq", "sliding_window",
              "attn_bias", "act", "norm_offset", "tied_embeddings",
              "scale_embed", "head_dim_override")
    assert {f: getattr(got, f) for f in fields} == \
        {f: getattr(want, f) for f in fields}
    assert got.head_dim == want.head_dim
    assert got.dtype == torch.bfloat16
    assert convert.config_from_hf(hf_cfg, dtype=torch.float32).dtype \
        == torch.float32
    if family == "mistral":
        assert got.sliding_window == 8
    if family.startswith("gemma"):
        assert got.tied_embeddings and got.norm_offset and got.scale_embed
        assert got.act == "gelu_tanh"
    if family == "gemma_hd256":
        assert got.head_dim == 256


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("family", FAMILIES)
def test_params_equal_the_reference_leaf_for_leaf(family, dtype):
    hf, hf_cfg = _hf(family)
    cfg = convert.config_from_hf(hf_cfg, dtype=getattr(torch, dtype))
    got = convert.params_from_hf(hf.state_dict(), cfg, device="cpu")
    want = jconvert.params_from_hf(
        hf.state_dict(), jconvert.config_from_hf(hf_cfg,
                                                 dtype=getattr(jnp, dtype)))
    assert set(got) == set(want)
    assert set(got["layers"]) == set(want["layers"])
    pairs = [(k, got[k], want[k]) for k in got if k != "layers"]
    pairs += [(f"layers.{k}", got["layers"][k], want["layers"][k])
              for k in got["layers"]]
    for name, g, w in pairs:
        assert g.dtype == cfg.p_dtype, name
        assert g.device.type == "cpu", name
        np.testing.assert_array_equal(_np(g), _np(w), err_msg=name)
    assert ("lm_head" in got) != cfg.tied_embeddings
    assert ("bq" in got["layers"]) == (family == "qwen2")


@pytest.mark.parametrize("family", FAMILIES)
def test_forward_and_greedy_match_transformers(family):
    hf, hf_cfg = _hf(family)
    cfg = convert.config_from_hf(hf_cfg, dtype=torch.float32)
    params = convert.params_from_hf(hf.state_dict(), cfg, device="cpu")
    # 16 tokens past Mistral's window of 8: the windowed mask matters
    tokens = np.arange(1, 17, dtype=np.int64)[None] if family == "mistral" \
        else TOKENS
    with torch.no_grad():
        got = tllama.forward(params, torch.from_numpy(tokens), cfg).numpy()
    np.testing.assert_allclose(got, _hf_logits(hf, tokens), atol=LOGITS_ATOL,
                               rtol=0)
    with torch.no_grad():
        want = hf.generate(torch.from_numpy(PROMPT), max_new_tokens=8,
                           do_sample=False, pad_token_id=0)[:, PROMPT.shape[1]:]
        got = tgen.generate(params, torch.from_numpy(PROMPT), cfg, max_new=8)
    np.testing.assert_array_equal(got.numpy(), want.numpy())


@pytest.mark.parametrize("family", FAMILIES)
def test_round_trip_is_exact_and_loads_back_into_hf(family):
    hf, hf_cfg = _hf(family)
    cfg = convert.config_from_hf(hf_cfg, dtype=torch.float32)
    params = convert.params_from_hf(hf.state_dict(), cfg, device="cpu")
    sd = convert.params_to_hf(params, cfg)
    ref = {k: v for k, v in hf.state_dict().items() if "rotary_emb" not in k}
    # a tied head is one leaf: the export has the table, not its copy
    missing = {"lm_head.weight"} if cfg.tied_embeddings else set()
    assert set(ref) - set(sd) == missing and set(sd) <= set(ref)
    for name, w in sd.items():
        assert w.dtype == torch.float32 and w.device.type == "cpu", name
        assert w.is_contiguous(), name
        assert torch.equal(w, ref[name].float()), name
    again = convert.params_from_hf(sd, cfg, device="cpu")
    for k in params["layers"]:
        assert torch.equal(again["layers"][k], params["layers"][k]), k
    assert torch.equal(again["embed"], params["embed"])
    hf2, _ = _hf(family)
    with torch.no_grad():  # scrambled first: the load must restore it all
        for p in hf2.parameters():
            p.normal_()
    result = hf2.load_state_dict(sd, strict=not cfg.tied_embeddings)
    if cfg.tied_embeddings:
        assert set(result.missing_keys) == missing
        assert not result.unexpected_keys
        hf2.tie_weights()
    np.testing.assert_allclose(_hf_logits(hf2, PROMPT), _hf_logits(hf, PROMPT),
                               atol=1e-6, rtol=0)


def test_tied_head_is_one_leaf_for_any_family():
    """A tied Qwen2 (its 0.5B and 1.5B ship so) converts with one leaf and
    matches transformers; a "tied" head that differs is refused."""
    hf, hf_cfg = _hf("qwen2_tied")
    cfg = convert.config_from_hf(hf_cfg, dtype=torch.float32)
    assert cfg.tied_embeddings and cfg.attn_bias
    params = convert.params_from_hf(hf.state_dict(), cfg, device="cpu")
    assert "lm_head" not in params
    with torch.no_grad():
        got = tllama.forward(params, torch.from_numpy(TOKENS[:, :4]),
                             cfg).numpy()
    np.testing.assert_allclose(got, _hf_logits(hf, TOKENS[:, :4]),
                               atol=LOGITS_ATOL, rtol=0)
    sd = {k: v.clone() for k, v in hf.state_dict().items()}
    sd["lm_head.weight"] = sd["lm_head.weight"] + 1.0  # an untied fine-tune
    with pytest.raises(ValueError, match="differs"):
        convert.params_from_hf(sd, cfg, device="cpu")
    with pytest.raises(ValueError, match="differs"):
        jconvert.params_from_hf(sd, jconvert.config_from_hf(hf_cfg))


# --- refusals -----------------------------------------------------------------


def _refused_config(case: str):
    """An HF config the reference refuses, and the words of the refusal."""
    if case == "rope_scaling":
        _, cfg = _hf("llama")
        cfg.rope_scaling = {"rope_type": "llama3", "factor": 8.0,
                            "low_freq_factor": 1.0, "high_freq_factor": 4.0,
                            "original_max_position_embeddings": 8192}
        return cfg, "rope_scaling"
    if case == "activation":
        _, cfg = _hf("llama")
        cfg.hidden_act = "gelu"
        return cfg, "hidden_act"
    if case == "qwen2_partial_window":
        return transformers.Qwen2Config(
            **{**BASE, "num_hidden_layers": 4}, use_sliding_window=True,
            sliding_window=4096, max_window_layers=2), "layer-partial"
    raise ValueError(case)


@pytest.mark.parametrize("case", ["rope_scaling", "activation",
                                  "qwen2_partial_window"])
def test_config_refusals_are_the_reference_s(case):
    hf_cfg, words = _refused_config(case)
    with pytest.raises(NotImplementedError, match=words):
        convert.config_from_hf(hf_cfg)
    with pytest.raises(NotImplementedError, match=words):
        jconvert.config_from_hf(hf_cfg)


def test_qwen2_window_gating_as_the_reference():
    """Qwen2 ships sliding_window but applies it only with the flag and
    only to layers >= max_window_layers: off, none windowed and all
    windowed convert as the reference does."""
    base = {**BASE, "num_hidden_layers": 4}
    for kw, want in ((dict(use_sliding_window=False), 0),
                     (dict(use_sliding_window=True, max_window_layers=4), 0),
                     (dict(use_sliding_window=True, max_window_layers=0),
                      4096)):
        hf_cfg = transformers.Qwen2Config(**base, sliding_window=4096, **kw)
        assert convert.config_from_hf(hf_cfg).sliding_window == want
        assert jconvert.config_from_hf(hf_cfg).sliding_window == want


def _refused_state(case: str):
    """(state dict, config, exception, words) the reference refuses."""
    if case == "llama_o_proj_bias":
        hf_cfg = transformers.LlamaConfig(**BASE, tie_word_embeddings=False,
                                          attention_bias=True)
        torch.manual_seed(2)
        hf = transformers.LlamaForCausalLM(hf_cfg).eval()
        return hf.state_dict(), hf_cfg, ValueError, "unconsumed"
    hf, hf_cfg = _hf("llama")
    sd = dict(hf.state_dict())
    if case == "missing_weight":
        del sd["model.layers.1.mlp.down_proj.weight"]
        return sd, hf_cfg, KeyError, "down_proj"
    if case == "shape_mismatch":
        sd["model.embed_tokens.weight"] = torch.zeros(32, 64)
        return sd, hf_cfg, ValueError, "embed"
    if case == "unconsumed_tensor":
        sd["model.layers.0.self_attn.extra.weight"] = torch.zeros(4)
        return sd, hf_cfg, ValueError, "unconsumed"
    raise ValueError(case)


@pytest.mark.parametrize("case", ["llama_o_proj_bias", "missing_weight",
                                  "shape_mismatch", "unconsumed_tensor"])
def test_checkpoint_refusals_are_the_reference_s(case):
    sd, hf_cfg, exc, words = _refused_state(case)
    cfg = convert.config_from_hf(hf_cfg, dtype=torch.float32)
    if case == "llama_o_proj_bias":
        assert cfg.attn_bias  # q/k/v biases are taken; o_proj's is not
    with pytest.raises(exc, match=words):
        convert.params_from_hf(sd, cfg, device="cpu")
    with pytest.raises(exc, match=words):
        jconvert.params_from_hf(sd, jconvert.config_from_hf(hf_cfg))


def test_params_to_hf_refuses_moe_quantized_and_the_wrong_depth():
    moe = tllama.LlamaConfig.tiny(n_layers=1, n_experts=4, dtype=torch.float32)
    with pytest.raises(NotImplementedError, match="MoE"):
        convert.params_to_hf(tllama.init_params(moe, device="cpu"), moe)
    hf, hf_cfg = _hf("llama")
    cfg = convert.config_from_hf(hf_cfg, dtype=torch.float32)
    params = convert.params_from_hf(hf.state_dict(), cfg, device="cpu")
    with pytest.raises(ValueError, match="stacked layers"):
        convert.params_to_hf(params, dataclasses.replace(cfg, n_layers=1))
    quantized = {**params, "layers": {
        **params["layers"], "wq": {"q": params["layers"]["wq"].to(torch.int8),
                                   "s": torch.ones(2, 1, 64)}}}
    with pytest.raises(NotImplementedError, match="quantized"):
        convert.params_to_hf(quantized, cfg)
