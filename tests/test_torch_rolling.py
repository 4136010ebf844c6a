"""The port's rolling ring-cache decode (``models/rolling.py``) against the
port's unbounded windowed ``generate`` and the reference's
``rolling_generate``.

A tiny f32 config (2 layers, window 8); the JAX weights are carried
across with ``params_from_jax``, prompts are numpy-seeded. Greedy tokens
must be equal (no tolerance) for a prompt shorter than the window, one
longer, and a generation that wraps the ring several times; on bf16
caches and on int8 and int4 rings (both paths quantize every written
row with the one ``_cache_write`` recipe); on the tiny MoE config. The
ring layout equals the reference's ``_ring_from_prefill`` exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_gpu_device_plugin_tpu.models import llama as jllama
from k8s_gpu_device_plugin_tpu.models import rolling as jroll
from k8s_gpu_device_plugin_torch.models import llama as tllama
from k8s_gpu_device_plugin_torch.models import rolling as troll
from k8s_gpu_device_plugin_torch.models.convert import params_from_jax
from k8s_gpu_device_plugin_torch.models.generate import generate
from k8s_gpu_device_plugin_torch.models.sampling import Sampler

torch.set_num_threads(1)

W = 8
CASES = [(4, 6), (12, 6), (6, 20)]  # p < W, p > W, the ring wraps twice


def _prompt(b, p, vocab, seed=1):
    ids = np.random.default_rng(seed).integers(0, vocab, (b, p))
    return ids.astype(np.int32)


@pytest.fixture(scope="module")
def both():
    jcfg = jllama.LlamaConfig.tiny(n_layers=2, sliding_window=W,
                                   dtype=jnp.float32)
    tcfg = tllama.LlamaConfig.tiny(n_layers=2, sliding_window=W,
                                   dtype=torch.float32)
    jparams = jllama.init_params(jax.random.key(0), jcfg)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                              device="cpu")
    return jcfg, jparams, tcfg, tparams


@pytest.mark.parametrize("p,max_new", CASES)
def test_rolling_matches_unbounded_and_the_reference(both, p, max_new):
    jcfg, jparams, tcfg, tparams = both
    prompt = _prompt(2, p, tcfg.vocab_size)
    got = troll.rolling_generate(tparams, torch.from_numpy(prompt), tcfg,
                                 max_new)
    unbounded = generate(tparams, torch.from_numpy(prompt), tcfg, max_new)
    want = jroll.rolling_generate(jparams, jnp.asarray(prompt), jcfg,
                                  max_new=max_new)
    assert torch.equal(got, unbounded)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("p,max_new", CASES)
@pytest.mark.parametrize("cache_quant", ["int8", "int4"])
def test_rolling_quantized_ring_matches_unbounded(both, p, max_new,
                                                  cache_quant):
    _, _, tcfg, tparams = both
    cfg = tllama.LlamaConfig.tiny(n_layers=2, sliding_window=W,
                                  dtype=torch.float32,
                                  cache_quant=cache_quant)
    prompt = torch.from_numpy(_prompt(2, p, cfg.vocab_size, seed=3))
    assert torch.equal(troll.rolling_generate(tparams, prompt, cfg, max_new),
                       generate(tparams, prompt, cfg, max_new))


@pytest.mark.parametrize("p", [6, 3])
def test_ring_from_prefill_equals_the_reference(p):
    """Slot s holds the position congruent to s (mod W): a rotation of
    the last W rows when P > W, zero-padded tail slots when P < W."""
    kv = np.random.default_rng(p).standard_normal((2, 1, p, 2, 3))
    kv = kv.astype(np.float32)
    want = jroll._ring_from_prefill(jnp.asarray(kv), p, 4)
    got = troll._ring_from_prefill(torch.from_numpy(kv), p, 4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_rolling_moe_matches_unbounded():
    cfg = tllama.LlamaConfig.tiny(n_layers=2, sliding_window=W, n_experts=4,
                                  capacity_factor=8.0, dtype=torch.float32)
    params = tllama.init_params(cfg, seed=0, device="cpu")
    prompt = torch.from_numpy(_prompt(1, 10, cfg.vocab_size, seed=2))
    assert torch.equal(troll.rolling_generate(params, prompt, cfg, 10),
                       generate(params, prompt, cfg, 10))


def test_rolling_sampled_stays_in_vocab(both):
    _, _, cfg, params = both
    prompt = torch.arange(1, 7)[None, :]
    gen = torch.Generator().manual_seed(3)
    toks = troll.rolling_generate(
        params, prompt, cfg, 10, generator=gen,
        sampler=Sampler(temperature=0.8, top_k=20))
    assert toks.shape == (1, 10)
    assert bool(((toks >= 0) & (toks < cfg.vocab_size)).all())


def test_rolling_validation(both):
    _, _, cfg, params = both
    full = tllama.LlamaConfig.tiny(n_layers=2, dtype=torch.float32)
    prompt = torch.zeros((1, 4), dtype=torch.long)
    with pytest.raises(ValueError, match="sliding_window"):
        troll.rolling_generate(params, prompt, full, 2)
    with pytest.raises(ValueError, match="max_new"):
        troll.rolling_generate(params, prompt, cfg, 0)
