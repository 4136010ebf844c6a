"""The port's cached forward and greedy generation against the reference.

``LlamaConfig.tiny(dtype=float32, head_dim_override=64)``; JAX's random
parameters go through ``params_from_jax`` so both frameworks hold the
same weights. Tolerance: f32 logits atol 1e-4 (two layers of f32 matmuls
and the attention in another summation order); greedy tokens must be
equal.
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
from k8s_gpu_device_plugin_torch.models.convert import params_from_jax

# the suite runs in several worker processes on shared cores: one
# intra-op thread each keeps torch's OpenMP pool from spinning against
# them (these shapes gain nothing from more)
torch.set_num_threads(1)

ATOL = 1e-4


@pytest.fixture(scope="module")
def models():
    jcfg = jllama.LlamaConfig.tiny(dtype=jnp.float32, head_dim_override=64)
    tcfg = tllama.LlamaConfig.tiny(dtype=torch.float32, head_dim_override=64)
    jparams = jllama.init_params(jax.random.key(0), jcfg)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                              device="cpu")
    return jcfg, jparams, tcfg, tparams


def test_params_from_jax_copies_every_leaf(models):
    _, jparams, _, tparams = models
    np.testing.assert_array_equal(tparams["layers"]["w2"].numpy(),
                                  np.asarray(jparams["layers"]["w2"]))
    np.testing.assert_array_equal(tparams["lm_head"].numpy(),
                                  np.asarray(jparams["lm_head"]))


def test_params_from_jax_reads_bfloat16():
    cfg = tllama.LlamaConfig.tiny()
    jp = jllama.init_params(jax.random.key(1),
                            jllama.LlamaConfig.tiny())
    tp = params_from_jax(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    assert tp["embed"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        tp["embed"].float().numpy(),
        np.asarray(jp["embed"].astype(jnp.float32)),
    )


def test_forward_cached_logits_match_reference(models):
    jcfg, jparams, tcfg, tparams = models
    rng = np.random.default_rng(0)
    prompt = rng.integers(1, jcfg.vocab_size, (2, 24)).astype(np.int32)
    steps = rng.integers(1, jcfg.vocab_size, (4, 2)).astype(np.int32)
    jcache = jgen.KVCache.init(jcfg, 2, 32)
    tcache = tgen.KVCache.init(tcfg, 2, 32, "cpu")
    want, jcache = jgen._forward_cached(jparams, jnp.asarray(prompt), jcache,
                                        0, jcfg)
    got = tgen._forward_cached(tparams, torch.from_numpy(prompt), tcache, 0,
                               tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)
    for i, tok in enumerate(steps):
        # decode steps at per-row positions, as the batcher runs them
        length = np.full((2,), 24 + i, np.int32)
        want, jcache = jgen._forward_cached(
            jparams, jnp.asarray(tok[:, None]), jcache, jnp.asarray(length),
            jcfg,
        )
        got = tgen._forward_cached(
            tparams, torch.from_numpy(tok[:, None]), tcache,
            torch.from_numpy(length), tcfg,
        )
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=ATOL, rtol=0)
    np.testing.assert_allclose(tcache.k.numpy()[:, :, :28],
                               np.asarray(jcache.k)[:, :, :28], atol=ATOL,
                               rtol=0)


@pytest.mark.parametrize("plen", [7, 24])
def test_greedy_generate_matches_reference(models, plen):
    jcfg, jparams, tcfg, tparams = models
    prompt = np.random.default_rng(plen).integers(
        1, jcfg.vocab_size, (2, plen)).astype(np.int32)
    want = jgen.generate(jparams, jnp.asarray(prompt), jcfg, max_new=12)
    got = tgen.generate(tparams, torch.from_numpy(prompt), tcfg, max_new=12)
    assert got.tolist() == np.asarray(want).tolist()


def test_plain_attention_flag_is_the_cpu_path(models):
    """On CPU tensors the dispatcher already takes the plain version, so
    the explicit comparison flag must change nothing."""
    _, _, tcfg, tparams = models
    prompt = torch.arange(1, 20)[None]
    a = tgen._forward_cached(tparams, prompt,
                             tgen.KVCache.init(tcfg, 1, 24, "cpu"), 0, tcfg)
    b = tgen._forward_cached(tparams, prompt,
                             tgen.KVCache.init(tcfg, 1, 24, "cpu"), 0, tcfg,
                             plain_attention=True)
    assert torch.equal(a, b)
