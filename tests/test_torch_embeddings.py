"""The port's ``Embedder`` against the reference's.

A tiny f32 config with 2 layers; the JAX weights carried across with
``params_from_jax``; ids from a seed with numpy. The port's
``Embedder.embed`` equals the JAX ``Embedder``'s within 1e-5 on the same
ids; padding is masked out of the mean (a 20-token input at bucket 32
and at bucket 64 gives the same vector: on a card, K2's rule pads bucket
32 to 64); the vector has unit norm; the refusals are the reference's.
The HTTP face (``/v1/embeddings``) is in ``test_torch_openai_api.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_gpu_device_plugin_torch.models import llama as tllama
from k8s_gpu_device_plugin_torch.models.convert import params_from_jax
from k8s_gpu_device_plugin_torch.serving.embeddings import Embedder
from k8s_gpu_device_plugin_tpu.models import llama as jllama
from k8s_gpu_device_plugin_tpu.serving import embeddings as jemb

# the suite runs in several worker processes on shared cores: one
# intra-op thread each keeps torch's OpenMP pool from spinning against
# them (these shapes gain nothing from more)
torch.set_num_threads(1)

ATOL = 1e-5
BUCKETS = (32, 64)


@pytest.fixture(scope="module")
def models():
    jcfg = jllama.LlamaConfig.tiny(dtype=jnp.float32)
    tcfg = tllama.LlamaConfig.tiny(dtype=torch.float32)
    jparams = jllama.init_params(jax.random.key(0), jcfg)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                              device="cpu")
    return jcfg, jparams, tcfg, tparams


@pytest.fixture(scope="module")
def embedders(models):
    jcfg, jparams, tcfg, tparams = models
    return (Embedder(tparams, tcfg, buckets=BUCKETS),
            jemb.Embedder(jparams, jcfg, buckets=BUCKETS))


def _ids(seed: int, n: int, vocab: int) -> list[int]:
    return np.random.default_rng(seed).integers(1, vocab, n).tolist()


@pytest.mark.parametrize("n", [1, 5, 20, 33, 64])
def test_embed_matches_the_reference(models, embedders, n):
    port, ref = embedders
    ids = _ids(n, n, models[2].vocab_size)
    got = port.embed(ids)
    assert got.dtype == np.float32 and got.shape == (models[2].d_model,)
    np.testing.assert_allclose(got, ref.embed(ids), atol=ATOL, rtol=0)
    assert np.isclose(np.linalg.norm(got), 1.0, atol=1e-5)


def test_bucket_32_and_64_give_the_same_vector(models):
    """K2's rule runs bucket 32 at 64 on a card: padding past the real
    tokens must not move the mean."""
    _, _, tcfg, tparams = models
    ids = _ids(20, 20, tcfg.vocab_size)
    at32 = Embedder(tparams, tcfg, buckets=(32,)).embed(ids)
    at64 = Embedder(tparams, tcfg, buckets=(64,)).embed(ids)
    np.testing.assert_allclose(at32, at64, atol=1e-6, rtol=0)


def test_embed_is_deterministic_and_input_sensitive(models, embedders):
    port, _ = embedders
    ids = _ids(3, 9, models[2].vocab_size)
    np.testing.assert_array_equal(port.embed(ids), port.embed(ids))
    assert not np.allclose(port.embed(ids), port.embed(ids[:-1] + [7]))


def test_embed_refusals_match_the_reference(models, embedders):
    port, ref = embedders
    for emb in (port, ref):
        with pytest.raises(ValueError, match="exceeds the embedding bucket "
                                             "cap 64"):
            emb.embed(list(range(1, 66)))
        with pytest.raises(ValueError, match="empty"):
            emb.embed([])


def test_cuda_pads_buckets_to_the_kernel_tile(models):
    """The public buckets stay the reference's; on a card each runs at
    the next multiple of K2's tile (64)."""
    _, _, tcfg, tparams = models
    emb = Embedder(tparams, tcfg, warmup=False)
    assert emb.buckets == (32, 64, 128, 256, 512, 1024)
    assert [emb.rows(b) for b in emb.buckets] == list(emb.buckets)
    emb.device = torch.device("cuda")  # the rule alone: nothing runs
    assert [emb.rows(b) for b in emb.buckets] == [64, 64, 128, 256, 512,
                                                  1024]
