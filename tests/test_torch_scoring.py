"""The port's ``Scorer`` against the reference's.

A tiny f32 config with 2 layers; the JAX weights carried across with
``params_from_jax``; ids from a seed with numpy. ``score_full`` of the
port and of the JAX ``Scorer`` agree on the same ids within 1e-4 (the
per-token logprobs and the top-5 logprobs), the top-5 ids equal away
from near ties, on the short (bucketed) path and the long (chunked,
``chunk`` 8, ``max_len`` 64) path. Inside the port: the long path equals
the short path on a prompt both take, a 20-token prompt scores the same
at bucket 32 and at 64 (K2's rule runs 32 as 64 on a card), and the
scores equal a log-softmax of the port's own forward.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_gpu_device_plugin_torch.models import llama as tllama
from k8s_gpu_device_plugin_torch.models.convert import params_from_jax
from k8s_gpu_device_plugin_torch.serving.scoring import TOP_K, Scorer
from k8s_gpu_device_plugin_tpu.models import llama as jllama
from k8s_gpu_device_plugin_tpu.serving import scoring as jscore

# the suite runs in several worker processes on shared cores: one
# intra-op thread each keeps torch's OpenMP pool from spinning against
# them (these shapes gain nothing from more)
torch.set_num_threads(1)

ATOL = 1e-4
NEAR_TIE = 1e-3  # top-k neighbours closer than this may swap ids
LONG = dict(buckets=(16,), max_len=64, chunk=8)


@pytest.fixture(scope="module")
def models():
    jcfg = jllama.LlamaConfig.tiny(dtype=jnp.float32)
    tcfg = tllama.LlamaConfig.tiny(dtype=torch.float32)
    jparams = jllama.init_params(jax.random.key(0), jcfg)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                              device="cpu")
    return jcfg, jparams, tcfg, tparams


def _ids(seed: int, n: int, vocab: int) -> list[int]:
    return np.random.default_rng(seed).integers(1, vocab, n).tolist()


def _assert_scores_match(got, want, atol=ATOL):
    lps, top_lps, top_ids = got
    wlps, wtop_lps, wtop_ids = want
    assert lps[0] is None and wlps[0] is None and len(lps) == len(wlps)
    np.testing.assert_allclose(lps[1:], wlps[1:], atol=atol, rtol=0)
    np.testing.assert_allclose(top_lps, np.asarray(wtop_lps), atol=atol,
                               rtol=0)
    # ids equal wherever the ranking is not a near tie
    gaps = np.diff(np.asarray(wtop_lps), axis=1)  # (n, K-1), <= 0
    clear = np.ones_like(top_ids, dtype=bool)
    clear[:, :-1] &= -gaps >= NEAR_TIE
    clear[:, 1:] &= -gaps >= NEAR_TIE
    np.testing.assert_array_equal(np.asarray(top_ids)[clear],
                                  np.asarray(wtop_ids)[clear])


@pytest.fixture(scope="module")
def short_scorers(models):
    jcfg, jparams, tcfg, tparams = models
    return (Scorer(tparams, tcfg, buckets=(32, 64)),
            jscore.Scorer(jparams, jcfg, buckets=(32, 64), max_len=64))


@pytest.mark.parametrize("n", [1, 2, 10, 32, 50])
def test_short_path_matches_the_reference(models, short_scorers, n):
    port, ref = short_scorers
    ids = _ids(100 + n, n, models[2].vocab_size)
    got = port.score_full(ids)
    assert got[1].shape == got[2].shape == (n, TOP_K)
    _assert_scores_match(got, ref.score_full(ids))


@pytest.mark.parametrize("n", [17, 40, 64])
def test_long_path_matches_the_reference(models, n):
    """Chunks of 8 through the cached forward, teacher-forced across the
    chunk boundaries, a batch-1 dense cache of 64 rows."""
    jcfg, jparams, tcfg, tparams = models
    ids = _ids(200 + n, n, tcfg.vocab_size)
    port = Scorer(tparams, tcfg, **LONG)
    ref = jscore.Scorer(jparams, jcfg, **LONG)
    _assert_scores_match(port.score_full(ids), ref.score_full(ids))


def test_long_path_equals_the_bucketed_path(models):
    _, _, tcfg, tparams = models
    ids = _ids(7, 40, tcfg.vocab_size)
    chunked = Scorer(tparams, tcfg, **LONG).score_full(ids)
    wide = Scorer(tparams, tcfg, buckets=(64,), max_len=64).score_full(ids)
    _assert_scores_match(chunked, wide)


def test_bucket_32_and_64_give_the_same_scores(models):
    _, _, tcfg, tparams = models
    ids = _ids(20, 20, tcfg.vocab_size)
    at32 = Scorer(tparams, tcfg, buckets=(32,), max_len=32).score_full(ids)
    at64 = Scorer(tparams, tcfg, buckets=(64,), max_len=64).score_full(ids)
    _assert_scores_match(at32, at64, atol=1e-6)


def test_scores_equal_the_forward_oracle(models, short_scorers):
    """Token t's score is log_softmax(forward)[t - 1, ids[t]]; the top-5
    are that row's five largest."""
    _, _, tcfg, tparams = models
    port, _ = short_scorers
    ids = _ids(5, 24, tcfg.vocab_size)
    logits = tllama.forward(tparams, torch.tensor([ids]), tcfg)[0]
    lp = torch.log_softmax(logits.float(), dim=-1).detach()
    lps, top_lps, top_ids = port.score_full(ids)
    want = [float(lp[i - 1, ids[i]]) for i in range(1, len(ids))]
    np.testing.assert_allclose(lps[1:], want, atol=1e-5, rtol=0)
    np.testing.assert_array_equal(top_ids[1:, 0],
                                  lp[:-1].argmax(-1).numpy())
    assert (np.diff(top_lps[1:], axis=1) <= 0).all()
    assert not top_lps[0].any() and not top_ids[0].any()


def test_caps_and_refusals_match_the_reference(models):
    jcfg, jparams, tcfg, tparams = models
    port = Scorer(tparams, tcfg, **LONG)
    with pytest.raises(ValueError, match="cap 64"):
        port.score_full(list(range(1, 66)))
    with pytest.raises(ValueError, match="below the smallest"):
        Scorer(tparams, tcfg, buckets=(32,), max_len=16, warmup=False)
    # a cap below the largest bucket trims the buckets, as the reference's
    trimmed = Scorer(tparams, tcfg, buckets=(16, 32, 64), max_len=32,
                     warmup=False)
    ref = jscore.Scorer(jparams, jcfg, buckets=(16, 32, 64), max_len=32,
                        warmup=False)
    assert trimmed.buckets == ref.buckets == (16, 32)
    assert port._cache_len() == 64
    assert Scorer(tparams, tcfg, max_len=4096, warmup=False)._cache_len() \
        == 4096
