"""The port's beam search (``models/beam.py``) against the reference's.

A tiny f32 config (2 layers, vocabulary 16); the JAX weights are carried
across with ``params_from_jax``, the prompt is numpy-seeded. The port's
sequences must equal the reference's and its scores lie within 1e-4 of
them (f32 cumulative log-probabilities of a few steps, each summed in
another order). Within the port: beam 1 is the greedy decode, every
score is its sequence's log-probability under the full-context forward
(1e-4), beam == vocab is exhaustive over two steps, beam 1 on the tiny
MoE config is greedy, and ties break toward the lower flat index as
``lax.top_k``'s do.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_gpu_device_plugin_tpu.models import beam as jbeam
from k8s_gpu_device_plugin_tpu.models import llama as jllama
from k8s_gpu_device_plugin_torch.models import beam as tbeam
from k8s_gpu_device_plugin_torch.models import llama as tllama
from k8s_gpu_device_plugin_torch.models.convert import params_from_jax
from k8s_gpu_device_plugin_torch.models.generate import generate

torch.set_num_threads(1)

ATOL = 1e-4


def _port(vocab=16, seed=0, **kw):
    cfg = tllama.LlamaConfig.tiny(n_layers=2, vocab_size=vocab,
                                  dtype=torch.float32, **kw)
    return cfg, tllama.init_params(cfg, seed=seed, device="cpu")


def _prompt(n=6, vocab=16):
    ids = np.random.default_rng(5).integers(1, vocab, (1, n))
    return torch.from_numpy(ids.astype(np.int64))


@pytest.fixture(scope="module")
def both():
    jcfg = jllama.LlamaConfig.tiny(n_layers=2, vocab_size=16,
                                   dtype=jnp.float32)
    tcfg = tllama.LlamaConfig.tiny(n_layers=2, vocab_size=16,
                                   dtype=torch.float32)
    jparams = jllama.init_params(jax.random.key(0), jcfg)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                              device="cpu")
    return jcfg, jparams, tcfg, tparams


def _seq_logprob(params, prompt, cfg, seq) -> float:
    """Cumulative log-probability of ``seq`` after ``prompt`` under the
    full-context forward (the oracle for beam scores)."""
    tokens = torch.cat([prompt, seq[None, :].long()], dim=1)
    logp = torch.log_softmax(tllama.forward(params, tokens, cfg).float(), -1)
    p = prompt.shape[1]
    return sum(float(logp[0, p - 1 + j, int(seq[j])])
               for j in range(seq.shape[0]))


def test_beam_matches_the_reference(both):
    jcfg, jparams, tcfg, tparams = both
    prompt = _prompt()
    want_seqs, want_scores = jbeam.beam_search(
        jparams, jnp.asarray(prompt.numpy(), jnp.int32), jcfg, max_new=5,
        beam=3)
    seqs, scores = tbeam.beam_search(tparams, prompt, tcfg, max_new=5, beam=3)
    np.testing.assert_array_equal(seqs.numpy(), np.asarray(want_seqs))
    np.testing.assert_allclose(scores.numpy(), np.asarray(want_scores),
                               atol=ATOL, rtol=0)


def test_beam_one_is_greedy(both):
    _, _, cfg, params = both
    prompt = _prompt()
    seqs, _ = tbeam.beam_search(params, prompt, cfg, max_new=6, beam=1)
    assert torch.equal(seqs, generate(params, prompt, cfg, max_new=6))


def test_beam_scores_are_full_forward_logprobs_sorted(both):
    _, _, cfg, params = both
    prompt = _prompt()
    seqs, scores = tbeam.beam_search(params, prompt, cfg, max_new=4, beam=3)
    for r in range(3):
        assert abs(float(scores[r])
                   - _seq_logprob(params, prompt, cfg, seqs[r])) <= ATOL
    assert bool((scores[:-1] >= scores[1:]).all())


def test_beam_at_vocab_width_is_exhaustive_for_two_steps():
    """beam == vocab keeps every length-1 prefix, so for max_new=2 the
    search is exact: its best sequence is brute force's over all vocab^2
    continuations."""
    cfg, params = _port(vocab=12, seed=3)
    prompt = _prompt(vocab=12)
    seqs, scores = tbeam.beam_search(params, prompt, cfg, max_new=2, beam=12)
    pairs = torch.tensor(list(itertools.product(range(12), range(12))))
    p = prompt.shape[1]
    tokens = torch.cat([prompt.expand(144, p), pairs], dim=1)
    logp = torch.log_softmax(tllama.forward(params, tokens, cfg).float(), -1)
    lps = (logp[:, p - 1].gather(1, pairs[:, :1])[:, 0]
           + logp[:, p].gather(1, pairs[:, 1:])[:, 0])
    best = int(torch.argmax(lps))
    assert seqs[0].tolist() == pairs[best].tolist()
    assert abs(float(scores[0]) - float(lps[best])) <= ATOL


def test_beam_matches_or_beats_greedy(both):
    _, _, cfg, params = both
    prompt = _prompt()
    _, scores = tbeam.beam_search(params, prompt, cfg, max_new=5, beam=4)
    greedy = generate(params, prompt, cfg, max_new=5)
    assert float(scores[0]) >= _seq_logprob(params, prompt, cfg,
                                            greedy[0]) - 1e-5


@pytest.mark.parametrize("prompt,kw,err,match", [
    ([[1, 2, 3]], {"beam": 0}, ValueError, "beam"),
    ([[1, 2], [3, 4]], {"beam": 2}, NotImplementedError, "one prompt"),
    ([[1, 2, 3]], {"beam": 17}, ValueError, "vocab_size"),
    ([[1, 2, 3]], {"beam": 2, "max_new": 0}, ValueError, "max_new"),
])
def test_beam_validation(both, prompt, kw, err, match):
    _, _, cfg, params = both
    kw = {"max_new": 2, **kw}
    with pytest.raises(err, match=match):
        tbeam.beam_search(params, torch.tensor(prompt), cfg, **kw)


def test_beam_one_is_greedy_moe():
    """Beam rides ``_forward_cached``, so MoE configs work unchanged."""
    cfg = tllama.LlamaConfig.tiny(n_layers=1, n_experts=4,
                                  capacity_factor=8.0, dtype=torch.float32)
    params = tllama.init_params(cfg, seed=0, device="cpu")
    prompt = _prompt(vocab=cfg.vocab_size)
    seqs, _ = tbeam.beam_search(params, prompt, cfg, max_new=4, beam=1)
    assert torch.equal(seqs, generate(params, prompt, cfg, max_new=4))


def test_top_k_breaks_ties_as_lax_top_k():
    """Equal candidates (two beams that share a parent's score) come out
    lower flat index first, as ``lax.top_k``'s do."""
    x = np.random.default_rng(2).integers(0, 4, 64).astype(np.float32)
    for k in (1, 5, 17, 64):
        want_v, want_i = jax.lax.top_k(jnp.asarray(x), k)
        got_v, got_i = tbeam._top_k(torch.from_numpy(x), k)
        np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
        np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
