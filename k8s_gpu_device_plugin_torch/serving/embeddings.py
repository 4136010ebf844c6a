"""Embeddings for the serving pod: mean-pooled final hidden states.

Port of ``k8s_gpu_device_plugin_tpu/serving/embeddings.py``, behind
``POST /v1/embeddings``: the final RMS-normed hidden states of the model
the pod serves (``models/llama.py::forward_with_aux(return_hidden=True)``),
averaged in f32 over the REAL tokens (padding masked out of the mean)
and L2-normalized, so cosine similarity is a dot product.

On a card the forward's attention is the flash forward kernel (K2) at
B 1 and S the padded bucket, one launch a layer. Not served with
weight-only quantized weights: the hidden-state forward takes float
leaves, so the CLI refuses ``--embeddings`` with ``--weightQuant``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from k8s_gpu_device_plugin_torch.models.batching import DEFAULT_PROMPT_BUCKETS
from k8s_gpu_device_plugin_torch.models.llama import (
    LlamaConfig,
    forward_with_aux,
)
from k8s_gpu_device_plugin_torch.serving.bucketed import BucketedForward


def _embed_one(params, tokens: torch.Tensor, length: int, cfg: LlamaConfig,
               plain_attention: bool = False) -> torch.Tensor:
    """(P,) padded ids + real length -> (D,) f32 unit-norm mean-pooled
    embedding."""
    hidden, _ = forward_with_aux(params, tokens[None, :], cfg,
                                 return_hidden=True,
                                 plain_attention=plain_attention)  # (1, P, D)
    mask = (torch.arange(tokens.shape[0], device=tokens.device)
            < length)[None, :, None]
    summed = torch.where(mask, hidden.float(), 0.0).sum(dim=1)
    mean = summed / max(length, 1)
    return (mean / torch.linalg.vector_norm(mean, dim=-1, keepdim=True))[0]


class Embedder(BucketedForward):
    """Bucketed, thread-safe embedding of token lists over the serving
    weights (the lock, warm-up and stream discipline of
    ``serving/bucketed.py``). ``plain_attention`` runs the plain
    attention on any device: the comparison path a card run holds the
    kernel path against."""

    def __init__(self, params, cfg: LlamaConfig,
                 buckets: tuple[int, ...] = DEFAULT_PROMPT_BUCKETS,
                 warmup: bool = True, plain_attention: bool = False):
        super().__init__(functools.partial(_embed_one,
                                           plain_attention=plain_attention),
                         params, cfg, buckets, kind="embedding",
                         warmup=warmup)
        self.dim = cfg.d_model

    def embed(self, ids: list[int]) -> np.ndarray:
        return self.dispatch(ids).numpy().astype(np.float32)
