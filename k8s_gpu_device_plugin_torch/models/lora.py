"""LoRA: the low-rank factors and their merge.

Port of ``k8s_gpu_device_plugin_tpu/models/lora.py``'s configuration,
factors and merge: ``LoraConfig`` (rank, alpha, targets; ``scale`` =
alpha / rank), ``init_lora_params`` and ``merge_lora``. An adapter holds
rank-r factors A (in, r) and B (r, out) per target projection, stacked on
the layer axis like every other leaf, and stands for the weight
``W + scale * A @ B``. B starts at zero, so a fresh adapter is the base
model exactly.

Serving keeps the base weights and adds each row's delta instead
(``models/lora_serving.py``); ``merge_lora`` is the oracle the tests and
the card's run hold that path to. Training (``make_lora_train_step``,
``init_lora_state``) takes the loss of the merged weights and its
gradients by the factors alone: ``merge_lora`` is differentiable and the
base leaves never require grad, so they stay equal bit for bit. On the
card the step's attention runs the flash kernels forward and backward,
as the full train step's does; the merge and the products stay torch
(the reference leaves them to XLA).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable

import torch

from k8s_gpu_device_plugin_torch.device import resolve_device
from k8s_gpu_device_plugin_torch.models.llama import LlamaConfig
from k8s_gpu_device_plugin_torch.models.train import (
    AdamW,
    grads_by,
    param_leaves,
)

#: weight matrices LoRA can target (layer-stacked (L, in, out) leaves)
TARGETABLE = ("wq", "wk", "wv", "wo", "w1", "w2", "w3")


@dataclass(frozen=True)
class LoraConfig:
    rank: int = 8
    alpha: float = 16.0
    # which projections get factors; attention-only is the classic recipe
    targets: tuple = ("wq", "wk", "wv", "wo")

    def __post_init__(self) -> None:
        if self.rank < 1:
            raise ValueError(f"rank must be >= 1, got {self.rank}")
        bad = [t for t in self.targets if t not in TARGETABLE]
        if bad:
            raise ValueError(
                f"untargetable weights {bad}; choose from {TARGETABLE}"
            )

    @property
    def scale(self) -> float:
        return self.alpha / self.rank


def target_dims(cfg: LlamaConfig) -> dict[str, tuple[int, int]]:
    """(in, out) of every targetable projection of ``cfg``."""
    d, hd = cfg.d_model, cfg.head_dim
    return {
        "wq": (d, cfg.n_heads * hd),
        "wk": (d, cfg.n_kv_heads * hd),
        "wv": (d, cfg.n_kv_heads * hd),
        "wo": (cfg.n_heads * hd, d),
        "w1": (d, cfg.d_ff),
        "w3": (d, cfg.d_ff),
        "w2": (cfg.d_ff, d),
    }


def init_lora_params(cfg: LlamaConfig, lora: LoraConfig, *,
                     generator: torch.Generator,
                     device: "str | torch.device | None" = "cuda") -> dict:
    """``{target: {"a": (L, in, r), "b": (L, r, out)}}`` in ``cfg.dtype``
    on ``device``: A normal with std 1/sqrt(in), drawn in f32 from the
    explicit ``generator`` (which must live on ``device``); B zeros, so
    the adapted model starts equal to the base."""
    if getattr(cfg, "n_experts", 0) and any(
            t in ("w1", "w2", "w3") for t in lora.targets):
        raise NotImplementedError(
            "MoE expert MLPs are not LoRA-targetable (attention targets "
            "work on MoE configs)"
        )
    dev = resolve_device(device)
    dims = target_dims(cfg)
    L = cfg.n_layers
    out = {}
    for t in lora.targets:
        d_in, d_out = dims[t]
        a = torch.randn((L, d_in, lora.rank), dtype=torch.float32,
                        device=dev, generator=generator)
        out[t] = {
            "a": (a * (1.0 / math.sqrt(d_in))).to(cfg.dtype),
            "b": torch.zeros((L, lora.rank, d_out), dtype=cfg.dtype,
                             device=dev),
        }
    return out


def merge_lora(params: dict, lora_params: dict, lora: LoraConfig) -> dict:
    """Base params + factors -> merged params (``W + scale * A @ B`` per
    target, in f32, cast back to each leaf's dtype), as the reference
    merges: the oracle a served adapter is held to. The base tree is not
    mutated."""
    layers = dict(params["layers"])
    for t, ab in lora_params.items():
        delta = torch.einsum(
            "lir,lro->lio", ab["a"].float(), ab["b"].float()
        ) * lora.scale
        w = layers[t]
        layers[t] = (w.float() + delta.to(w.device)).to(w.dtype)
    return {**params, "layers": layers}


def lora_grads(base_params: dict, lora_params: dict, batch: dict,
               cfg: LlamaConfig, lora: LoraConfig,
               with_accuracy: bool = False, plain_attention: bool = False):
    """(gradients of the merged model's loss by each of
    ``param_leaves(lora_params)``, metrics). ``plain_attention`` runs
    ``mha_reference``: a comparison path, never training's."""
    return grads_by(param_leaves(lora_params),
                    lambda: merge_lora(base_params, lora_params, lora),
                    batch, cfg, with_accuracy=with_accuracy,
                    plain_attention=plain_attention)


def make_lora_train_step(base_params: dict, cfg: LlamaConfig,
                         lora: LoraConfig, optimizer: AdamW,
                         with_accuracy: bool = False) -> Callable:
    """(lora_state, batch) -> (lora_state, metrics), updating the
    factors and their moments in place (``models/train.py``'s
    convention); the base tree is read, never written. lora_state =
    ``{"lora", "opt_state", "step"}``; metrics carry ``grad_norm`` (the
    global norm before clipping)."""

    def step(state: dict, batch: dict):
        grads, metrics = lora_grads(base_params, state["lora"], batch, cfg,
                                    lora, with_accuracy=with_accuracy)
        metrics["grad_norm"] = optimizer.update(
            list(grads), state["opt_state"], param_leaves(state["lora"]))
        state["step"] += 1
        return state, metrics

    return step


def init_lora_state(cfg: LlamaConfig, lora: LoraConfig, optimizer: AdamW,
                    *, seed: int = 0,
                    generator: "torch.Generator | None" = None,
                    device: "str | torch.device | None" = "cuda") -> dict:
    """``{"lora", "opt_state", "step"}``: fresh factors (from
    ``generator``, else one seeded with ``seed`` on ``device``) and zero
    moments beside them."""
    if generator is None:
        generator = torch.Generator(device=resolve_device(device))
        generator.manual_seed(seed)
    lp = init_lora_params(cfg, lora, generator=generator, device=device)
    return {"lora": lp, "opt_state": optimizer.init(param_leaves(lp)),
            "step": 0}
