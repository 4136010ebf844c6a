"""Training step: loss, the optimizer and the step function.

Port of ``k8s_gpu_device_plugin_tpu/models/train.py`` for one device.
The reference jits a step over a mesh and lets optax update functional
pytrees; here the step runs eagerly and updates the parameters and the
optimizer moments IN PLACE (the state dict it is given is the state dict
it returns), which keeps one copy of each on the card.

The optimizer is the reference's optax chain written out over tensor
lists, with optax's numerics:

- ``warmup_cosine_decay_schedule(0, lr, warmup, max(total, warmup + 1))``,
  evaluated at the update count *before* it is incremented, so the first
  update has learning rate 0;
- ``clip_by_global_norm``: no epsilon, ``g`` kept where the global norm
  is below the limit, else ``g / norm * limit``;
- ``adamw``: moments in the parameter dtype, bias correction at
  ``count + 1``, ``eps`` outside the square root, weight decay on every
  leaf;
- the ``grad_norm`` metric is the global norm before clipping.

Each leaf's update is computed in f32 and rounded once into the stored
dtype (bf16 moments and parameters round where XLA's fused update
rounds; in f32 this is optax's arithmetic).
"""

from __future__ import annotations

import math
from typing import Callable

import numpy as np
import torch

from k8s_gpu_device_plugin_torch.device import resolve_device
from k8s_gpu_device_plugin_torch.models.llama import (
    LlamaConfig,
    cast_params_for_compute,
    forward_with_aux,
    init_params,
)

# one z-loss weight for every loss path, as in the reference
Z_LOSS_WEIGHT = 1e-4


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                  z_loss_weight: float = Z_LOSS_WEIGHT,
                  with_accuracy: bool = True):
    """Mean token cross-entropy (f32) + z-loss; returns (loss, accuracy).
    ``with_accuracy=False`` skips the argmax and reports accuracy -1."""
    logits = logits.float()
    logsumexp = torch.logsumexp(logits, dim=-1)
    target_logit = torch.gather(logits, -1, targets.long()[..., None])[..., 0]
    nll = logsumexp - target_logit
    z_loss = z_loss_weight * logsumexp.square()
    if with_accuracy:
        accuracy = (logits.argmax(dim=-1) == targets).float().mean()
    else:
        accuracy = torch.full((), -1.0, device=logits.device)
    return (nll + z_loss).mean(), accuracy


# --- the optimizer ------------------------------------------------------------


def warmup_cosine_decay_schedule(init_value: float, peak_value: float,
                                 warmup_steps: int, decay_steps: int,
                                 end_value: float = 0.0
                                 ) -> Callable[[int], float]:
    """optax's schedule of the same name: linear from ``init_value`` to
    ``peak_value`` over ``warmup_steps``, then a cosine to ``end_value``
    at ``decay_steps``."""
    cos_steps = decay_steps - warmup_steps
    if cos_steps <= 0:
        raise ValueError(
            f"decay_steps {decay_steps} must exceed warmup_steps {warmup_steps}"
        )
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value

    def schedule(count: int) -> float:
        if count < warmup_steps:
            frac = 1 - min(max(count, 0), warmup_steps) / warmup_steps
            return (init_value - peak_value) * frac + peak_value
        c = min(count - warmup_steps, cos_steps)
        cosine = 0.5 * (1 + math.cos(math.pi * c / cos_steps))
        return peak_value * ((1 - alpha) * cosine + alpha)

    return schedule


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares over every tensor, as an f32 scalar."""
    return torch.sqrt(sum(t.float().square().sum() for t in tensors))


class AdamW:
    """``optax.chain(clip_by_global_norm(clip), adamw(schedule, b1, b2,
    eps, weight_decay))`` over lists of tensors. State:
    ``{"count": int, "mu": [...], "nu": [...]}``, moments in the
    parameters' dtype."""

    def __init__(self, schedule: Callable[[int], float], *, b1: float,
                 b2: float, weight_decay: float, clip: float,
                 eps: float = 1e-8) -> None:
        self.schedule = schedule
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay = weight_decay
        self.clip = clip

    def init(self, params: list) -> dict:
        return {"count": 0,
                "mu": [torch.zeros_like(p) for p in params],
                "nu": [torch.zeros_like(p) for p in params]}

    @torch.no_grad()
    def update(self, grads: list, state: dict, params: list) -> torch.Tensor:
        """Apply one update to ``params`` and ``state`` in place; returns
        the global norm of ``grads`` (before clipping)."""
        b1, b2 = self.b1, self.b2
        g_norm = global_norm(grads)
        keep = g_norm < self.clip
        lr = self.schedule(state["count"])
        state["count"] += 1
        bc1 = 1 - b1 ** state["count"]
        bc2 = 1 - b2 ** state["count"]
        for p, g, mu, nu in zip(params, grads, state["mu"], state["nu"]):
            g = g.float()
            g = torch.where(keep, g, g / g_norm * self.clip)
            m = (1 - b1) * g + b1 * mu.float()
            v = (1 - b2) * g.square() + b2 * nu.float()
            mu.copy_(m)
            nu.copy_(v)
            u = (m / bc1) / (torch.sqrt(v / bc2) + self.eps)
            u = u + self.weight_decay * p.float()
            p.copy_(p.float() + u * (-lr))
        return g_norm


def make_optimizer(learning_rate: float = 3e-4, weight_decay: float = 0.1,
                   b1: float = 0.9, b2: float = 0.95, grad_clip: float = 1.0,
                   warmup_steps: int = 100, total_steps: int = 10000,
                   impl: str = "optax") -> AdamW:
    """AdamW with a warmup-cosine schedule and global-norm clipping."""
    if impl == "fused":
        raise NotImplementedError(
            "opt_impl='fused' (ops/fused_optim.py) is not ported yet "
            "(ROADMAP A8); use 'optax'"
        )
    if impl != "optax":
        raise ValueError(f"unknown optimizer impl {impl!r}")
    schedule = warmup_cosine_decay_schedule(
        0.0, learning_rate, warmup_steps, max(total_steps, warmup_steps + 1)
    )
    return AdamW(schedule, b1=b1, b2=b2, weight_decay=weight_decay,
                 clip=grad_clip)


# --- loss and step ------------------------------------------------------------


def param_leaves(params: dict) -> list:
    """Every parameter tensor, in the dict's own (fixed) order."""
    out = []
    for value in params.values():
        out.extend(param_leaves(value) if isinstance(value, dict) else [value])
    return out


def loss_fn(params: dict, batch: dict, cfg: LlamaConfig,
            with_accuracy: bool = True, plain_attention: bool = False):
    """(loss, {"loss", "accuracy"}) of one batch {"inputs", "targets"}."""
    logits, _ = forward_with_aux(params, batch["inputs"], cfg,
                                 plain_attention=plain_attention)
    loss, accuracy = cross_entropy(logits, batch["targets"],
                                   with_accuracy=with_accuracy)
    return loss, {"loss": loss.detach(), "accuracy": accuracy}


def _grads(params: dict, batch: dict, cfg: LlamaConfig, **kw):
    """(grads of the loss by each of ``param_leaves(params)``, metrics)."""
    leaves = param_leaves(params)
    with torch.enable_grad():
        for p in leaves:
            p.requires_grad_(True)
        try:
            loss, metrics = loss_fn(params, batch, cfg, **kw)
            grads = torch.autograd.grad(loss, leaves)
        finally:
            for p in leaves:
                p.requires_grad_(False)
    return grads, metrics


def _split(batch: dict, micro: int, what: str) -> list:
    b = batch["inputs"].shape[0]
    if b % micro:
        raise ValueError(f"batch size {b} not divisible by {what} {micro}")
    n = b // micro
    return [{k: v[i * n:(i + 1) * n] for k, v in batch.items()}
            for i in range(micro)]


def make_train_step(cfg: LlamaConfig, optimizer: AdamW,
                    with_accuracy: bool = True, grad_accum: int = 1,
                    plain_attention: bool = False) -> Callable:
    """(state, batch) -> (state, metrics), updating ``state`` in place.

    ``grad_accum=A`` splits the batch into A microbatches, accumulates
    their gradients in f32 and divides by A before one update (cast back
    to the parameter dtype), as the reference's scan does; loss and
    accuracy are means over the microbatches. ``plain_attention`` runs
    ``mha_reference`` on any device: a comparison path, never training's.
    """
    kw = dict(with_accuracy=with_accuracy, plain_attention=plain_attention)

    def step(state: dict, batch: dict):
        params = state["params"]
        if grad_accum == 1:
            grads, metrics = _grads(params, batch, cfg, **kw)
        else:
            # the master-weight cast happens once, outside the microbatch
            # loop; its Jacobian is the identity, so accumulating the
            # compute-dtype grads and casting back is the exact chain rule
            with torch.no_grad():
                compute = cast_params_for_compute(params, cfg)
            acc = [torch.zeros_like(p, dtype=torch.float32)
                   for p in param_leaves(params)]
            stacked = []
            for mb in _split(batch, grad_accum, "grad_accum"):
                g, m = _grads(compute, mb, cfg, **kw)
                for a, gi in zip(acc, g):
                    a.add_(gi.float())
                stacked.append(m)
            grads = [(a / grad_accum).to(p.dtype)
                     for a, p in zip(acc, param_leaves(params))]
            metrics = {k: torch.stack([m[k] for m in stacked]).mean()
                       for k in stacked[0]}
        metrics["grad_norm"] = optimizer.update(
            list(grads), state["opt_state"], param_leaves(params)
        )
        state["step"] += 1
        return state, metrics

    return step


def make_eval_step(cfg: LlamaConfig, micro: int = 1) -> Callable:
    """(params, batch) -> {loss, accuracy}: one forward in the training
    numerics, no gradients; ``micro=A`` runs the batch in A chunks and
    averages, so eval fits wherever training fits."""

    @torch.no_grad()
    def step(params: dict, batch: dict) -> dict:
        parts = [loss_fn(params, mb, cfg)[1]
                 for mb in _split(batch, micro, "eval micro")]
        return {k: torch.stack([m[k] for m in parts]).mean() for k in parts[0]}

    return step


def init_train_state(cfg: LlamaConfig, optimizer: AdamW, *, seed: int = 0,
                     device: "str | torch.device | None" = "cuda",
                     params: "dict | None" = None) -> dict:
    """{"params", "opt_state", "step"}: ``params`` (random from ``seed``
    on ``device`` when None) and zero moments beside them."""
    if params is None:
        params = init_params(cfg, seed=seed, device=device)
    return {"params": params,
            "opt_state": optimizer.init(param_leaves(params)),
            "step": 0}


def synthetic_batch(cfg: LlamaConfig, batch_size: int, seq_len: int, *,
                    seed: int = 0,
                    device: "str | torch.device | None" = "cuda") -> dict:
    """Random next-token batch {"inputs", "targets"} (B, S) int64 from
    numpy's generator (the reference draws from ``jax.random``, which
    torch cannot reproduce; tests feed both the same numpy batch)."""
    dev = resolve_device(device)
    tokens = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (batch_size, seq_len + 1), dtype=np.int32
    )
    t = torch.from_numpy(tokens).to(dev).long()
    return {"inputs": t[:, :-1], "targets": t[:, 1:]}
