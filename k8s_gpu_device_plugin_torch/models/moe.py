"""Mixture-of-Experts MLP (GShard/Switch-style dense dispatch).

Port of ``k8s_gpu_device_plugin_tpu/models/moe.py``: ``expert_capacity``,
``router_topk``, ``load_balance_loss``, ``make_dispatch_combine``,
``_group_size``, ``_expert_mm``, ``moe_mlp`` with its routing groups, and
``moe_param_init``, with the reference's algebra and leaf layout. Plain
functions on tensors; autograd carries the backward, as it does for the
dense MLP. The reference's ``constrain`` and ``moe_param_specs`` place
the expert axis on a mesh; the port has no mesh yet (ROADMAP A.13), so
they have no counterpart.

Routing is the reference's: f32 router logits (:func:`router_logits`),
renormalised top-k softmax gates, capacity-based one-hot dispatch and
combine tensors (B, S, E, C) built from cumsum positions, tokens over
capacity dropped. The expert products are batched ``torch.matmul``
over the expert axis (int8 codes under ``quant="int8"``): the reference
leaves them to XLA, outside any Pallas kernel. Serving's decode MLP (``models/generate.py``) computes
every expert and mixes them by the gates instead: no capacity, no drops.
"""

from __future__ import annotations

import math
from typing import TYPE_CHECKING, Callable

import torch
import torch.nn.functional as F

from k8s_gpu_device_plugin_torch.ops.quant import int8_expert_matmul

if TYPE_CHECKING:  # pragma: no cover
    from k8s_gpu_device_plugin_torch.models.llama import LlamaConfig

#: the expert stacks, in the order they are drawn within a layer
EXPERT_LEAVES = ("moe_w1", "moe_w3", "moe_w2")


def expert_capacity(cfg: "LlamaConfig", seq_len: int) -> int:
    """Per-expert token-slot budget for one batch row (or routing
    group): k slots a token over E experts, times ``capacity_factor``,
    and never below k."""
    k = cfg.n_experts_per_token
    ideal = seq_len * k / cfg.n_experts
    return max(int(math.ceil(ideal * cfg.capacity_factor)), k)


def router_logits(h: torch.Tensor, router: torch.Tensor) -> torch.Tensor:
    """(..., D) x (D, E) -> f32 logits (..., E). The product runs in f64
    and is rounded once to f32: at least as exact as an f32 product, and
    no TF32 setting of the process can move a top-k decision."""
    return (h.double() @ router.double()).float()


def router_topk(router_logits: torch.Tensor, k: int) -> tuple:
    """(B, S, E) f32 logits -> (gates (B, S, k), expert idx (B, S, k),
    probs (B, S, E)): the top-k softmax probabilities renormalised to sum
    to one (Mixtral)."""
    probs = torch.softmax(router_logits, dim=-1)
    gates, idx = torch.topk(probs, k, dim=-1)
    gates = gates / torch.clamp(gates.sum(dim=-1, keepdim=True), min=1e-9)
    return gates, idx, probs


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """f32 one-hot over a new last axis; an index outside [0, n) (the
    dispatch's -1 "no slot") gives a zero row."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).float()


def load_balance_loss(probs: torch.Tensor, idx: torch.Tensor,
                      n_experts: int) -> torch.Tensor:
    """Switch-transformer aux loss: E * sum_e fraction_e * mean_prob_e
    (1 at uniform routing), the fraction over all k assignments."""
    assign = _one_hot(idx, n_experts)                    # (B, S, k, E)
    fraction = assign.sum(dim=2).mean(dim=(0, 1))        # (E,)
    fraction = fraction / torch.clamp(fraction.sum(), min=1e-9)
    mean_prob = probs.mean(dim=(0, 1))                   # (E,)
    return n_experts * (fraction * mean_prob).sum()


def make_dispatch_combine(gates: torch.Tensor, idx: torch.Tensor,
                          n_experts: int, capacity: int) -> tuple:
    """(B, S, E, C) dispatch mask and combine weights. A slot's position
    in its expert's buffer is a cumsum over the flattened (S * k)
    token-slot axis of its row (f32, exact to 2^24); slots at or past
    ``capacity`` get no position (-1) and are dropped, their gate mass
    lost (GShard)."""
    b, s, k = gates.shape
    flat = _one_hot(idx, n_experts).reshape(b, s * k, n_experts)
    pos = torch.cumsum(flat, dim=1) * flat - 1.0
    within = flat * (pos < capacity).float()
    slot = torch.where(within > 0, pos, torch.full_like(pos, -1.0)).to(
        torch.int32)
    dispatch = _one_hot(slot, capacity).reshape(b, s, k, n_experts, capacity)
    combine = (dispatch * gates[..., None, None]).sum(dim=2)
    return dispatch.sum(dim=2), combine


def _group_size(requested: int, seq_len: int) -> int:
    """The largest divisor of ``seq_len`` not above ``requested`` (the
    whole row when ``requested`` is 0 or not below it)."""
    if requested <= 0 or requested >= seq_len:
        return seq_len
    for g in range(requested, 0, -1):
        if seq_len % g == 0:
            return g
    return seq_len  # unreachable: 1 always divides


def _expert_mm(x: torch.Tensor, w: torch.Tensor,
               cfg: "LlamaConfig") -> torch.Tensor:
    """(E, B, C, K) x (E, K, N) -> (E, B, C, N), one product per expert;
    through ``ops.quant.int8_expert_matmul`` under ``quant="int8"`` (a
    custom op the remat policy saves, as the reference names its output
    ``"quant_dot"``)."""
    e, b, c, k = x.shape
    if cfg.quant == "int8":
        out = int8_expert_matmul(x.reshape(e, b * c, k), w)
    else:
        out = torch.matmul(x.reshape(e, b * c, k), w)
    return out.reshape(e, b, c, -1)


def moe_mlp(h: torch.Tensor, layer: dict, cfg: "LlamaConfig") -> tuple:
    """Sparse SwiGLU MoE layer: (B, S, D) -> ((B, S, D), aux losses).
    ``layer`` carries ``router`` (D, E) and the expert stacks ``moe_w1``/
    ``moe_w3`` (E, D, F) and ``moe_w2`` (E, F, D). A row longer than
    ``cfg.moe_group_size`` is cut into routing groups (its largest
    divisor not above the size): capacity and dispatch are per group,
    routing stays per token."""
    b, s, d = h.shape
    e, k = cfg.n_experts, cfg.n_experts_per_token
    g = _group_size(cfg.moe_group_size, s)
    if g < s:
        out, aux = moe_mlp(h.reshape(b * (s // g), g, d), layer,
                           cfg.with_group_size(0))
        return out.reshape(b, s, d), aux
    capacity = expert_capacity(cfg, s)
    logits = router_logits(h, layer["router"])
    gates, idx, probs = router_topk(logits, k)
    aux = {
        "moe_load_balance": load_balance_loss(probs, idx, e),
        "moe_router_z": torch.logsumexp(logits, dim=-1).square().mean(),
    }
    dispatch, combine = make_dispatch_combine(gates, idx, e, capacity)
    # tokens -> per-expert buffers
    expert_in = torch.einsum("bsec,bsd->ebcd", dispatch.to(cfg.dtype), h)
    gate = F.silu(_expert_mm(expert_in, layer["moe_w1"], cfg).float()).to(
        cfg.dtype)
    up = _expert_mm(expert_in, layer["moe_w3"], cfg)
    expert_out = _expert_mm(gate * up, layer["moe_w2"], cfg)
    # per-expert buffers -> tokens, gate-weighted
    out = torch.einsum("bsec,ebcd->bsd", combine.to(cfg.dtype), expert_out)
    return out, aux


def moe_param_init(cfg: "LlamaConfig", draw: Callable,
                   expert_leaf: "Callable | None" = None) -> dict:
    """The router (L, D, E) in f32 and the stacked expert weights
    (L, E, ...) in ``cfg.p_dtype``. ``draw(shape, std)`` is the caller's
    f32 truncated-normal draw (``models/llama.py::init_params``). The
    router is drawn first, then layer by layer that layer's ``moe_w1``,
    ``moe_w3`` and ``moe_w2``. ``expert_leaf`` maps one layer's
    (E, in, out) stack to what is stored (a quantized leaf dict, say):
    with it the float stacks never exist beyond one layer, and since a
    layer's draws do not depend on what is stored, the result equals
    mapping each layer of the float stacks afterwards, bit for bit."""
    L, e, d, f = cfg.n_layers, cfg.n_experts, cfg.d_model, cfg.d_ff
    std = 0.02
    out_std = std / math.sqrt(2 * L)
    shapes = {"moe_w1": ((e, d, f), std), "moe_w3": ((e, d, f), std),
              "moe_w2": ((e, f, d), out_std)}
    out = {"router": draw((L, d, e), std)}
    for i in range(L):
        for name in EXPERT_LEAVES:
            shape, scale = shapes[name]
            leaf = draw(shape, scale).to(cfg.p_dtype)
            if expert_leaf is not None:
                leaf = expert_leaf(leaf)
            store_layer(out, name, i, L, leaf)
    return out


def store_layer(out: dict, name: str, i: int, n_layers: int, leaf) -> None:
    """Copy one layer's leaf (a tensor or a dict of tensors) into layer
    ``i`` of the stacked leaf ``out[name]``, allocated at the first
    layer."""
    if isinstance(leaf, dict):
        stack = out.setdefault(name, {})
        for key, x in leaf.items():
            if key not in stack:
                stack[key] = x.new_empty((n_layers, *x.shape))
            stack[key][i] = x
        return
    if name not in out:
        out[name] = leaf.new_empty((n_layers, *leaf.shape))
    out[name][i] = leaf
