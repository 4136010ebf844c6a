"""Tensor-parallel serving: the decode path over a tp-shard mesh.

Port of ``k8s_gpu_device_plugin_tpu/parallel/tp_serving.py``. The
contract is the reference's: greedy and seeded token and logprob streams
at tp > 1 are those of tp = 1 bit for bit, so serving shards only what
stays exact:

- **Column shards** (``wq``/``wk``/``wv`` and the Qwen2 biases,
  ``w1``/``w3``, ``lm_head``): each shard computes its output columns
  from the whole contraction, so a shard's columns are the tp = 1
  product's columns where the matmul keeps its K order for a narrower N
  (the CPU tests pin it at small widths; ``chip_smoke.py``'s
  ``tp_gemm_probe`` asks the card).
- **Head shards** (the KV cache, dense rows and the paged pool alike,
  its scale planes, and the q/k/v/attention activations): attention
  never crosses a head, so each shard's heads are the tp = 1 heads.
- **Replicated reductions** (``wo``, ``w2``, sampling): the activation
  is gathered (a ``torch.cat``, pure data movement) and the contraction
  runs whole, once on every distinct device of the mesh.

``cfg.tp_allow_psum`` is the explicit opt-out: ``wo``/``w2`` row-shard
on their contraction axes and the shards' partial products are summed,
one gather fewer per layer, at the price of the bit-identity pin.

The reference is one controller over a ``jax.sharding.Mesh``, with a
thread-local mesh scope its kernels' dispatchers read (``ambient_mesh``).
Torch has no such scope, and the port has no ``ambient_mesh``: the mesh
travels explicitly, on the sharded weights (:class:`ShardedParams`) and
on the sharded cache (``models/generate.ShardedKVCache``), as a jax
array carries its sharding. A forward of a tp > 1 config that is not
handed both raises. The ``shard_map`` over the KV-head axis becomes a
loop over shards in ``models/generate.py``: each shard writes its own
heads' cache rows and launches the attention kernel on its own q heads
and its own contiguous KV planes.

A :class:`ServingMesh` is ``tp`` torch devices, one a shard, and may name
one device more than once. Torch has no counterpart of XLA's forced host
device count (the reference's tests get 8 CPU devices that way), so the
CPU tests pass ``["cpu"] * tp`` and a one-card run ``["cuda:0"] * tp``;
with no list, the mesh is the first ``tp`` visible cards under the
reference's flag rule (``MeshSpec.from_flags(..., exact=True)``). Where
devices repeat, a replicated leaf is one tensor shared by every shard,
and a column shard is a strided view of the whole leaf: the weights cost
no byte more than at tp = 1.

On a card the column pin holds where cuBLAS keeps a product's K order
for the narrower N. Under torch's default workspace it does not for
every shape: at Llama-3-8B's widths ``wq``'s shards at M <= 32 and
``wk``/``wv``'s at M 256, tp 4, differ from the whole product's columns
by up to 0.03 (``tools/torch_tp_gemm_probe.py``), and the streams part.
With no cuBLAS workspace (:data:`EXACT_CUBLAS_ENV`, read when the
process makes its first cuBLAS handle) every shard equals the whole
product's columns, and the streams are tp = 1's bit for bit, the tp = 1
twin run under the same setting. The server's ``--tp`` > 1 sets it when
the environment does not; the batcher warns at tp > 1 on a card without
it. The CPU's bf16 products keep the K order at the tests' small widths
but not at Llama-3-8B's: there the shards of ``wq``, ``wk``, ``wv``,
``w1`` and ``w3`` differ from the whole product's columns at M >= 32 by
up to 0.016 (``tools/torch_tp_gemm_probe.py --cpu``), so a CPU mesh at
those widths is not held to tp = 1's bits.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import torch

from k8s_gpu_device_plugin_torch.parallel.mesh import MeshSpec

#: placement markers of :func:`serving_param_specs`: the leaf's output
#: (last) axis split over the shards, its contraction (second-to-last)
#: axis split, or the whole leaf on every shard
COL, ROW, REP = "col", "row", "rep"
#: the KV cache's head axis, third from last in both layouts: dense
#: (L, B, S, Hkv, hd) and paged (L, n_pages, page_size, Hkv, hd)
KV_HEAD_AXIS = -2


#: cuBLAS with no workspace: no split-K that reduces through one, so a
#: column shard's product keeps the whole product's K order on a card
EXACT_CUBLAS_ENV = {"CUBLAS_WORKSPACE_CONFIG": ":0:0"}


def exact_cublas() -> bool:
    """Whether this process's environment asks cuBLAS for no workspace
    (:data:`EXACT_CUBLAS_ENV`): the setting under which tp > 1 streams
    are tp = 1's bit for bit on a card."""
    return all(os.environ.get(k) == v for k, v in EXACT_CUBLAS_ENV.items())


def _norm_device(d) -> torch.device:
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return d


@dataclass(frozen=True)
class ServingMesh:
    """``tp`` shards, shard ``i`` on ``devices[i]`` (a device may repeat).
    ``distinct`` is each device once, in shard order: the replicated
    work runs once on each."""

    devices: tuple

    @property
    def tp(self) -> int:
        return len(self.devices)

    @property
    def distinct(self) -> tuple:
        return tuple(dict.fromkeys(self.devices))

    @property
    def primary(self) -> torch.device:
        """Shard 0's device: where the batch state, the per-slot inputs
        and the forward's logits live."""
        return self.devices[0]

    def first_shard_on(self, device) -> int:
        return self.devices.index(device)


def serving_mesh(tp: int, n_kv_heads: int,
                 devices: "list | tuple | None" = None) -> ServingMesh:
    """A ``tp``-shard mesh over the first ``tp`` entries of ``devices``
    (default: the visible CUDA cards), validated by the shared flag rule
    (``MeshSpec.from_flags``): tp must divide both the device count and
    the KV-head count, failing at startup with an actionable error."""
    n = len(devices) if devices is not None else torch.cuda.device_count()
    MeshSpec.from_flags(tp=tp, n_devices=n, n_kv_heads=n_kv_heads,
                        exact=True)
    if devices is None:
        devices = [torch.device("cuda", i) for i in range(tp)]
    return ServingMesh(tuple(_norm_device(d) for d in list(devices)[:tp]))


def serving_param_specs(cfg) -> dict:
    """Placement marker per serving parameter (:data:`COL`, :data:`ROW`,
    :data:`REP`): column shards where a slice is the whole product's
    columns, replicated wherever a shard would split a reduction (``wo``
    and ``w2`` row-shard only under ``cfg.tp_allow_psum``). ``d_ff`` or a
    vocabulary that tp does not divide replicates; only the KV-head
    divisibility is a startup requirement."""
    tp = max(1, int(cfg.tp))
    ff_ok = cfg.d_ff % tp == 0
    psum_ok = bool(getattr(cfg, "tp_allow_psum", False))
    layers = {
        "attn_norm": REP, "mlp_norm": REP,
        # q/k/v columns are head-aligned (tp | n_kv_heads | n_heads)
        "wq": COL, "wk": COL, "wv": COL,
        "wo": ROW if psum_ok else REP,
    }
    if cfg.attn_bias:
        layers.update({"bq": COL, "bk": COL, "bv": COL})
    if cfg.is_moe:
        # the dense-mix decode MLP contracts over experts and d_ff both:
        # no bit-safe column cut, it runs whole
        layers.update({"router": REP, "moe_w1": REP, "moe_w2": REP,
                       "moe_w3": REP})
    else:
        layers.update({
            "w1": COL if ff_ok else REP,
            "w3": COL if ff_ok else REP,
            "w2": ROW if (psum_ok and ff_ok) else REP,
        })
    out = {"embed": REP, "layers": layers, "final_norm": REP}
    if not cfg.tied_embeddings:
        out["lm_head"] = COL if cfg.vocab_size % tp == 0 else REP
    return out


def _placement(spec: str, leaf, tp: int) -> str:
    """The marker a leaf really takes: a quantized ``{"q", "s"}`` dict
    replicates, and so does a tensor whose split axis tp does not divide
    (a converted checkpoint with odd widths)."""
    if spec == REP or not isinstance(leaf, torch.Tensor):
        return REP
    axis = -1 if spec == COL else -2
    return spec if leaf.shape[axis] % tp == 0 else REP


def _place(leaf, spec: str, shard: int, tp: int, device: torch.device):
    if isinstance(leaf, dict):
        return {k: _place(v, REP, shard, tp, device) for k, v in leaf.items()}
    if leaf is None:
        return None
    if spec == REP:
        return leaf if leaf.device == device else leaf.to(device)
    axis = -1 if spec == COL else -2
    n = leaf.shape[axis] // tp
    part = leaf.narrow(axis, shard * n, n)
    if part.device != device:
        return part.to(device).contiguous()
    return part


class ShardedParams(dict):
    """A serving weight tree sharded over a :class:`ServingMesh`. The
    dict is the whole tree as given (what ``/v1/health``'s weight bytes
    and the batcher's device read); :attr:`shards` holds one tree a
    shard, :attr:`placement` the marker each leaf took. A copy made with
    ``{**params}`` is a plain dict and loses the shards, so a forward
    over it raises instead of serving unsharded."""

    def __init__(self, tree: dict, mesh: ServingMesh, shards: list,
                 placement: dict):
        super().__init__(tree)
        self.mesh = mesh
        self.shards = shards
        self.placement = placement


def shard_serving_params(params: dict, cfg, mesh: ServingMesh,
                         ) -> ShardedParams:
    """Place the serving weight tree on the mesh per
    :func:`serving_param_specs`: one tree a shard. Leaves the spec tree
    does not name (LoRA stacks, Gemma extras) and quantized leaves
    replicate, as in the reference. A column or row shard on the leaf's
    own device is a strided view of it; on another device, a contiguous
    copy. Master weights are
    cast to the compute dtype first (``cast_params_for_compute``)."""
    from k8s_gpu_device_plugin_torch.models.llama import (
        cast_params_for_compute,
    )

    if isinstance(params, ShardedParams):
        raise ValueError("params are sharded already")
    params = cast_params_for_compute(params, cfg)
    tp = mesh.tp
    specs = serving_param_specs(cfg)
    placement = {"layers": {}}
    for name, leaf in params.items():
        if name != "layers":
            placement[name] = _placement(specs.get(name, REP), leaf, tp)
    for name, leaf in params["layers"].items():
        placement["layers"][name] = _placement(
            specs["layers"].get(name, REP), leaf, tp)
    shards = []
    for s, dev in enumerate(mesh.devices):
        tree = {name: _place(leaf, placement[name], s, tp, dev)
                for name, leaf in params.items() if name != "layers"}
        tree["layers"] = {
            name: _place(leaf, placement["layers"][name], s, tp, dev)
            for name, leaf in params["layers"].items()}
        shards.append(tree)
    return ShardedParams(params, mesh, shards, placement)


def sharded_bytes(params: ShardedParams) -> int:
    """Device bytes the shard trees hold beyond the whole tree: zero when
    every shard is a view of it or shares its leaves."""
    from k8s_gpu_device_plugin_torch.models.quantized_serving import (
        resident_bytes,
    )

    seen = {id(x.untyped_storage()) for x in _tensors(dict(params))}
    extra = 0
    for tree in params.shards:
        for x in _tensors(tree):
            key = id(x.untyped_storage())
            if key not in seen:
                seen.add(key)
                extra += resident_bytes(x)
    return extra


def _tensors(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, torch.Tensor):
        yield tree


def batch_state_shardings(mesh: ServingMesh) -> dict:
    """Placement per ``BatchState`` field: the cache (K/V and the
    quantized scale planes, whose head axis sits third from last too)
    splits on the KV-head axis, one contiguous plane a shard; every other
    leaf (lengths, masks, budgets, seeds, the page table) is replicated,
    kept on the mesh's primary device. The page table is replicated by
    design: one host-side allocator hands out page ids that mean the
    same page on every shard."""
    del mesh
    heads = "heads"
    return {
        "cache": {"k": heads, "v": heads, "k_scale": heads,
                  "v_scale": heads},
        "lengths": REP, "last_token": REP, "active": REP, "presence": REP,
        "budget": REP, "seeds": REP, "draws": REP, "pages": REP,
    }


def split_heads(x: "torch.Tensor | None", mesh: ServingMesh) -> list:
    """A whole (..., Hkv, d) plane -> one contiguous plane a shard, on
    its device."""
    if x is None:
        return [None] * mesh.tp
    return [part.to(dev).contiguous() for part, dev in zip(
        x.chunk(mesh.tp, dim=KV_HEAD_AXIS), mesh.devices)]


def shard_batch_state(state, mesh: ServingMesh):
    """A tp = 1 ``BatchState`` -> the same state on the mesh: the cache
    split on the KV-head axis (``models/generate.ShardedKVCache``), every
    other leaf on the primary device."""
    from k8s_gpu_device_plugin_torch.models.batching import BatchState
    from k8s_gpu_device_plugin_torch.models.generate import (
        KVCache,
        ShardedKVCache,
    )

    c = state.cache
    planes = {name: split_heads(getattr(c, name), mesh)
              for name in ("k", "v", "k_scale", "v_scale")}
    cache = ShardedKVCache(
        [KVCache(k=planes["k"][s], v=planes["v"][s],
                 k_scale=planes["k_scale"][s], v_scale=planes["v_scale"][s])
         for s in range(mesh.tp)], mesh)

    def rep(x):
        return None if x is None else x.to(mesh.primary)

    return BatchState(
        cache=cache, lengths=rep(state.lengths),
        last_token=rep(state.last_token), active=rep(state.active),
        presence=rep(state.presence), budget=rep(state.budget),
        seeds=rep(state.seeds), draws=rep(state.draws),
        pages=rep(state.pages))


def replicate(x: torch.Tensor, mesh: ServingMesh) -> dict:
    """``x`` on every distinct device of the mesh, keyed by device (the
    same tensor where it already lies). The forward replicates its
    per-step inputs this way once a call: where the devices repeat, that
    copies nothing."""
    return {d: (x if x.device == d else x.to(d)) for d in mesh.distinct}
