"""Parameter conversion between the JAX reference and the port.

The two packages share one weight layout (models/llama.py states it):
stacked ``layers`` leaves with a leading layer axis, projections stored
``(in, out)``, ``embed`` (V, d), ``final_norm`` (d,), ``lm_head`` (d, V).
So conversion is a per-leaf copy with no transposes — the parity tests
feed both frameworks the same numbers.
"""

from __future__ import annotations

import numpy as np
import torch

from k8s_gpu_device_plugin_torch.device import resolve_device
from k8s_gpu_device_plugin_torch.models.llama import LlamaConfig


def _tensor(arr, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    arr = np.array(arr, order="C")  # an owned, writable copy
    if arr.dtype.name == "bfloat16":
        # numpy has no bfloat16 of its own (ml_dtypes provides one torch
        # cannot read): move the raw 16-bit patterns and reinterpret
        t = torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    return t.to(device=device, dtype=dtype)


def params_from_jax(np_params: dict, cfg: LlamaConfig,
                    device: "str | torch.device | None" = "cuda") -> dict:
    """The reference's params pytree, as numpy arrays (``layers`` leaves
    stacked, plus ``embed``, ``final_norm`` and — unless tied —
    ``lm_head``), -> the port's params on ``device`` in ``cfg.p_dtype``.
    Refuses a tree that does not match ``cfg``'s shapes."""
    dev = resolve_device(device)
    expected = {"embed", "layers", "final_norm"}
    if not cfg.tied_embeddings:
        expected.add("lm_head")
    if set(np_params) != expected:
        raise ValueError(
            f"params carry {sorted(np_params)}, expected {sorted(expected)}"
        )
    out = {
        "embed": _tensor(np_params["embed"], cfg.p_dtype, dev),
        "final_norm": _tensor(np_params["final_norm"], cfg.p_dtype, dev),
        "layers": {
            name: _tensor(leaf, cfg.p_dtype, dev)
            for name, leaf in np_params["layers"].items()
        },
    }
    if "lm_head" in np_params:
        out["lm_head"] = _tensor(np_params["lm_head"], cfg.p_dtype, dev)
    d, hd = cfg.d_model, cfg.head_dim
    want = {
        "embed": (cfg.vocab_size, d),
        "final_norm": (d,),
        "lm_head": (d, cfg.vocab_size),
    }
    for name, shape in want.items():
        if name in out and tuple(out[name].shape) != shape:
            raise ValueError(
                f"{name} is {tuple(out[name].shape)}, cfg wants {shape}"
            )
    wq = out["layers"]["wq"]
    if tuple(wq.shape) != (cfg.n_layers, d, cfg.n_heads * hd):
        raise ValueError(
            f"layers.wq is {tuple(wq.shape)}, cfg wants "
            f"{(cfg.n_layers, d, cfg.n_heads * hd)}"
        )
    return out


def params_to_numpy(params: dict) -> dict:
    """The reverse per-leaf copy: the port's params -> the same tree of
    numpy arrays on the host (bf16 leaves widened to f32, exactly:
    numpy has no bfloat16 of its own)."""
    out = {}
    for name, leaf in params.items():
        if isinstance(leaf, dict):
            out[name] = params_to_numpy(leaf)
        else:
            x = leaf.detach().cpu()
            out[name] = (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    return out
