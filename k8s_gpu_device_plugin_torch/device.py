"""Device choice: the backend gate of the port.

The reference picks its kernel backend from ``jax.default_backend()``
(``ops/kernel_support.py`` ``interpret_mode``/``kernels_available``).
The port has no silent choice: entry points default to ``cuda``, the
caller opts into the CPU explicitly, and a CUDA request on a machine
without CUDA raises instead of quietly running somewhere else.
"""

from __future__ import annotations

import torch


def resolve_device(device: "str | torch.device | None" = "cuda") -> torch.device:
    """``"cuda"`` (the default; ``None`` means the same) or ``"cpu"`` ->
    a ``torch.device``. Raises RuntimeError when CUDA is asked for and
    this process has no usable CUDA device."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available in this process (torch "
            f"{torch.__version__}, built for CUDA {torch.version.cuda}); "
            "pass device='cpu' (--device cpu on the command line) to run "
            "on the CPU"
        )
    return dev
