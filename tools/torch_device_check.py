#!/usr/bin/env python3
"""``chip_smoke.py``'s device phase alone, on a card.

Builds K1 (``ragged_paged_attention.cu``, the usage reader's load) and
the GPU enumerator (``native/gpuenum.cc``) together, as ``chip_smoke.py``
phase 1 does, then runs its ``phase_device``: the native backend against
torch's view of the card, the chip map, the NVML usage reader under an
8 GiB tensor and K1 decode launches, the device metrics, the assessor on
a busy card and the idle probe. Prints the phase's JSON lines and a last
line with the build and phase seconds; exits 1 on the first failed
check. The quick check of a change to the device model, before the whole
``chip_smoke.py``:

    python3 tools/torch_device_check.py
"""

from __future__ import annotations

import json
import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> int:
    import torch

    import chip_smoke
    from k8s_gpu_device_plugin_torch.device import native as native_device
    from k8s_gpu_device_plugin_torch.ops import kernel_support
    from k8s_gpu_device_plugin_torch.ops import ragged_paged_attention as rpa

    if not torch.cuda.is_available():
        print("torch_device_check: CUDA is not available", file=sys.stderr)
        return 1
    print(chip_smoke.card_line(), flush=True)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:
        for build in [pool.submit(rpa.load_kernel),
                      pool.submit(native_device.load_library)]:
            build.result()
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    chip_smoke.phase_device(torch, rpa, kernel_support)
    print(json.dumps({"build_s": build_s,
                      "phase_s": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
