#!/usr/bin/env python3
"""``chip_smoke.py`` phase 9 alone, on a card: Gemma-2B (head dim 256) and
Qwen2-7B (a GQA group of 7).

Builds the four kernel libraries (one ``nvcc`` per source, together, as
``chip_smoke.py`` does), then runs its ``phase_wide``: K1-K4's hd-256 and
group-7 cases against their plain versions, and both presets at their
published widths (the HF round trip, serving against ``generate``, the f32
paths, training bit for bit, the f32 twin). Prints the phase's JSON lines
and a last line with the build and phase seconds; exits 1 on the first
failed check. The quick check of a change to these paths, before the whole
``chip_smoke.py``:

    python3 tools/torch_wide_head_dim_check.py
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
    from k8s_gpu_device_plugin_torch.models import batching, convert
    from k8s_gpu_device_plugin_torch.models import generate, llama, train
    from k8s_gpu_device_plugin_torch.ops import flash_attention as fa
    from k8s_gpu_device_plugin_torch.ops import fused_ce as fce
    from k8s_gpu_device_plugin_torch.ops import fused_optim as fo
    from k8s_gpu_device_plugin_torch.ops import kernel_support, quant
    from k8s_gpu_device_plugin_torch.ops import ragged_paged_attention as rpa

    if not torch.cuda.is_available():
        print("CUDA is not available: this tool runs on a card",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(chip_smoke.card_line(), flush=True)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(4) as pool:
        for job in [pool.submit(m.load_kernel) for m in (rpa, fa, fo, fce)]:
            job.result()
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    chip_smoke.phase_wide(torch, rpa, quant, fa, kernel_support, llama,
                          generate, batching, train, convert)
    print(json.dumps({"build_s": build_s,
                      "phase_s": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
