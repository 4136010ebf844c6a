#!/usr/bin/env python3
"""``chip_smoke.py``'s tensor-parallel parts alone, on a card.

Builds the ragged-paged attention kernel (K1), runs phase 2's per-shard
K1 cases (``shard_kernel_cases``: Llama-3-8B's heads split over tp 2 and
4) against their plain versions, then draws the Llama-3-8B weights and
runs ``phase_tp``: the column-product probe (``tp_gemm_probe``) and tp
1 against tp 2 under the default cuBLAS workspace; the bit-for-bit half
(``chip_smoke.py --tp-exact``: the scenario at tp 1, 2 and 4, dense and
paged, with int8 KV, a self-draft speculative batcher and
``tp_allow_psum`` at tp 2) runs in a child started before the build.
Prints the phases' JSON lines and a last line with the build and phase
seconds; exits 1 on the first failed check. The quick check of a change to the sharded path,
before the whole ``chip_smoke.py``:

    python3 tools/torch_tp_check.py
"""

from __future__ import annotations

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> int:
    import torch

    import chip_smoke
    from k8s_gpu_device_plugin_torch.models import batching, quantized_serving
    from k8s_gpu_device_plugin_torch.models import llama, sampling
    from k8s_gpu_device_plugin_torch.models import spec_batching
    from k8s_gpu_device_plugin_torch.ops import kernel_support, quant
    from k8s_gpu_device_plugin_torch.ops import ragged_paged_attention as rpa
    from k8s_gpu_device_plugin_torch.serving import prefix_cache, server

    if not torch.cuda.is_available():
        print("CUDA is not available: this tool runs on a card",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(chip_smoke.card_line(), flush=True)
    child = chip_smoke.start_tp_exact()
    t0 = time.perf_counter()
    rpa.load_kernel()
    build_s = time.perf_counter() - t0
    exact = chip_smoke.join_tp_exact(child)
    t0 = time.perf_counter()
    chip_smoke.phase_kernels(torch, rpa, quant, kernel_support,
                             cases=chip_smoke.shard_kernel_cases())
    cases_s = time.perf_counter() - t0
    cfg = llama.LlamaConfig.llama3_8b()
    params = server.load_params(cfg, seed=chip_smoke.SEED, device="cuda")
    t0 = time.perf_counter()
    chip_smoke.phase_tp(torch, batching, sampling, spec_batching,
                        prefix_cache, quantized_serving, kernel_support, rpa,
                        cfg, params, exact)
    print(json.dumps({"build_s": build_s, "cases_s": cases_s,
                      "phase_s": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
