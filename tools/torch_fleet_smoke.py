"""The fleet part of ``chip_smoke.py`` alone, on the card.

Builds the two kernel libraries (K1 serves every replica's chunks and
decode steps, K2 the embeddings), draws the random Llama-3-8B bf16
weights from ``chip_smoke.SEED`` and runs ``chip_smoke.phase_fleet``:
two servers behind the port's replica router (``fleet_route``,
``fleet_drain``, ``fleet_disagg``, ``fleet_resume``), printing the same
JSON lines. A quicker loop than the whole script while working on the
router; the whole script stays the proof.

Run on a machine with one H100: ``python3 tools/torch_fleet_smoke.py``.
"""

import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        print("CUDA is not available: this tool drives the card",
              file=sys.stderr)
        raise SystemExit(1)
    sys.path.insert(0, ROOT)
    import chip_smoke
    from k8s_gpu_device_plugin_torch.models import batching, llama
    from k8s_gpu_device_plugin_torch.ops import flash_attention as fa
    from k8s_gpu_device_plugin_torch.ops import kernel_support
    from k8s_gpu_device_plugin_torch.ops import ragged_paged_attention as rpa
    from k8s_gpu_device_plugin_torch.serving import server as server_mod

    torch.backends.cuda.matmul.allow_tf32 = False
    print(chip_smoke.card_line(), flush=True)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:  # one nvcc per source, together
        for build in [pool.submit(rpa.load_kernel), pool.submit(fa.load_kernel)]:
            build.result()
    chip_smoke.emit({"tool": "torch_fleet_smoke",
                     "build_s": time.perf_counter() - t0})
    cfg = llama.LlamaConfig.llama3_8b()
    params = server_mod.load_params(cfg, seed=chip_smoke.SEED, device="cuda")
    chip_smoke.phase_fleet(torch, server_mod, batching, kernel_support, rpa,
                           cfg, params)
    chip_smoke.emit({"tool": "torch_fleet_smoke", "ok": True,
                     "wall_s": time.perf_counter() - t0})


if __name__ == "__main__":
    main()
