"""The batch-1 decode modes of ``chip_smoke.py`` alone, on the card.

Builds the two kernel libraries, runs phase 2's and phase 5's cases at
the decode modes' shapes (K1's beam decode at B 4 and rolling's windowed
prefill at T 4160; K2 at the beam check's B 4, S 576), then draws the
random Llama-3-8B bf16 weights from ``chip_smoke.SEED`` and runs
``chip_smoke.phase_beam``, frees them, draws Mistral-7B's and runs
``chip_smoke.phase_rolling``, printing the same JSON lines. A quicker
loop than the whole script while working on ``models/beam.py`` or
``models/rolling.py``; the whole script stays the proof.

Run on a machine with one H100: ``python3 tools/torch_decode_modes_smoke.py``.
"""

import gc
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
    from k8s_gpu_device_plugin_torch.models import generate, llama
    from k8s_gpu_device_plugin_torch.ops import flash_attention as fa
    from k8s_gpu_device_plugin_torch.ops import kernel_support, quant
    from k8s_gpu_device_plugin_torch.ops import ragged_paged_attention as rpa
    from k8s_gpu_device_plugin_torch.serving import server as server_mod

    torch.backends.cuda.matmul.allow_tf32 = False
    print(chip_smoke.card_line(), flush=True)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:  # one nvcc per source, together
        builds = [pool.submit(f) for f in (rpa.load_kernel, fa.load_kernel)]
        for build in builds:
            build.result()
    chip_smoke.emit({"tool": "torch_decode_modes_smoke",
                     "build_s": time.perf_counter() - t0})
    # only the cases at the decode modes' shapes
    k1_cases = {f"decode_beam{chip_smoke.BEAM_WIDTH}",
                f"prefill_t{chip_smoke.ROLLING_PROMPT}_w"
                f"{chip_smoke.MISTRAL_WINDOW}"}
    k1_all, k2_all = chip_smoke.kernel_cases, chip_smoke.flash_cases
    chip_smoke.kernel_cases = lambda: [c for c in k1_all()
                                       if c["name"] in k1_cases]
    chip_smoke.flash_cases = lambda: [c for c in k2_all()
                                      if c["name"].startswith("beam_check")]
    chip_smoke.phase_kernels(torch, rpa, quant, kernel_support)
    chip_smoke.phase_flash(torch, fa, kernel_support)
    for cfg, phase in ((llama.LlamaConfig.llama3_8b(), "beam"),
                       (llama.LlamaConfig.mistral_7b(), "rolling")):
        params = server_mod.load_params(cfg, seed=chip_smoke.SEED,
                                        device="cuda")
        if phase == "beam":
            chip_smoke.phase_beam(torch, generate, llama, kernel_support, rpa,
                                  cfg, params)
        else:
            chip_smoke.phase_rolling(torch, generate, kernel_support, rpa,
                                     cfg, params)
        del params
        gc.collect()
        torch.cuda.empty_cache()
    chip_smoke.emit({"tool": "torch_decode_modes_smoke", "ok": True,
                     "wall_s": time.perf_counter() - t0})


if __name__ == "__main__":
    main()
