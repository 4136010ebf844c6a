#!/usr/bin/env python3
"""Whether cuBLAS gives a column shard's product the whole product's bits,
under each cuBLAS setting torch can choose, on a card.

Tensor-parallel serving (``parallel/tp_serving.py``) pins tp > 1 streams
to tp = 1's bit for bit only if ``x @ w[:, cols]`` equals ``(x @
w)[:, cols]``. ``chip_smoke.py``'s ``tp_gemm_probe`` asks that at
Llama-3-8B's widths under torch's defaults; this tool asks it again in
one fresh process a setting (cuBLAS reads its workspace variables when
its handle is made): torch's defaults; ``CUBLAS_WORKSPACE_CONFIG=:0:0``
(no workspace for cuBLAS, so no split-K that reduces through one);
``preferred_blas_library("cublaslt")``; cuBLASLt with
``CUBLASLT_WORKSPACE_SIZE=0``. Per setting and weight (wq, wk, wv, w1,
w3 of layer 0 and the lm_head, random bf16 from a seed, the widths of
Llama-3-8B), the M (1, 8, 32, 256, 512), tp (2, 4) and layouts whose
shards differ, and the largest difference, through the port's own
products (``qmatmul``; ``qhead_matmul``'s f32 logits for the lm_head).
One JSON line a setting:

    python3 tools/torch_tp_gemm_probe.py

``--cpu`` asks the same of the CPU's products instead (one line; the
lm_head at M 1, 8 and 32 only, its f32 product being slow there):

    python3 tools/torch_tp_gemm_probe.py --cpu
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

SETTINGS = {
    "default": ({}, None),
    "cublas_workspace_0": ({"CUBLAS_WORKSPACE_CONFIG": ":0:0"}, None),
    "cublaslt": ({}, "cublaslt"),
    "cublaslt_workspace_0": ({"CUBLASLT_WORKSPACE_SIZE": "0"}, "cublaslt"),
}
SHAPES = {"wq": (4096, 4096), "wk": (4096, 1024), "wv": (4096, 1024),
          "w1": (4096, 14336), "w3": (4096, 14336), "lm_head": (4096, 128256)}
MS = (1, 8, 32, 256, 512)
CPU_HEAD_MS = (1, 8, 32)


def probe(library: "str | None", device: str = "cuda") -> dict:
    import torch

    from k8s_gpu_device_plugin_torch.models.quantized_serving import (
        qhead_matmul,
        qmatmul,
    )

    if library:
        torch.backends.cuda.preferred_blas_library(library)
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    out = {}
    for name, (k, n) in SHAPES.items():
        w = (torch.randn((k, n), generator=gen, device=device) * 0.02).to(
            torch.bfloat16)
        bad = []
        ms = CPU_HEAD_MS if name == "lm_head" and device == "cpu" else MS
        for m in ms:
            x = torch.randn((m, k), generator=gen, device=device).to(
                torch.bfloat16)
            if name == "lm_head":  # the head's f32 product (ops/quant.py)
                def f(a, b):
                    return qhead_matmul(a, b, torch.bfloat16)
            else:
                f = qmatmul
            full = f(x, w)
            for tp in (2, 4):
                c = n // tp
                for layout in ("view", "copy"):
                    diff = 0.0
                    for s in range(tp):
                        part = w[:, s * c:(s + 1) * c]
                        if layout == "copy":
                            part = part.contiguous()
                        diff = max(diff, float((f(x, part).float()
                                                - full[:, s * c:(s + 1) * c]
                                                .float()).abs().max()))
                    if diff:
                        bad.append({"m": m, "tp": tp, "layout": layout,
                                    "max_abs_diff": diff})
        out[name] = bad
    return out


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--child":
        library = None if sys.argv[2] == "-" else sys.argv[2]
        print(json.dumps(probe(library)), flush=True)
        return 0
    import torch

    if sys.argv[1:] == ["--cpu"]:
        result = probe(None, "cpu")
        print(json.dumps({"setting": "cpu", "threads": torch.get_num_threads(),
                          "all_equal": not any(result.values()),
                          "unequal": result}), flush=True)
        return 0

    if not torch.cuda.is_available():
        print("CUDA is not available: this tool runs on a card",
              file=sys.stderr)
        return 1
    for label, (env, library) in SETTINGS.items():
        proc = subprocess.run(
            [sys.executable, __file__, "--child", library or "-"],
            env={**os.environ, **env}, capture_output=True, text=True,
            timeout=600)
        if proc.returncode:
            print(json.dumps({"setting": label, "error": proc.stderr[-2000:]}),
                  flush=True)
            continue
        result = json.loads(proc.stdout.strip().splitlines()[-1])
        print(json.dumps({"setting": label, "env": env, "library": library,
                          "all_equal": not any(result.values()),
                          "unequal": result}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
