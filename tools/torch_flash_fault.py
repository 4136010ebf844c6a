#!/usr/bin/env python3
"""How far the flash forward's bf16 check sits from a real fault, on a card.

Builds faulted copies of ``ops/csrc/flash_attention.cu`` into
``ops/build/fault/`` (gitignored; the checkout's sources are not
touched), each with one fault planted in the forward kernel (K2):

- ``drop_one_tile``: the last q tile skips the P.V product of its first
  live kv tile (64 of its 2048 keys; the softmax sum still counts them);
- ``p_bf16``: the probabilities are rounded to bf16 before the P.V
  product.

At the training path's shapes (B 2, S 2048, Hq 32, Hkv 8, hd 128,
causal, bf16: ``chip_smoke.py`` phase 5's headline case) it runs the
sound kernel and each faulted copy against the plain forward and prints
one JSON line with, for each: the max abs error of o, the worst
|err| / (atol + rtol |want|) under ``chip_smoke.py``'s bf16 o tolerance
and under the bf16 tolerance its ragged-paged phase uses (a ratio above 1
fails the check), and how many output rows the tight tolerance flags.

    python3 tools/torch_flash_fault.py
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

# (text in flash_fwd_kernel, its faulted replacement)
FAULTS = {
    "drop_one_tile": (
        "    pv_tile<HD>(ks, vs, ty, tx, acc);\n",
        "    if (!(qt == n_tiles - 1 && j == j_lo)) "
        "pv_tile<HD>(ks, vs, ty, tx, acc);\n",
    ),
    "p_bf16": (
        "        ks[r * kPStride + tx + 16 * jj] = p;\n",
        "        ks[r * kPStride + tx + 16 * jj] = "
        "__bfloat162float(__float2bfloat16(p));\n",
    ),
}
B, S, HQ, HKV, HD = 2, 2048, 32, 8, 128


def build_faulted(fa, kernel_support, name: str) -> ctypes.CDLL:
    old, new = FAULTS[name]
    text = fa.SOURCE.read_text()
    if text.count(old) != 1:
        raise RuntimeError(f"{name}: the text to fault is not in the source "
                           "exactly once")
    fault_dir = kernel_support.BUILD_DIR / "fault"
    fault_dir.mkdir(parents=True, exist_ok=True)
    src = fault_dir / f"flash_attention_{name}.cu"
    src.write_text(text.replace(old, new))
    lib = kernel_support.load_library(f"flash_attention_{name}", [src],
                                      build_dir=fault_dir)
    lib.flash_fwd.argtypes = fa._ARGTYPES["flash_fwd"]
    lib.flash_fwd.restype = ctypes.c_int
    return lib


def main() -> int:
    import torch

    from chip_smoke import FLASH_O_TOL, TOL
    from k8s_gpu_device_plugin_torch.ops import flash_attention as fa
    from k8s_gpu_device_plugin_torch.ops import kernel_support

    if not torch.cuda.is_available():
        print("torch_flash_fault: needs a CUDA card", file=sys.stderr)
        return 1
    with ThreadPoolExecutor(len(FAULTS) + 1) as pool:
        sound = pool.submit(fa.load_kernel)
        faulted = {name: pool.submit(build_faulted, fa, kernel_support, name)
                   for name in FAULTS}
        sound.result()
        libs = {name: f.result() for name, f in faulted.items()}

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    q, k, v = (torch.randn((B * h, S, HD), generator=gen, device="cuda",
                           dtype=torch.bfloat16) for h in (HQ, HKV, HKV))
    scale = HD ** -0.5
    want = fa.flash_fwd_reference(q, k, v, scale=scale)[0].float()

    def faulted_fwd(lib):
        o = torch.empty_like(q)
        lse = torch.empty((B * HQ, S, 1), dtype=torch.float32, device="cuda")
        err = lib.flash_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                            o.data_ptr(), lse.data_ptr(), 1, B * HQ,
                            HQ // HKV, S, HD, scale, 1, 0,
                            torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"faulted flash_fwd failed: cudaError {err}")
        return o

    outs = {"sound": fa.flash_fwd(q, k, v, scale=scale)[0]}
    outs.update({name: faulted_fwd(lib) for name, lib in libs.items()})
    torch.cuda.synchronize()

    def ratio(diff, tol):
        return float((diff / (tol["atol"] + tol["rtol"] * want.abs())).max())

    tight, loose = FLASH_O_TOL["bfloat16"], TOL["bfloat16"]
    rows = {}
    for name, o in outs.items():
        diff = (o.float() - want).abs()
        over = diff > tight["atol"] + tight["rtol"] * want.abs()
        rows[name] = {
            "max_abs_err": float(diff.max()),
            "ratio_tight": ratio(diff, tight),
            "ratio_loose": ratio(diff, loose),
            "rows_flagged_tight": int(over.any(-1).sum()),
        }
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
    ).stdout.strip()
    print(json.dumps({
        "card": card, "shape": {"b": B, "s": S, "hq": HQ, "hkv": HKV,
                                "hd": HD, "dtype": "bfloat16",
                                "causal": True},
        "tight_tol": tight, "loose_tol": loose,
        "mean_abs_o": float(want.abs().mean()),
        "runs": rows,
    }))
    if rows["sound"]["ratio_tight"] > 1:
        print("torch_flash_fault: the sound kernel fails the tight check",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
