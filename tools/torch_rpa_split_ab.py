#!/usr/bin/env python3
"""K1's bf16 decode on the tensor cores (split-KV) against its variants,
on a card.

A narrow window's launch (``rpa_tc_kernel`` with SPLIT,
``ops/csrc/ragged_paged_attention.cu``) splits each slot's live span into
splits of ``SPLIT_TILES`` kv tiles, one block each, with a ring of
``kSplitStages`` stages sized so that ``kSplitBlocksPerSm`` blocks share
an SM. This times, at ``chip_smoke.py`` phase 2's bf16 decode cases
(eight slots at bases -1 .. 2047 of S 2048, Hq 32, Hkv 8, hd 128, on the
six routes, paged through pages of 64; the dense route also with a window
of 64 and at hd 64, group 1):

- the sound kernel at SPLIT_TILES 2, 4 and 8, and unsplit (one block per
  slot and kv head walking the whole span), and the CUDA-core engine
  (``engine_override``) on the same inputs;
- copies of the library built into ``ops/build/fault/<variant>/``
  (gitignored; the sources are not touched), at the wrapper's
  SPLIT_TILES: ``ring3_one_block`` (three stages, one block an SM: the
  chunk route's ring), and two pacing probes whose output is wrong by
  design: ``copies_only`` (the consumer waits for each tile and releases
  it without a product) and ``products_only`` (the producer hands over
  each stage without filling it).

Sound launches and ``ring3_one_block`` must be within one ulp of the
split-aware plain version (``kernel_support.bf16_o_mismatch``) or the
tool exits 1. Each time is a CUDA-graph replay timed with CUDA events, in
the order sound, variants, variants reversed, sound. One JSON line per
case, with the blocks an SM holds of each build (the occupancy API).

    python3 tools/torch_rpa_split_ab.py
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from unittest import mock

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

SOURCE = "ragged_paged_attention.cu"
_CONSUME = """\
  consume<HD, kStages>(acc, ring, q_tile, scale * kLog2e, j_lo, j_hi, j_lo,
                       j_hi, [](int) { return true; }, kept);
"""
VARIANTS = {
    "ring3_one_block": [
        (SOURCE, "constexpr int kSplitStages = 2;\n",
         "constexpr int kSplitStages = 3;\n"),
        (SOURCE, "constexpr int kSplitBlocksPerSm = 2;\n",
         "constexpr int kSplitBlocksPerSm = 1;\n"),
    ],
    "copies_only": [(
        SOURCE, _CONSUME,
        "  if constexpr (SPLIT) {\n"
        "    walk(ring, j_hi - j_lo + 1, [](int, int) {});\n"
        "    acc.finish();\n"
        "  } else {\n" + _CONSUME.replace("\n  ", "\n    ").replace(
            "  consume", "    consume", 1) + "  }\n",
    )],
    "products_only": [
        (SOURCE, "        prod.copy(j, ring.tile(s, 0), ring.tile(s, 1), pt);\n",
         "        if (!SPLIT) prod.copy(j, ring.tile(s, 0), ring.tile(s, 1), pt);\n"),
        (SOURCE, "        prod.dequant(j, ring.tile(s, 0), ring.tile(s, 1), pt);\n",
         "        if (!SPLIT) prod.dequant(j, ring.tile(s, 0), ring.tile(s, 1), pt);\n"),
    ],
}
# variants whose output is wrong by design (timed, not checked)
PROBES = ("copies_only", "products_only")
SPLITS = (2, 4, 8)
BASES = [-1, 0, 1, 255, 256, 1000, 2046, 2047]
# phase 2's bf16 decode cases: (name, route, page size, hq, hkv, hd, window)
CASES = [("decode", "dense", 0, 32, 8, 128, 0),
         ("decode_paged_ps64", "paged", 64, 32, 8, 128, 0),
         ("decode_int8_dense", "int8_dense", 0, 32, 8, 128, 0),
         ("decode_int8_paged_ps64", "int8_paged", 64, 32, 8, 128, 0),
         ("decode_int4_dense", "int4_dense", 0, 32, 8, 128, 0),
         ("decode_int4_paged_ps64", "int4_paged", 64, 32, 8, 128, 0),
         ("decode_window64", "dense", 0, 32, 8, 128, 64),
         ("decode_hd64_group1", "dense", 0, 8, 8, 64, 0)]
S = 2048


def main() -> int:
    import torch

    from chip_smoke import TOL, bound, graph_ms, route_operands
    from k8s_gpu_device_plugin_torch.ops import kernel_support
    from k8s_gpu_device_plugin_torch.ops import quant
    from k8s_gpu_device_plugin_torch.ops import ragged_paged_attention as rpa
    from torch_flash_fault import build_edited  # beside this script

    if not torch.cuda.is_available():
        print("torch_rpa_split_ab: needs a CUDA card", file=sys.stderr)
        return 1
    with ThreadPoolExecutor(len(VARIANTS) + 1) as pool:
        sound = pool.submit(rpa.load_kernel)
        built = {name: pool.submit(build_edited, {"rpa": rpa}, kernel_support,
                                   name, "rpa", edits)
                 for name, edits in VARIANTS.items()}
        libs = {"sound": sound.result()}
        libs.update({name: f.result() for name, f in built.items()})
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
    ).stdout.strip()
    order = ["sound", *VARIANTS, *reversed(VARIANTS), "sound"]
    chosen = rpa.SPLIT_TILES
    bad = []
    for name, route, ps, hq, hkv, hd, window in CASES:
        case = dict(name=name, route=route, ps=ps, b=len(BASES), t=1, s=S,
                    bases=BASES, hq=hq, hkv=hkv, hd=hd, window=window)
        gen = torch.Generator(device="cuda")
        gen.manual_seed(0)
        q = torch.randn((len(BASES), 1, hq, hd), generator=gen, device="cuda",
                        dtype=torch.bfloat16)
        k0, v0 = (torch.randn((len(BASES), S, hkv, hd), generator=gen,
                              device="cuda", dtype=torch.bfloat16)
                  for _ in range(2))
        base = torch.tensor(BASES, dtype=torch.int32, device="cuda")
        k, v, ks, vs, pages = route_operands(torch, quant, case, k0, v0, gen)
        kw = dict(scale=hd ** -0.5, window=window, k_scale=ks, v_scale=vs)
        want = rpa.ragged_paged_attention_reference(q, k, v, base, pages, **kw)

        def launch(**extra):
            return rpa.ragged_paged_attention(q, k, v, base, pages, **kw,
                                              **extra)

        def timed(lib, split, **extra):
            """(ms, why the output fails its check or None) of one build
            at one SPLIT_TILES (None: unsplit)."""
            with mock.patch.object(rpa, "load_kernel", lambda: lib), \
                    mock.patch.object(rpa, "SPLIT_TILES", split or chosen), \
                    mock.patch.object(rpa, "window_split",
                                      lambda t, g: split):
                want_p = rpa.ragged_paged_attention_reference(
                    q, k, v, base, pages, p_bf16=True, split_tiles=split, **kw)
                why = kernel_support.bf16_o_mismatch(launch(**extra), want_p,
                                                     want, TOL["bfloat16"])
                return graph_ms(torch, lambda: launch(**extra), 20), why

        ms = {}
        for lib_name in order:
            lib = libs[lib_name]
            runs = {f"k{k_}": k_ for k_ in SPLITS} if lib_name == "sound" \
                else {f"k{chosen}": chosen}
            if lib_name == "sound":
                runs["unsplit"] = None
            for tag, split in runs.items():
                t_ms, why = timed(lib, split)
                ms.setdefault(f"{lib_name}_{tag}", []).append(t_ms)
                if why and lib_name not in PROBES:
                    bad.append(f"{name} {lib_name} {tag}: {why}")
        blocks = {}
        for lib_name, lib in libs.items():
            with mock.patch.object(rpa, "load_kernel", lambda lib=lib: lib):
                launch()
            blocks[lib_name] = lib.rpa_blocks_per_sm()
        ms["cuda_cores"] = [graph_ms(
            torch, lambda: launch(engine_override="cuda_cores"), 20)]
        print(json.dumps({
            "card": card, "case": name, "route": route, "page_size": ps,
            "hq": hq, "hkv": hkv, "hd": hd, "window": window, "bases": BASES,
            "split_tiles": chosen, "order": order, "ms": ms,
            "blocks_per_sm": blocks,
            "splits_per_slot": {k_: [len(x) for x in rpa.split_plan(
                BASES, 1, window, S, k_)] for k_ in SPLITS},
            "bound_ms": bound(case, rpa, torch, "bfloat16")[0]}), flush=True)
    if bad:
        print(f"torch_rpa_split_ab: {bad}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
