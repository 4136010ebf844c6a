#!/usr/bin/env python3
"""K2's tensor-core forward with its TMA producer against a cp.async one,
on a card.

``flash_fwd_tc_kernel`` (``ops/csrc/flash_attention.cu``) fills its ring
of K/V tiles with TMA boxes from 3-D tensor maps, issued by one lane of a
producer warp. K1's chunk route fills the same swizzled tiles with
``cp.async`` (``ChunkProducer::copy`` in ``ragged_paged_attention.cu``).
This builds copies of the flash library into ``ops/build/fault/<variant>/``
(gitignored; the sources are not touched) whose producer issues
``cp.async`` of each tile's 16-byte chunks instead, from every lane of one
warp (``cp_async_warp``, the same block as the TMA kernel) or of a
warpgroup (``cp_async_warpgroup``, 96 more threads a block), and times
each against the sound kernel at ``chip_smoke.py`` phase 5's bf16 cases
(B 2, S 2048, Hq 32, Hkv 8, causal: hd 128, window 512, and hd 64 at
group 1), in the order sound, variants, variants reversed, sound, each a
CUDA-graph replay timed with CUDA events. A variant's o must be within
one ulp of the sound kernel's plain version (``kernel_support.
bf16_o_mismatch``) or the tool exits 1. One JSON line per case.

    python3 tools/torch_flash_producer_ab.py
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

SOURCE = "flash_attention.cu"
_PRODUCER_TMA = """\
  if (wg == kTcConsumers) {  // the producer warp
    if (threadIdx.x % 32 == 0) {
      const int kvh = bh / group;
      for (int j = lo, n = 0; j <= hi; ++j, ++n) {
        const int s = ring.acquire(n);
        mbar_expect_tx(ring.full(s), 2 * tile_bytes<HD>());
#pragma unroll
        for (int c = 0; c < HD / 64; ++c) {
          tma_load_3d(ring.tile(s, 0) + c * 8192, &tm_k, 64 * c, j * kTile, kvh,
                      ring.full(s));
          tma_load_3d(ring.tile(s, 1) + c * 8192, &tm_v, 64 * c, j * kTile, kvh,
                      ring.full(s));
        }
      }
    }
    return;
  }
"""
# every producer thread copies chunks pt, pt + P, ... of each K and V tile
# and arrives on the stage's full barrier once its copies have landed
_PRODUCER_CP_ASYNC = """\
  if (wg == kTcConsumers) {  // the producer threads: cp.async
    const int pt = threadIdx.x - kTcConsumers * kWarpgroup;
    const size_t kv_row0 = size_t(bh / group) * s_len;
    int prev = -1;
    for (int j = lo, n = 0; j <= hi; ++j, ++n) {
      const int s = ring.acquire(n);
      for (int e = pt; e < kKv * HD / 8; e += PRODUCERS) {
        const int r = e / (HD / 8), c = e % (HD / 8);
        const size_t off = (kv_row0 + size_t(j) * kTile + r) * HD + 8 * c;
        cp_async_16(ring.tile(s, 0) + swizzle(r, 8 * c), kp + off, true);
        cp_async_16(ring.tile(s, 1) + swizzle(r, 8 * c), vp + off, true);
      }
      cp_async_commit();
      if (prev >= 0) {
        cp_async_wait<1>();
        fence_async_shared();
        mbar_arrive(ring.full(prev));
      }
      prev = s;
    }
    if (prev >= 0) {
      cp_async_wait<0>();
      fence_async_shared();
      mbar_arrive(ring.full(prev));
    }
    return;
  }
"""


def variant_edits(producers: int):
    """The (file, text, replacement) edits of a cp.async producer of
    ``producers`` threads."""
    return [
        (SOURCE, "constexpr int kTcThreads = kTcConsumers * attn_tile::kWarpgroup + 32;",
         f"constexpr int kTcThreads = kTcConsumers * attn_tile::kWarpgroup + {producers};"),
        (SOURCE, "flash_fwd_tc_kernel(const __grid_constant__ CUtensorMap tm_k,\n"
         "                    const __grid_constant__ CUtensorMap tm_v,\n",
         "flash_fwd_tc_kernel(const __grid_constant__ CUtensorMap tm_k,\n"
         "                    const __grid_constant__ CUtensorMap tm_v,\n"
         "                    const __nv_bfloat16* __restrict__ kp,\n"
         "                    const __nv_bfloat16* __restrict__ vp,\n"),
        (SOURCE, "      tm_k, tm_v, static_cast<const __nv_bfloat16*>(q),",
         "      tm_k, tm_v, static_cast<const __nv_bfloat16*>(k),\n"
         "      static_cast<const __nv_bfloat16*>(v),\n"
         "      static_cast<const __nv_bfloat16*>(q),"),
        (SOURCE, "  if (threadIdx.x == 0) ring.init(1, kTcConsumers * kWarpgroup);",
         f"  if (threadIdx.x == 0) ring.init({producers}, kTcConsumers * kWarpgroup);"),
        (SOURCE, _PRODUCER_TMA,
         _PRODUCER_CP_ASYNC.replace("PRODUCERS", str(producers))),
    ]


VARIANTS = {"cp_async_warp": 32, "cp_async_warpgroup": 128}
# phase 5's bf16 cases: (name, hq, hkv, hd, window)
CASES = [("causal", 32, 8, 128, 0), ("window512", 32, 8, 128, 512),
         ("hd64_group1", 8, 8, 64, 0)]
B, S = 2, 2048


def main() -> int:
    import torch

    from chip_smoke import graph_ms
    from k8s_gpu_device_plugin_torch.ops import flash_attention as fa
    from k8s_gpu_device_plugin_torch.ops import kernel_support
    from torch_flash_fault import build_edited  # beside this script

    if not torch.cuda.is_available():
        print("torch_flash_producer_ab: needs a CUDA card", file=sys.stderr)
        return 1
    with ThreadPoolExecutor(len(VARIANTS) + 1) as pool:
        sound = pool.submit(fa.load_kernel)
        built = {name: pool.submit(build_edited, {"flash": fa},
                                   kernel_support, name, "flash",
                                   variant_edits(n))
                 for name, n in VARIANTS.items()}
        libs = {"tma": sound.result()}
        libs.update({name: f.result() for name, f in built.items()})
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
    ).stdout.strip()
    order = ["tma", *VARIANTS, *reversed(VARIANTS), "tma"]
    bad = []
    for case, hq, hkv, hd, window in CASES:
        gen = torch.Generator(device="cuda")
        gen.manual_seed(0)
        q, k, v = (torch.randn((B * h, S, hd), generator=gen, device="cuda",
                               dtype=torch.bfloat16) for h in (hq, hkv, hkv))
        kw = dict(scale=hd ** -0.5, causal=True, window=window)
        o_r = fa.flash_fwd_reference(q, k, v, **kw)[0]
        o_p = fa.flash_fwd_reference(q, k, v, p_bf16=True, **kw)[0]
        ms = {name: [] for name in libs}
        why = {}
        for name in order:
            with mock.patch.object(fa, "load_kernel",
                                   lambda lib=libs[name]: lib):
                o = fa.flash_fwd(q, k, v, **kw)[0]
                why[name] = kernel_support.bf16_o_mismatch(
                    o, o_p, o_r, fa.o_wide_tol(v))
                ms[name].append(graph_ms(
                    torch, lambda: fa.flash_fwd(q, k, v, **kw), 5))
        bad += [f"{case} {name}: {w}" for name, w in why.items() if w]
        print(json.dumps({"card": card, "case": case, "b": B, "s": S,
                          "hq": hq, "hkv": hkv, "hd": hd, "window": window,
                          "order": order, "ms": ms, "mismatch": why}),
              flush=True)
    if bad:
        print(f"torch_flash_producer_ab: {bad}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
