#!/usr/bin/env python3
"""How far the tensor-core engine's bf16 checks sit from a real fault, on
a card.

Builds faulted copies of the two kernel libraries that run the shared
``wgmma`` mainloop (``ops/csrc/attention_tile.cuh``) into
``ops/build/fault/<fault>/`` (gitignored; the checkout's sources are not
touched), each with one fault planted:

- ``drop_one_tile`` (the mainloop, run through K2 ``flash_fwd``): the
  last q tile skips the P.V product of its first live kv tile (64 of its
  2048 keys; the softmax sum still counts them);
- ``p_truncated`` (the mainloop, through K2): the weights are cut to bf16
  (rounded toward zero) instead of rounded to nearest before P.V;
- ``widen_truncated`` (K1's chunk producer,
  ``ops/csrc/ragged_paged_attention.cu``): dequantized int8/int4 values
  are cut to bf16 instead of rounded to nearest;
- ``scale_bf16`` (K1's chunk producer): an int8 row's scale is rounded
  to bf16 before it multiplies the codes;
- ``ds_truncated`` (the backward's steps, through K3 and K4): dS is cut
  to bf16 (rounded toward zero) instead of rounded to nearest before the
  dK and dQ products;
- ``drop_group_head`` (K3, ``flash_attention.cu``): the first block
  (kv tiles 0 and 1 of kv row 0) skips the last q head of its group;
- ``combine_skips_last_split`` (K1's split combine,
  ``ragged_paged_attention.cu``): a narrow window's combine leaves out
  the last split of every span of more than one;
- ``split_max_not_rescaled`` (K1's split combine): the combine adds the
  splits' partials without the factor ``2^(m_s - m)`` that brings each
  to the row's max.

K2, K3 and K4 run at the training path's shapes (B 2, S 2048, Hq 32,
Hkv 8, hd 128, causal, bf16: ``chip_smoke.py`` phase 5's headline case);
K1's producer faults at phase 2's
bf16 prefill chunks on the int8 dense route (T 256 at bases 0 and 1536,
one slot, Hq 32, Hkv 8, hd 128, S 2048), its split faults at phase 2's
headline bf16 decode (eight slots at bases -1 .. 2047, dense), and the
sound library on all of those and on the int4 and bf16 dense chunks. For
each run and case one JSON line holds:
the max abs error of o against the plain version that computes what the
engine does (``p_bf16=True``) and against the kernel's f32 plain version;
the worst |err| / (atol + rtol |want|) under the tight bf16 tolerance
(against the first) and under the wide one (against the second: K2's
one ulp plus 2^-8 max|v|, K1's atol = rtol = 2e-2); how many elements and
rows the tight tolerance flags; and whether
``kernel_support.bf16_o_mismatch`` (the check ``chip_smoke.py`` applies:
a few rows may miss the tight tolerance, no element the wide one) flags
it. K3's and K4's gradients (dk, dv, dq) the same way, against their
plain versions with and without ``p_bf16``, by
``kernel_support.bf16_grad_mismatch`` (the tight tolerance per element:
summation order and one flip of its largest term; the wide one 2^-8 of
its sum of |terms| plus 1e-4), with whether the wide bound alone would
flag them. A faulted run is flagged when any of its cases is. Exits 1 if
a check flags a sound kernel or misses a fault.

    python3 tools/torch_flash_fault.py
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from unittest import mock

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

HEADER = "attention_tile.cuh"
FLASH_SOURCE = "flash_attention.cu"
RPA_SOURCE = "ragged_paged_attention.cu"


def _cut(x: str, a: str) -> str:
    """The loop that packs fragment ``x`` into A operand ``a`` cut to
    bf16 (rounded toward zero): pack_a's rounding to nearest, faulted."""
    return ("#pragma unroll\n"
            "  for (int kk = 0; kk < 4; ++kk) {\n"
            "#pragma unroll\n"
            "    for (int e = 0; e < 4; ++e)\n"
            f"      {a}[kk][e] = (__float_as_uint({x}[8 * kk + 2 * e]) >> 16) |\n"
            f"                   (__float_as_uint({x}[8 * kk + 2 * e + 1]) & 0xffff0000u);\n"
            "  }\n")


# name: (kernel, [(file, text in it, its faulted replacement), ...]); the
# kernel 'flash' is K2, 'flash_bwd' K3 and K4 (both in the flash library)
FAULTS = {
    "drop_one_tile": ("flash", [(
        HEADER,
        "  rs_product<HD>(acc.o, pa, v_tile);\n",
        "  if (!(blockIdx.x == 0 && threadIdx.x >= 128 && kv0 == 0))\n"
        "    rs_product<HD>(acc.o, pa, v_tile);\n",
    )]),
    "p_truncated": ("flash", [(HEADER, "  pack_a(s, pa);\n", _cut("s", "pa"))]),
    "widen_truncated": ("rpa", [(
        RPA_SOURCE,
        "    return make_uint4(attn_tile::pack_bf16(f[0], f[1]),\n"
        "                      attn_tile::pack_bf16(f[2], f[3]),\n"
        "                      attn_tile::pack_bf16(f[4], f[5]),\n"
        "                      attn_tile::pack_bf16(f[6], f[7]));\n",
        "    auto cut = [](float lo, float hi) {\n"
        "      return (__float_as_uint(lo) >> 16) |"
        " (__float_as_uint(hi) & 0xffff0000u);\n"
        "    };\n"
        "    return make_uint4(cut(f[0], f[1]), cut(f[2], f[3]),"
        " cut(f[4], f[5]), cut(f[6], f[7]));\n",
    )]),
    "scale_bf16": ("rpa", [(
        RPA_SOURCE,
        "      f[e] = float(int(int8_t((word >> (8 * (e % 4))) & 0xffu))) * scale;\n",
        "      f[e] = float(int(int8_t((word >> (8 * (e % 4))) & 0xffu))) *\n"
        "             __bfloat162float(__float2bfloat16(scale));\n",
    )]),
    "ds_truncated": ("flash_bwd", [
        (HEADER, "  pack_a(dp, dsa);\n", _cut("dp", "dsa")),
        (HEADER, "  pack_a(dpt, dsa);\n", _cut("dpt", "dsa")),
    ]),
    "drop_group_head": ("flash_bwd", [(
        FLASH_SOURCE,
        "    if (it >= mine_lo && it <= mine_hi) {\n",
        "    if (it >= mine_lo && it <= mine_hi &&\n"
        "        !(blockIdx.x == 0 && blockIdx.y == 0 && n / n_q == group - 1)) {\n",
    )]),
    "combine_skips_last_split": ("rpa_split", [(
        RPA_SOURCE,
        "    for (int s = 0; s < n_live; ++s) {\n"
        "      const float* ps = p + s * kSplitStride;\n",
        "    for (int s = 0; s < n_live - 1; ++s) {\n"
        "      const float* ps = p + s * kSplitStride;\n",
    )]),
    "split_max_not_rescaled": ("rpa_split", [(
        RPA_SOURCE,
        "      const float w = exp2f(__ldcg(ps + HD) - m);\n",
        "      const float w = 1.f;\n",
    )]),
}
# the library each kernel's faults are built into ('rpa_split': K1's
# narrow-window split launch)
LIBRARY = {"flash": "flash", "flash_bwd": "flash", "rpa": "rpa",
           "rpa_split": "rpa"}
B, S, HQ, HKV, HD = 2, 2048, 32, 8, 128
# K1's cases, (route, T, bases): phase 2's bf16 chunks of one slot for the
# producer faults, its headline decode of eight slots for the split ones
RPA_CASES = {"rpa": [("int8_dense", 256, [0]), ("int8_dense", 256, [1536])],
             "rpa_split": [("dense", 1, [-1, 0, 1, 255, 256, 1000, 2046,
                                         2047])]}
RPA_SOUND_ONLY = [("int4_dense", 256, [0]), ("dense", 256, [0])]


def build_edited(modules, kernel_support, name: str, kernel: str, edits):
    """Copies of ``ops/csrc`` in ``ops/build/fault/<name>/`` with each
    (file, text, replacement) of ``edits`` applied (the text must be in
    its file exactly once), and the ``kernel`` library ('flash' or 'rpa')
    built from them and bound like the sound one."""
    fault_dir = kernel_support.BUILD_DIR / "fault" / name
    fault_dir.mkdir(parents=True, exist_ok=True)
    for src in kernel_support.CSRC_DIR.glob("*.cu*"):
        text = src.read_text()
        for path, old, new in edits:
            if src.name == path:
                if text.count(old) != 1:
                    raise RuntimeError(f"{name}: the text to edit is not in "
                                       f"{path} exactly once: {old[:60]!r}")
                text = text.replace(old, new)
        (fault_dir / src.name).write_text(text)
    mod = modules[kernel]
    lib = kernel_support.load_library(f"{mod.SOURCE.stem}_{name}",
                                      [fault_dir / mod.SOURCE.name],
                                      build_dir=fault_dir,
                                      header_dir=fault_dir)
    if kernel == "flash":
        for fn, argtypes in mod._ARGTYPES.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
    else:
        lib.rpa_forward.argtypes = mod.ARGTYPES
        lib.rpa_forward.restype = ctypes.c_int
    return lib


def main() -> int:
    import torch

    from chip_smoke import TOL, route_operands
    from k8s_gpu_device_plugin_torch.ops import flash_attention as fa
    from k8s_gpu_device_plugin_torch.ops import kernel_support
    from k8s_gpu_device_plugin_torch.ops import quant
    from k8s_gpu_device_plugin_torch.ops import ragged_paged_attention as rpa

    if not torch.cuda.is_available():
        print("torch_flash_fault: needs a CUDA card", file=sys.stderr)
        return 1
    modules = {"flash": fa, "rpa": rpa}
    with ThreadPoolExecutor(len(FAULTS) + 2) as pool:
        sound = {"flash": pool.submit(fa.load_kernel),
                 "rpa": pool.submit(rpa.load_kernel)}
        faulted = {name: pool.submit(build_edited, modules, kernel_support,
                                     name, LIBRARY[kernel], edits)
                   for name, (kernel, edits) in FAULTS.items()}
        libs = {kernel: f.result() for kernel, f in sound.items()}
        libs.update({name: f.result() for name, f in faulted.items()})

    tight = kernel_support.O_TOL_BF16

    def ratio(diff, ref, tol):
        return float((diff / (tol["atol"] + tol["rtol"] * ref.abs())).max())

    def row(o, want16, want, wide):
        diff16 = (o.float() - want16.float()).abs()
        diff = (o.float() - want.float()).abs()
        elements, rows = kernel_support.off_one_ulp(o, want16)
        why = kernel_support.bf16_o_mismatch(o, want16, want, wide)
        return {
            "max_abs_err_vs_p_bf16": float(diff16.max()),
            "max_abs_err_vs_plain": float(diff.max()),
            "ratio_tight": ratio(diff16, want16.float(), tight),
            "ratio_wide": ratio(diff, want.float(), wide),
            "elements_off_tight": elements,
            "rows_flagged_tight": rows,
            "flagged": why is not None,
            "why": why,
        }

    runs = {}
    # K2 at phase 5's headline shape
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    q, k, v = (torch.randn((B * h, S, HD), generator=gen, device="cuda",
                           dtype=torch.bfloat16) for h in (HQ, HKV, HKV))
    kw = dict(scale=HD ** -0.5)
    want = fa.flash_fwd_reference(q, k, v, **kw)[0]
    want16 = fa.flash_fwd_reference(q, k, v, p_bf16=True, **kw)[0]
    for name in ("flash", *(n for n in FAULTS if FAULTS[n][0] == "flash")):
        with mock.patch.object(fa, "load_kernel", lambda lib=libs[name]: lib):
            o = fa.flash_fwd(q, k, v, **kw)[0]
        torch.cuda.synchronize()
        runs[name] = {"flash_fwd b2_s2048": row(o, want16, want,
                                                fa.o_wide_tol(v))}

    # K3 and K4 at the same shape, from the plain forward's lse and delta
    gen.manual_seed(1)
    do = torch.randn((B * HQ, S, HD), generator=gen, device="cuda",
                     dtype=torch.bfloat16)
    o, lse = fa.flash_fwd_reference(q, k, v, **kw)
    delta = (do.float() * o.float()).sum(-1, keepdim=True)
    bwd = (q, k, v, do, lse, delta)
    want = {"dq": fa.flash_bwd_dq_reference(*bwd, **kw)}
    want["dk"], want["dv"] = fa.flash_bwd_dkv_reference(*bwd, **kw)
    want16 = {"dq": fa.flash_bwd_dq_reference(*bwd, p_bf16=True, **kw)}
    want16["dk"], want16["dv"] = fa.flash_bwd_dkv_reference(*bwd, p_bf16=True,
                                                           **kw)
    magnitude = fa.flash_bwd_magnitudes(*bwd, **kw)
    del o

    def grad_row(g, name):
        mag, g_p, g_r = magnitude[name], want16[name], want[name]
        diff16, diff = (g - g_p).abs(), (g - g_r).abs()
        elements, rows = kernel_support.off_grad_tight(g, g_p, mag)
        wide = float((diff / kernel_support.grad_wide_tol(mag)).max())
        why = kernel_support.bf16_grad_mismatch(g, g_p, g_r, mag)
        return {
            "max_abs_err_vs_p_bf16": float(diff16.max()),
            "max_abs_err_vs_plain": float(diff.max()),
            "ratio_tight": float((diff16 / kernel_support.grad_tight_tol(
                mag)).max()),
            "ratio_wide": wide,
            "elements_off_tight": elements,
            "rows_flagged_tight": rows,
            "flagged_by_wide_alone": wide > 1,
            "flagged": why is not None,
            "why": why,
        }

    for name in ("flash_bwd", *(n for n in FAULTS
                                if FAULTS[n][0] == "flash_bwd")):
        lib = libs["flash" if name == "flash_bwd" else name]
        with mock.patch.object(fa, "load_kernel", lambda lib=lib: lib):
            got = {"dq": fa.flash_bwd_dq(*bwd, **kw)}
            got["dk"], got["dv"] = fa.flash_bwd_dkv(*bwd, **kw)
        torch.cuda.synchronize()
        runs[name] = {f"{g} b2_s2048": grad_row(got[g], g)
                      for g in ("dk", "dv", "dq")}
    del bwd, want, want16, magnitude

    # K1 on phase 2's inputs: chunks of one slot, the decode of eight
    def rpa_case(route, t, bases):
        b = len(bases)
        case = dict(route=route, ps=0, b=b, t=t, s=S, bases=bases)
        gen.manual_seed(0)
        q = torch.randn((b, t, HQ, HD), generator=gen, device="cuda",
                        dtype=torch.bfloat16)
        k0, v0 = (torch.randn((b, S, HKV, HD), generator=gen, device="cuda",
                              dtype=torch.bfloat16) for _ in range(2))
        k, v, ks, vs, _ = route_operands(torch, quant, case, k0, v0, gen)
        args = (q, k, v, torch.tensor(bases, dtype=torch.int32,
                                      device="cuda"))
        return args, dict(scale=HD ** -0.5, k_scale=ks, v_scale=vs)

    rpa_runs = {"rpa": RPA_CASES["rpa"] + RPA_SOUND_ONLY
                + RPA_CASES["rpa_split"]}
    rpa_runs.update({n: RPA_CASES[FAULTS[n][0]] for n in FAULTS
                     if FAULTS[n][0] in RPA_CASES})
    for name, cases in rpa_runs.items():
        runs[name] = {}
        for route, t, bases in cases:
            args, kw = rpa_case(route, t, bases)
            want = rpa.ragged_paged_attention_reference(*args, **kw)
            want16 = rpa.ragged_paged_attention_reference(
                *args, p_bf16=True, split_tiles=rpa.window_split(t, HQ // HKV),
                **kw)
            with mock.patch.object(rpa, "load_kernel",
                                   lambda lib=libs[name]: lib):
                o = rpa.ragged_paged_attention(*args, **kw)
            torch.cuda.synchronize()
            tag = f"base{bases[0]}" if len(bases) == 1 else f"{len(bases)}_slots"
            runs[name][f"rpa {route} t{t}_{tag}"] = row(
                o, want16, want, TOL["bfloat16"])

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
    ).stdout.strip()
    for name, cases in runs.items():
        for case, numbers in cases.items():
            print(json.dumps({"card": card, "run": name, "case": case,
                              "tight_tol": tight, **numbers}))
    flagged = {name: any(c["flagged"] for c in cases.values())
               for name, cases in runs.items()}
    print(json.dumps({"card": card, "flagged": flagged}))
    if flagged["flash"] or flagged["rpa"] or flagged["flash_bwd"]:
        print("torch_flash_fault: a sound kernel fails its own checks",
              file=sys.stderr)
        return 1
    missed = [name for name in FAULTS if not flagged[name]]
    if missed:
        print(f"torch_flash_fault: no check flags {missed}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
