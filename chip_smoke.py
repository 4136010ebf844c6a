#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA H100 and check its kernel.

Run from the repository root, on a machine with one CUDA card:

    python3 chip_smoke.py

Phases (any failed check exits non-zero without the final line):

1. The card (``nvidia-smi`` name and power limit), torch and CUDA
   versions; the hand-written kernels are built from the sources in the
   checkout (one ``nvcc`` per source, started together), timed; then
   ``cuobjdump -sass`` counts the HGMMA (``wgmma``) instructions of every
   kernel symbol, and every instantiation of the four tensor-core kernels
   (``flash_fwd_tc_kernel``, ``flash_bwd_dkv_tc_kernel``,
   ``flash_bwd_dq_tc_kernel``, ``rpa_tc_kernel``) must have some.
2. ``ragged_paged_attention``'s kernel against its plain version at the
   Llama-3-8B attention shapes (Hq 32, Hkv 8, hd 128, S 2048), each case
   in bf16 and f32, on every route (a dense cache; a paged pool read
   through a shuffled table, pages of 64 and of 16 rows; int8 codes and
   int4 codes packed two per byte, with f32 scales, on both layouts):
   decode over eight slots (also windowed and at hd 64, group 1, dense
   and int4), and prefill chunks as the batcher runs them (one slot):
   T 3, T 37, T 256 at bases 0, 256 and 1536, windowed and at hd 64,
   group 1, and whole bucketed prompts (``--chunkedPrefill 0``) of T 512
   and T 1024 at base 0. Every bf16 case runs on the tensor cores (decode split over
   each slot's span, ``SPLIT_TILES`` kv tiles a block), f32 on the CUDA
   cores: each launch must be counted on its engine, and two launches on
   the same inputs must agree bit for bit. A tensor-core case is held to
   one ulp of the plain version that rounds where the engine does
   (``p_bf16=True``, split where a decode launch splits) and to the f32
   plain version within TOL; the others to the f32 plain version within
   TOL. On the dense and paged bf16 decode cases each slot launched alone
   must equal the slot among its neighbours bit for bit. Per case: max
   error, kernel / plain / library times (and, for bf16 decode and at
   T 256, the CUDA-core engine's time on the same inputs; for decode the
   splits per slot and the blocks an SM holds)
   (CUDA-graph replays timed with CUDA events; the library yardstick, which
   the port never calls, is ``scaled_dot_product_attention`` after a
   gather of the pool and a dequantization of the codes into a dense
   view) and the bound (bytes over 3.35 TB/s or operations over the peak
   of the query type, whichever is larger). A paged case must equal the
   dense route on the same rows bit for bit.
3. Llama-3-8B with random weights: a 512-token prefill (two chunks of
   256) and 8 greedy decode steps through the kernel path and through the
   plain path; last-position f32 logits compared. The same through a
   paged pool and through int8 and int4 pools: kernel path against plain
   path in f32 (the quantized kernels on the model's own codes), and the
   paged kernel path bit for bit against the dense one. Then the same
   weights quantized (``--weightQuant`` int8, int4): kernel path against
   plain path in f32, and their distance from the bf16 weights' logits.
4. First the decode step captured as a CUDA graph against the eager
   step (dense bf16, paged int8, and ``w4_int4_paged`` after phase 3's
   int4 weights): a batcher serves a greedy request with a bias row, a
   seeded and an unseeded sampled one; three times a copy of its state
   (the cache bytes included, a pool's trap page aside) and of its
   generator takes an eager ``decode_step`` while the batcher replays the
   graph, and tokens, logprobs and every state tensor must agree bit for
   bit, the replay moving the generator on; the seeded stream alone must
   equal itself among its neighbours. Then the server
   (``serving/server.py``) with ``--preset llama3_8b --slots 8 --maxLen
   2048 --chunkedPrefill 256`` (the pipelined loop, ``--pipelineDepth
   1``) on 127.0.0.1: six concurrent ``/v1/generate`` requests (one
   streamed, one with logprobs), launch counts over exactly that run
   (every decode step a graph replay, counted as the launches its
   capture recorded), and one request replayed alone. The same on
   ``--pipelineDepth 0`` (served first: its tokens are the ones the
   pipelined dense run and the unquantized pool must give) and on
   ``--chunkedPrefill 0`` (bucketed prefill: the 1500- and 1900-token
   prompts answer 422, the other four are served; TTFT beside the
   chunked run's). Then the same six requests on ``--kvLayout paged
   --kvPageSize 64 --kvPages 65``
   (64 allocatable pages against the 79 the six reserve together, so an
   admission must wait): the dense run's tokens, every launch on the paged
   route, the pool empty at the end; on ``--cacheQuant int8`` and ``int4``,
   paged and dense; on ``--weightQuant int8`` (bf16 dense cache); and on
   ``--weightQuant int4 --cacheQuant int4`` in the 65-page pool. Every
   launch (the model is bf16: chunks and decode steps) must be on the
   tensor cores.
5. The flash-attention kernels (``flash_fwd``, ``flash_bwd_dkv``,
   ``flash_bwd_dq``) against their plain versions at the shapes phase 6
   gives them (B 2, S 2048, Hq 32, Hkv 8, hd 128, causal), a window-512
   case and an hd-64 group-1 case, each in bf16 (the tensor cores) and
   f32 (the CUDA cores; each launch counted on its engine, two launches
   of each kernel equal bit for bit): max errors of o, dq, dk, dv (bf16:
   against the plain versions that round p, and dS, where the kernels
   do, and against the f32 ones: kernel_support.bf16_o_mismatch and
   bf16_grad_mismatch; f32 within TOL and GRAD_TOL) and lse; kernel /
   plain times;
   ``scaled_dot_product_attention``'s forward, backward and forward +
   backward as a yardstick the port never calls; the bound (operations
   over the input type's peak or bytes over 3.35 TB/s).
6. The trainer (``models/trainer.py``) on Llama-3-8B widths cut to 8
   layers, B 2, S 2048, 5 steps: step-1 loss near the random init's
   expected ln(vocab) + d * 0.02^2 / 2, finite loss
   and grad_norm, flash launches per layer and step counted over exactly
   that run (every launch on the tensor cores), no ``mha_reference``
   route, the losses equal bit for bit to a second run's; step ms,
   tokens/s, MFU, peak memory. Then one step of a 2-layer f32 copy at the
   same B and S
   through the kernels (on the CUDA cores) and through the plain
   attention: loss and grad_norm compared; and the gradients of a bf16
   copy of its weights through the kernels and through the plain
   attention: per leaf, the kernel path's distance to the f32 plain
   path's gradients at most BF16_FACTOR times the plain path's.
7. One ``{"kernels": [...]}`` line (all four kernels; the ragged-paged
   kernel's entry carries its six routes and the decode graph's checks
   and pool bytes).
8. The last line: ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import math
import os
import subprocess
import sys
import threading
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.abspath(__file__))
SEED = 0

HBM_BYTES_PER_S = 3.35e12            # H100 SXM, NVIDIA data sheet
PEAK_FLOPS = {"bfloat16": 989e12,    # dense tensor-core bf16
              "float32": 67e12}      # f32 outside the tensor cores
TOL = {"bfloat16": dict(atol=2e-2, rtol=2e-2),   # bf16 output rounding
       "float32": dict(atol=1e-4, rtol=0.0)}     # summation order only
LOGITS_BOUND = 1e-3   # phase 3: f32 model, kernel vs plain path, max abs
BF16_FACTOR = 1.5     # phase 3: bf16 kernel path's distance to the f32
                      # model, at most this times the plain path's

# The tensor-core engine (K1's bf16 chunks, K2 bf16) rounds its weights p
# to bf16 before P V, and K1's producer rounds dequantized K/V rows to
# bf16: each kernel is held to one ulp of the plain version that rounds
# them where the kernel does (``p_bf16=True``; a weight on a rounding
# boundary may flip, in a few rows: kernel_support.FLIP_ROWS),
# and to its f32 plain version within a wide bound: K1's TOL above, K2's
# one ulp plus 2^-8 max|v| (each weight moves by at most 2^-8 of itself,
# the weights sum to l; flash_attention.o_wide_tol). One check holds both:
# kernel_support.bf16_o_mismatch. Phase 5's f32 o is held to TOL. The
# tensor-core backward (K3, K4 bf16) rounds p and dS to bf16 before its
# gradient products: its f32 gradients are held to the plain versions
# that round them there (p_bf16=True) within the summation order of the
# same products and one flip of an element's largest term (in all but a
# few rows), and to the f32 plain versions within 2^-8 of each element's
# sum of |terms| plus GRAD_TOL's atol: kernel_support.bf16_grad_mismatch.
GRAD_TOL = dict(atol=1e-4, rtol=0.0)  # f32 grads/lse from the same inputs:
                                      # summation order only
TRAIN_LAYERS, TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 8, 2, 2048, 5
LOSS_RTOL, GRAD_NORM_RTOL = 1e-4, 1e-3   # phase 6: kernels vs plain, f32

# bytes of one cached token of Llama-3-8B (32 layers, 8 kv heads, hd 128,
# K and V) per cache type: bf16 rows, or codes plus one f32 scale a row
TOKEN_BYTES = {"none": 131072, "int8": 67584, "int4": 34816}

# (prompt length, max_new); index 3 streams, index 1 asks for logprobs
REQUESTS = [(17, 64), (200, 48), (256, 32), (700, 40), (1500, 56), (1900, 64)]
STREAMED, WITH_LOGPROBS = 3, 1


def fail(message: str) -> None:
    print(f"chip_smoke: FAIL: {message}", file=sys.stderr, flush=True)
    sys.exit(1)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


# --- phase 1 -----------------------------------------------------------------


def card_line() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if proc.returncode != 0:
        fail(f"nvidia-smi failed: {proc.stderr.strip()}")
    return proc.stdout.strip()


def hgmma_counts(kernel_support, lib) -> dict[str, int]:
    """HGMMA instructions (wgmma in SASS) per kernel symbol of a built
    library, from ``cuobjdump -sass`` beside nvcc."""
    tool = os.path.join(os.path.dirname(kernel_support.find_nvcc()),
                        "cuobjdump")
    proc = subprocess.run([tool, "-sass", lib._name], capture_output=True,
                          text=True, timeout=300)
    if proc.returncode != 0:
        fail(f"cuobjdump -sass {lib._name} failed: {proc.stderr[-2000:]}")
    counts, symbol = {}, None
    for line in proc.stdout.splitlines():
        if "Function :" in line:
            symbol = line.split("Function :", 1)[1].strip()
            counts[symbol] = 0
        elif symbol is not None and "HGMMA" in line:
            counts[symbol] += 1
    return counts


# the tensor-core kernels: every instantiation must hold wgmma
TC_KERNELS = ("flash_fwd_tc_kernel", "flash_bwd_dkv_tc_kernel",
              "flash_bwd_dq_tc_kernel", "rpa_tc_kernel")


def phase_sass(kernel_support, libs) -> None:
    """Phase 1's proof that the redesigned kernels run on the tensor
    cores: the HGMMA count of every kernel symbol; fails if an
    instantiation of a tensor-core kernel has none (or none exists)."""
    counts = {}
    for name, lib in libs.items():
        counts[name] = hgmma_counts(kernel_support, lib)
        emit({"phase": 1, "library": name, "hgmma_per_kernel": counts[name]})
    for kernel in TC_KERNELS:
        mine = {sym: n for per_lib in counts.values()
                for sym, n in per_lib.items() if kernel in sym}
        if not mine or not all(mine.values()):
            fail(f"{kernel}: no HGMMA in some instantiation: {mine}")


# --- phase 2 -----------------------------------------------------------------


def graph_ms(torch, fn, reps: int, iters: int = 5) -> float:
    """Mean device time of one ``fn()``: ``reps`` calls captured in a CUDA
    graph, the graph replayed ``iters`` times between CUDA events (no
    host launch overhead in the number)."""
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(stream)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (iters * reps)


# every route of the kernel: (route, page size), pages of 64 and of 16
ROUTE_LAYOUTS = (("dense", 0), ("paged", 64), ("paged", 16),
                 ("int8_dense", 0), ("int8_paged", 64), ("int8_paged", 16),
                 ("int4_dense", 0), ("int4_paged", 64), ("int4_paged", 16))


def kernel_cases():
    bases8 = [-1, 0, 1, 255, 256, 1000, 2046, 2047]
    full = dict(hq=32, hkv=8, hd=128, s=2048)
    narrow = dict(hq=8, hkv=8, hd=64, s=2048)
    cases = [
        dict(name="decode", b=8, t=1, bases=bases8, window=0, **full),
        dict(name="decode_window64", b=8, t=1, bases=bases8, window=64,
             **full),
        dict(name="decode_hd64_group1", b=8, t=1, bases=bases8, window=0,
             **narrow),
    ]
    for case in cases:
        case.update(route="dense", ps=0)
    # the other routes at the serving shapes: decode
    for route, ps in ROUTE_LAYOUTS[1:]:
        tag = route + (f"_ps{ps}" if ps else "")
        cases.append(dict(name=f"decode_{tag}", b=8, t=1, bases=bases8,
                          window=0, route=route, ps=ps, **full))
    # int4's unpacking at the narrower shapes of the dense route's cases
    cases += [
        dict(name="decode_window64_int4_dense", b=8, t=1, bases=bases8,
             window=64, route="int4_dense", ps=0, **full),
        dict(name="decode_hd64_group1_int4_dense", b=8, t=1, bases=bases8,
             window=0, route="int4_dense", ps=0, **narrow),
    ]
    # prefill chunks as the batcher runs them (one slot), on every route:
    # T 3 (12 query vectors, just past the 8-vector decode tile) up to
    # T 256 at three depths, a window and hd 64 at group 1, and whole
    # bucketed prompts of 512 and 1024 rows
    chunks = [("prefill_t3_base100", 3, 100, 0, full),
              ("prefill_t37_base100", 37, 100, 0, full),
              ("prefill_t256_base0", 256, 0, 0, full),
              # a bucketed prefill (--chunkedPrefill 0): the whole padded
              # prompt from base 0, T up to the largest bucket
              ("prefill_t512_base0", 512, 0, 0, full),
              ("prefill_t1024_base0", 1024, 0, 0, full),
              ("prefill_t256_base256", 256, 256, 0, full),
              ("prefill_t256_base1536", 256, 1536, 0, full),
              ("prefill_t256_base1536_window64", 256, 1536, 64, full),
              ("prefill_t256_base1536_hd64_group1", 256, 1536, 0, narrow)]
    for route, ps in ROUTE_LAYOUTS:
        tag = "" if route == "dense" else "_" + route + (f"_ps{ps}" if ps else "")
        for name, t, base, window, shape in chunks:
            cases.append(dict(name=name + tag, b=1, t=t, bases=[base],
                              window=window, route=route, ps=ps, **shape))
    return cases


def chunk_headline(case) -> bool:
    """The prefill chunk each route's entry reports: T 256 at base 1536,
    no window, hd 128 (a phase-2 case or its result row)."""
    return (case["t"] == 256 and case["bases"] == [1536]
            and case["window"] == 0 and case["hd"] == 128)


def cache_quant_of(route: str) -> str:
    """The cache type a route name carries: 'none', 'int8' or 'int4'."""
    head = route.split("_")[0]
    return head if head in ("int8", "int4") else "none"


def bound(case, rpa, torch, dtype_name: str) -> tuple[float, str, dict]:
    """Least time for the work this case's data needs: every input byte
    read once (q, the K/V rows some query attends with their scale rows on
    an int8 or int4 cache, base, the table entries of those rows), the
    output written once; 4 * hd operations per (query, q head, attended
    row), at the query type's peak."""
    elem = 2 if dtype_name == "bfloat16" else 4
    code_bytes = {"int8": 1, "int4": 0.5}.get(cache_quant_of(case["route"]))
    quantized = code_bytes is not None
    base = torch.tensor(case["bases"], dtype=torch.int32)
    rows = rpa.attended_rows(base, case["t"], case["window"])   # (B, T)
    q_pos = torch.clamp(base[:, None].long() + torch.arange(case["t"]), min=0)
    kv_rows = table_entries = 0
    for b in range(case["b"]):
        lo = int((q_pos[b] - rows[b] + 1).min())
        hi = int(q_pos[b].max())
        kv_rows += hi - lo + 1
        if case["ps"]:
            table_entries += hi // case["ps"] - lo // case["ps"] + 1
    q_bytes = case["b"] * case["t"] * case["hq"] * case["hd"] * elem
    kv_bytes = 2 * kv_rows * case["hkv"] * case["hd"] * (code_bytes or elem)
    if quantized:
        kv_bytes += 2 * kv_rows * case["hkv"] * 4
    nbytes = int(2 * q_bytes + kv_bytes + 4 * case["b"] + 4 * table_entries)
    flops = 4 * case["hd"] * case["hq"] * int(rows.sum())
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    by = "bytes" if t_bytes >= t_ops else "operations"
    return max(t_bytes, t_ops), by, {"bytes": nbytes, "flops": flops}


def route_operands(torch, quant, case, k, v, gen):
    """The dense rows ``k``/``v`` (B, S, Hkv, hd) as the case's route
    takes them: (k, v, k_scale, v_scale, pages). int8 and int4 routes
    quantize the rows with the cache's own recipe (int4 codes packed two
    per byte); paged routes scatter them into a
    pool through a shuffled table that reserves, per slot, the pages its
    live rows need (the rest of its row is 0, the trap page, which holds
    finite garbage)."""
    ks = vs = pages = None
    codes = cache_quant_of(case["route"])
    if codes == "int8":
        k, ks = quant.quantize_int8(k, axis=-1)
        v, vs = quant.quantize_int8(v, axis=-1)
    elif codes == "int4":
        (k, ks), (v, vs) = (quant.quantize_int4_sym(x, axis=-1)
                            for x in (k, v))
        k, v = quant.pack_int4(k), quant.pack_int4(v)
    if case["ps"]:
        ps, b = case["ps"], case["b"]
        nsp = case["s"] // ps
        n_pages = 1 + b * nsp
        ids = (torch.randperm(n_pages - 1, generator=gen, device="cuda")
               + 1).int()
        pages = torch.zeros((b, nsp), dtype=torch.int32, device="cuda")
        for i, base in enumerate(case["bases"]):
            n = max(1, -(-(base + case["t"]) // ps))
            pages[i, :n] = ids[i * nsp:i * nsp + n]

        def pool_of(rows, trap):
            pool = torch.empty((n_pages, ps, *rows.shape[2:]),
                               dtype=rows.dtype, device="cuda")
            pool[ids.long()] = rows.reshape(b * nsp, ps, *rows.shape[2:])
            pool[0] = trap
            return pool

        k, v = pool_of(k, k[0, :ps]), pool_of(v, v[0, :ps])
        if ks is not None:
            ks, vs = pool_of(ks, ks[0, :ps]), pool_of(vs, vs[0, :ps])
    return k, v, ks, vs, pages


def phase_kernels(torch, rpa, quant, kernel_support) -> list[dict]:
    import torch.nn.functional as F

    results = []
    for case in kernel_cases():
        for dtype in (torch.bfloat16, torch.float32):
            dname = str(dtype).split(".")[-1]
            gen = torch.Generator(device="cuda")
            gen.manual_seed(SEED)
            b, t, hq, hkv, hd, s = (case[k] for k in
                                    ("b", "t", "hq", "hkv", "hd", "s"))
            q = torch.randn((b, t, hq, hd), generator=gen, device="cuda",
                            dtype=dtype)
            k0 = torch.randn((b, s, hkv, hd), generator=gen, device="cuda",
                             dtype=dtype)
            v0 = torch.randn((b, s, hkv, hd), generator=gen, device="cuda",
                             dtype=dtype)
            base = torch.tensor(case["bases"], dtype=torch.int32,
                                device="cuda")
            k, v, ks, vs, pages = route_operands(torch, quant, case, k0, v0,
                                                 gen)
            kw = dict(scale=hd ** -0.5, window=case["window"], k_scale=ks,
                      v_scale=vs)

            def kernel():
                return rpa.ragged_paged_attention(q, k, v, base, pages, **kw)

            def plain():
                return rpa.ragged_paged_attention_reference(q, k, v, base,
                                                            pages, **kw)

            engine = rpa.engine(dtype, t, hq // hkv)
            tc = engine == "tensor_cores"
            split = rpa.window_split(t, hq // hkv) if tc else None
            kernel_support.reset_launch_counts()
            got = kernel()
            counts = kernel_support.launch_counts()
            blocks_per_sm = rpa.load_kernel().rpa_blocks_per_sm() if tc \
                else None
            again = kernel()
            want = plain()
            torch.cuda.synchronize()
            label = f"{case['name']} {dname}"
            if counts.get(kernel_support.engine_key(rpa.NAME, engine)) != 1:
                fail(f"{label}: the launch was not counted on the {engine} "
                     f"engine: {counts}")
            if not torch.isfinite(got).all():
                fail(f"{label}: non-finite kernel output")
            if not torch.equal(got, again):
                fail(f"{label}: two launches on the same inputs differ")
            err = float((got.float() - want.float()).abs().max())
            err_p = off_one_ulp = None
            if tc:  # the tolerances above: one ulp of what the engine does
                want_p = rpa.ragged_paged_attention_reference(
                    q, k, v, base, pages, p_bf16=True, split_tiles=split,
                    **kw)
                why = kernel_support.bf16_o_mismatch(got, want_p, want,
                                                     TOL[dname])
                if why is not None:
                    fail(f"{label}: {why}")
                err_p = float((got.float() - want_p.float()).abs().max())
                off_one_ulp = kernel_support.off_one_ulp(got, want_p)
                del want_p
            elif not torch.allclose(got.float(), want.float(), **TOL[dname]):
                fail(f"{label}: kernel disagrees with its plain version "
                     f"(max abs err {err:.3e}, {TOL[dname]})")
            if pages is not None:
                # the same rows through the dense route of the same cache
                # type: the layouts must agree bit for bit
                dense_case = dict(case, ps=0)
                dk, dv, dks, dvs, _ = route_operands(torch, quant, dense_case,
                                                     k0, v0, gen)
                dense = rpa.ragged_paged_attention(
                    q, dk, dv, base, scale=kw["scale"],
                    window=case["window"], k_scale=dks, v_scale=dvs)
                if not torch.equal(got, dense):
                    fail(f"{label}: the paged route differs from the dense "
                         "route on the same rows (max abs "
                         f"{float((got.float() - dense.float()).abs().max()):.3e})")
                del dk, dv, dks, dvs, dense
            neighbours = None
            if split and case["route"] in ("dense", "paged"):
                neighbours = alone_equals_batched(torch, rpa, q, k, v, base,
                                                  pages, kw)
                if not all(neighbours):
                    fail(f"{label}: slots {neighbours} launched alone differ "
                         "from the same slots among their neighbours")

            # the library yardstick: a gather of the pool and a
            # dequantization into a dense view of q's type where the route
            # needs them, then SDPA over the whole cache with the same
            # boolean mask (it reads every row, not just the live span)
            q_pos = torch.clamp(base[:, None].long()
                                + torch.arange(t, device="cuda"), min=0)
            k_pos = torch.arange(s, device="cuda")
            mask = k_pos[None, None, :] <= q_pos[:, :, None]
            if case["window"]:
                mask &= q_pos[:, :, None] - k_pos[None, None, :] < case["window"]
            mask = mask[:, None]                       # (B, 1, T, S)
            qs = q.transpose(1, 2).contiguous()
            table = None if pages is None else pages.long()

            def dense_view(x, scale):
                if table is not None:
                    x = x[table].reshape(b, s, hkv, x.shape[-1])
                    scale = None if scale is None else \
                        scale[table].reshape(b, s, hkv, 1)
                if x.dtype == torch.uint8:
                    x = quant.unpack_int4(x)
                if scale is not None:
                    x = (x.float() * scale).to(dtype)
                return x.transpose(1, 2)

            if case["route"] == "dense":  # nothing to gather or widen
                ks_, vs_ = (x.transpose(1, 2).contiguous() for x in (k, v))

            def library():
                kk, vv = ((ks_, vs_) if case["route"] == "dense" else
                          (dense_view(k, ks), dense_view(v, vs)))
                return F.scaled_dot_product_attention(
                    qs, kk, vv, attn_mask=mask, scale=kw["scale"],
                    enable_gqa=hq != hkv,
                )

            reps = 20 if t == 1 else 5
            row = {
                "case": case["name"], "route": case["route"],
                "page_size": case["ps"], "dtype": dname, "engine": engine,
                "b": b, "t": t,
                "hq": hq, "hkv": hkv, "hd": hd, "s": s,
                "bases": case["bases"], "window": case["window"],
                "max_abs_err": err, "max_abs_err_vs_p_bf16": err_p,
                "off_one_ulp_elements_rows": off_one_ulp,
                "paged_equals_dense_bitwise": pages is not None or None,
                "alone_equals_batched": neighbours,
                "split_tiles": split,
                "splits_per_slot": None if split is None else [
                    len(x) for x in rpa.split_plan(case["bases"], t,
                                                   case["window"], s, split)],
                "blocks_per_sm": blocks_per_sm,
                "ms": graph_ms(torch, kernel, reps),
                "plain_ms": graph_ms(torch, plain, max(1, reps // 4)),
                "library_ms": graph_ms(torch, library, reps),
            }
            if tc and (split or chunk_headline(case)):
                # the other engine on the same inputs: a yardstick
                row["cuda_cores_ms"] = graph_ms(
                    torch, lambda: rpa.ragged_paged_attention(
                        q, k, v, base, pages, engine_override="cuda_cores",
                        **kw), reps)
            row["bound_ms"], row["bound_by"], work = bound(case, rpa, torch,
                                                           dname)
            row.update(work)
            emit({"phase": 2, **row})
            results.append(row)
    return results


def alone_equals_batched(torch, rpa, q, k, v, base, pages, kw) -> list[bool]:
    """For each slot, whether its output launched alone (its own q, base
    and cache rows or table row) equals its output among the batch's
    slots, bit for bit."""
    both = rpa.ragged_paged_attention(q, k, v, base, pages, **kw)
    out = []
    for i in range(q.shape[0]):
        def one(x):
            return x[i:i + 1].contiguous()
        if pages is None:
            alone = rpa.ragged_paged_attention(
                one(q), one(k), one(v), one(base), **kw)
        else:
            alone = rpa.ragged_paged_attention(one(q), k, v, one(base),
                                               one(pages), **kw)
        out.append(bool(torch.equal(alone, both[i:i + 1])))
    return out


# --- phase 3 -----------------------------------------------------------------


MODEL_ROWS = 576     # phase 3 cache: 512 + 8 rows, whole pages of 64
MODEL_TABLE = [7, 3, 9, 1, 5, 2, 8, 4, 6]   # nine shuffled pages of a pool


def _model_logits(torch, generate, params, cfg, prompt, tokens, plain):
    """Last-position f32 logits of a 512-token prefill (two 256-token
    chunks) and of 8 decode steps fed ``tokens`` (filled in greedily by
    the first run, followed by the others): (9, V), and the cache they
    left. ``cfg`` names the layout and the cache type."""
    pages = None
    if cfg.kv_layout == "paged":
        cache = generate.KVCache.init_paged(cfg, len(MODEL_TABLE) + 1,
                                            cfg.kv_page_size, "cuda")
        pages = torch.tensor([MODEL_TABLE], dtype=torch.int32, device="cuda")
    else:
        cache = generate.KVCache.init(cfg, 1, MODEL_ROWS, "cuda")
    kw = dict(pages=pages, plain_attention=plain)
    for start in (0, 256):
        last = generate._forward_cached(
            params, prompt[:, start:start + 256], cache, start, cfg,
            last_only=True, **kw,
        )[:, -1]
    logits = [last]
    for i in range(8):
        if len(tokens) == i:
            tokens.append(int(logits[-1].argmax()))
        pos = torch.tensor([512 + i], dtype=torch.int32, device="cuda")
        tok = torch.tensor([[tokens[i]]], device="cuda")
        logits.append(generate._forward_cached(params, tok, cache, pos, cfg,
                                               **kw)[:, -1])
    out = torch.cat(logits).float()
    if not torch.isfinite(out).all():
        fail("model-level logits are not finite")
    return out, cache


def widened(torch, params):
    """The params with every float leaf in f32; quantized leaves (codes
    and f32 scales) as they are."""
    def leaf(x):
        if isinstance(x, dict):
            if set(x) in ({"q", "s"}, {"q4", "s"}):
                return x
            return {k: leaf(v) for k, v in x.items()}
        return x.float()

    return leaf(params)


def checked_attention_patch(torch, generate, record: dict):
    """A stand-in for ``generate._cached_attention`` that runs the kernel
    path and, on the very same operands (the pool as this layer finds
    it), the plain version; the outputs must agree within the f32 kernel
    tolerance. ``record`` collects the worst difference and the calls."""
    orig = generate._cached_attention

    def checked(q, k_cache, v_cache, k_scale, v_scale, base, c, pages=None,
                verify=False, plain=False):
        out = orig(q, k_cache, v_cache, k_scale, v_scale, base, c,
                   pages=pages, verify=verify, plain=False)
        want = orig(q, k_cache, v_cache, k_scale, v_scale, base, c,
                    pages=pages, verify=verify, plain=True)
        diff = float((out - want).abs().max())
        if not torch.allclose(out, want, **TOL["float32"]):
            fail(f"{c.cache_quant} attention on the model's own codes: "
                 f"kernel and plain version differ by {diff:.3e}")
        record["max"] = max(record["max"], diff)
        record["calls"] += 1
        return out

    return orig, checked


def phase_model(torch, generate, cfg, params) -> dict:
    """The bf16 model through the kernel path and the plain path, and the
    same weights widened to f32 through both paths. In f32 the two paths
    differ only in summation order, so they must agree within
    LOGITS_BOUND; in bf16 each path also rounds differently (the plain
    version rounds probabilities to bf16 before the V product, the kernel
    keeps them in f32), so the bf16 check is that the kernel path lies no
    further from the f32 model than the plain path does.

    Then the same model on a paged pool (pages of 64 rows, a shuffled
    table) and on int8 and int4 pools. Unquantized, in f32, the paged
    kernel path against the paged plain path within LOGITS_BOUND. The
    paged kernel path bit for bit against the dense one, for bf16, f32,
    int8 and int4 caches.

    A quantized cache cannot be held to a logits bound across two paths:
    each path quantizes the rows it computed itself, a last-bit
    difference moves a value on a rounding boundary to another code, that
    code moves the next layer's rows by a whole quantization step, and 32
    layers of quantizers carry the difference on (for int8 the codes that
    differ and the logits' distance are printed, not bounded). So each
    quantized kernel is held on identical codes instead: during the f32
    int8 and int4 kernel-path runs every cached-attention call also runs
    the plain version on the very same operands, and the two attention
    outputs must agree within the f32 kernel tolerance. A quantized
    cache's distance to the unquantized cache's logits is printed, not
    bounded. Returns the summary line with the bf16 kernel path's logits
    and greedy tokens, which the weight-quant checks compare against."""
    import numpy as np

    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    params32 = widened(torch, params)
    rng = np.random.default_rng(SEED)
    prompt = torch.tensor(rng.integers(0, cfg.vocab_size, (1, 512)),
                          device="cuda")
    tokens: list[int] = []  # the bf16 kernel path picks; the others follow

    def variant(c, layout, quant):
        return dataclasses.replace(c, kv_layout=layout, cache_quant=quant,
                                   kv_page_size=64)

    checks = {q: {"max": 0.0, "calls": 0} for q in ("int8", "int4")}
    runs, caches = {}, {}
    for name, c, p, layout, quant, plain in (
            ("bf16_kernel", cfg, params, "dense", "none", False),
            ("bf16_plain", cfg, params, "dense", "none", True),
            ("f32_kernel", cfg32, params32, "dense", "none", False),
            ("f32_plain", cfg32, params32, "dense", "none", True),
            ("bf16_paged_kernel", cfg, params, "paged", "none", False),
            ("f32_paged_kernel", cfg32, params32, "paged", "none", False),
            ("f32_paged_plain", cfg32, params32, "paged", "none", True),
            ("bf16_int8_dense_kernel", cfg, params, "dense", "int8", False),
            ("bf16_int8_paged_kernel", cfg, params, "paged", "int8", False),
            ("f32_int8_paged_kernel", cfg32, params32, "paged", "int8", False),
            ("f32_int8_paged_plain", cfg32, params32, "paged", "int8", True),
            ("bf16_int4_dense_kernel", cfg, params, "dense", "int4", False),
            ("bf16_int4_paged_kernel", cfg, params, "paged", "int4", False),
            ("f32_int4_paged_kernel", cfg32, params32, "paged", "int4",
             False)):
        orig = generate._cached_attention
        if name in ("f32_int8_paged_kernel", "f32_int4_paged_kernel"):
            _, generate._cached_attention = checked_attention_patch(
                torch, generate, checks[quant])
        try:
            runs[name], cache = _model_logits(
                torch, generate, p, variant(c, layout, quant), prompt, tokens,
                plain)
        finally:
            generate._cached_attention = orig
        if name.startswith("f32_int8"):
            caches[name] = cache
    torch.cuda.synchronize()
    codes = caches["f32_int8_paged_kernel"].k.numel() * 2
    codes_differ = sum(
        int((getattr(caches["f32_int8_paged_kernel"], leaf)
             != getattr(caches["f32_int8_paged_plain"], leaf)).sum())
        for leaf in ("k", "v"))
    del params32, caches
    torch.cuda.empty_cache()

    def err(a, b):
        return float((runs[a] - runs[b]).abs().max())

    def agree(a, b):
        return "%d/9" % int((runs[a].argmax(-1) == runs[b].argmax(-1)).sum())

    ref = runs["f32_plain"]
    out = {
        "phase": 3,
        "f32_kernel_vs_plain": err("f32_kernel", "f32_plain"),
        "bound": LOGITS_BOUND,
        "bf16_kernel_vs_plain": err("bf16_kernel", "bf16_plain"),
        "bf16_kernel_vs_f32": err("bf16_kernel", "f32_plain"),
        "bf16_plain_vs_f32": err("bf16_plain", "f32_plain"),
        "per_position_bf16_kernel_vs_plain": [
            float(x) for x in
            (runs["bf16_kernel"] - runs["bf16_plain"]).abs().amax(-1)],
        "logits_std": float(ref.std()), "logits_abs_max": float(ref.abs().max()),
        "greedy_agreement_bf16_kernel_vs_plain": agree("bf16_kernel",
                                                       "bf16_plain"),
        "greedy_agreement_bf16_kernel_vs_f32": agree("bf16_kernel",
                                                     "f32_plain"),
        "f32_paged_kernel_vs_plain": err("f32_paged_kernel",
                                         "f32_paged_plain"),
        "f32_int8_paged_kernel_vs_plain_own_codes": err(
            "f32_int8_paged_kernel", "f32_int8_paged_plain"),
        "f32_int8_codes_differing_kernel_vs_plain": f"{codes_differ}/{codes}",
    }
    for quant, check in checks.items():
        out[f"f32_{quant}_attention_kernel_vs_plain_same_codes"] = check["max"]
        out[f"f32_{quant}_attention_calls_checked"] = check["calls"]
        out[f"bf16_{quant}_vs_bf16_cache"] = err(f"bf16_{quant}_paged_kernel",
                                                 "bf16_kernel")
        out[f"f32_{quant}_vs_f32_cache"] = err(f"f32_{quant}_paged_kernel",
                                               "f32_kernel")
        out[f"greedy_agreement_bf16_{quant}_vs_bf16_cache"] = agree(
            f"bf16_{quant}_paged_kernel", "bf16_kernel")
    bitwise = {"bf16_paged_equals_dense": ("bf16_paged_kernel", "bf16_kernel"),
               "f32_paged_equals_dense": ("f32_paged_kernel", "f32_kernel"),
               "int8_paged_equals_int8_dense": ("bf16_int8_paged_kernel",
                                                "bf16_int8_dense_kernel"),
               "int4_paged_equals_int4_dense": ("bf16_int4_paged_kernel",
                                                "bf16_int4_dense_kernel")}
    for key, (a, b) in bitwise.items():
        out[key] = bool(torch.equal(runs[a], runs[b]))
    emit(out)
    for quant, check in checks.items():
        if check["calls"] != cfg.n_layers * 10:
            fail(f"the {quant} attention check saw {check['calls']} calls, "
                 f"not {cfg.n_layers} layers x (2 chunks + 8 steps)")
    for key in ("f32_kernel_vs_plain", "f32_paged_kernel_vs_plain"):
        if out[key] > LOGITS_BOUND:
            fail(f"{key}: f32 kernel-path logits differ from the plain "
                 f"path by {out[key]:.3e} > {LOGITS_BOUND}")
    for key, (a, b) in bitwise.items():
        if not out[key]:
            fail(f"{key}: the paged kernel path's logits differ from the "
                 f"dense kernel path's by {err(a, b):.3e}, not bit-identical")
    if out["bf16_kernel_vs_f32"] > BF16_FACTOR * out["bf16_plain_vs_f32"]:
        fail(f"bf16 kernel path is {out['bf16_kernel_vs_f32']:.3e} from the "
             f"f32 model, more than {BF16_FACTOR}x the plain path's "
             f"{out['bf16_plain_vs_f32']:.3e}")
    return {**out, "bf16_logits": runs["bf16_kernel"], "prompt": prompt,
            "tokens": tokens}


def phase_weights(torch, generate, cfg, qparams, weight_quant: str,
                  model: dict) -> dict:
    """The 8B model on weight-only quantized params (``--weightQuant``):
    the f32 kernel path against the f32 plain path on the same quantized
    weights (codes and scales as they are, the float leaves widened),
    within LOGITS_BOUND; and the bf16 kernel path's distance from the bf16
    weights' logits, with its greedy agreement, printed (the same prompt
    and the tokens the bf16 weights picked)."""
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    params32 = widened(torch, qparams)
    prompt, tokens = model["prompt"], list(model["tokens"])
    runs = {}
    for name, c, p, plain in (("bf16_kernel", cfg, qparams, False),
                              ("f32_kernel", cfg32, params32, False),
                              ("f32_plain", cfg32, params32, True)):
        runs[name], _ = _model_logits(torch, generate, p, c, prompt, tokens,
                                      plain)
    del params32
    torch.cuda.empty_cache()
    ref = model["bf16_logits"]
    out = {
        "phase": 3, "weight_quant": weight_quant,
        "f32_kernel_vs_plain": float(
            (runs["f32_kernel"] - runs["f32_plain"]).abs().max()),
        "bound": LOGITS_BOUND,
        "bf16_vs_bf16_weights": float((runs["bf16_kernel"] - ref).abs().max()),
        "greedy_agreement_vs_bf16_weights": "%d/9" % int(
            (runs["bf16_kernel"].argmax(-1) == ref.argmax(-1)).sum()),
    }
    emit(out)
    if out["f32_kernel_vs_plain"] > LOGITS_BOUND:
        fail(f"--weightQuant {weight_quant}: f32 kernel-path logits differ "
             f"from the plain path by {out['f32_kernel_vs_plain']:.3e} > "
             f"{LOGITS_BOUND}")
    return out


# --- phase 4 -----------------------------------------------------------------


def _post(url: str, body: dict) -> tuple[list[int], "list[float] | None", float]:
    """One /v1/generate; returns (tokens, logprobs, seconds to the first
    token frame for a stream else to the response)."""
    req = urllib.request.Request(
        url + "/v1/generate", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"},
    )
    t0 = time.perf_counter()
    first = None
    with urllib.request.urlopen(req, timeout=600) as resp:
        if not body.get("stream"):
            payload = json.loads(resp.read())
            return payload["tokens"], payload.get("logprobs"), \
                time.perf_counter() - t0
        toks = []
        done = False
        for raw in resp:
            line = raw.decode().strip()
            if not line.startswith("data: "):
                continue
            evt = json.loads(line[len("data: "):])
            if evt.get("done"):
                done = True
                break
            if "error" in evt:
                fail(f"stream error frame: {evt['error']}")
            if first is None:
                first = time.perf_counter() - t0
            toks.append(evt["token"])
        if not done:
            fail("stream ended without its done frame")
        return toks, None, first


# the serving runs: name -> the flags it adds to the base command line.
# Each of the kernel's routes has the run of its name; the two last runs
# serve weight-only quantized params.
POOL_65 = ["--kvLayout", "paged", "--kvPageSize", "64", "--kvPages", "65"]
SERVING_RUNS = {
    "dense": [],
    # the dense run at the synchronous loop, and with bucketed prefill
    "dense_depth0": ["--pipelineDepth", "0"],
    "dense_bucketed": ["--chunkedPrefill", "0"],
    "paged": POOL_65,
    "int8_paged": [*POOL_65, "--cacheQuant", "int8"],
    "int8_dense": ["--cacheQuant", "int8"],
    "int4_dense": ["--cacheQuant", "int4"],
    "int4_paged": [*POOL_65, "--cacheQuant", "int4"],
    "w8": ["--weightQuant", "int8"],
    "w4_int4_paged": ["--weightQuant", "int4", "--cacheQuant", "int4",
                      *POOL_65],
}


# with --chunkedPrefill 0 a prompt past the largest bucket (1024) is
# refused with a 422, as the reference refuses it
BUCKET_REFUSED = {i for i, (plen, _) in enumerate(REQUESTS) if plen > 1024}


def phase_serving(torch, server_mod, kernel_support, rpa, cfg, params,
                  run: str, dense_tokens=None) -> dict:
    """The server for one serving run: the six requests of REQUESTS at
    once, every launch of exactly that run counted by route, all on the
    route its flags name, every decode step a replay of the captured
    graph. ``dense_tokens`` (the dense run's streams) must come back token
    for token from an unquantized pool and from the synchronous loop. A
    paged run must make at least one admission wait (the pool holds 64
    pages, the six reserve 79) and leave the pool empty and consistent.
    The bucketed run must refuse the prompts past the largest bucket with
    a 422 and serve the others. ``params`` are already quantized as the
    run's ``--weightQuant`` says."""
    import urllib.error

    import numpy as np

    args = server_mod.build_parser().parse_args([
        "--preset", "llama3_8b", "--slots", "8", "--maxLen", "2048",
        "--chunkedPrefill", "256", "--host", "127.0.0.1", "--port", "0",
        "--seed", str(SEED), *SERVING_RUNS[run],
    ])
    route = rpa.route_name(args.kvLayout == "paged", args.cacheQuant)
    server = server_mod.build_server(args, params=params)
    server.start()
    url = f"http://127.0.0.1:{server.bound_port}"
    try:
        rng = np.random.default_rng(SEED + 1)
        bodies = []
        for i, (plen, max_new) in enumerate(REQUESTS):
            body = {"prompt": rng.integers(0, cfg.vocab_size, plen).tolist(),
                    "max_new": max_new}
            if i == STREAMED:
                body["stream"] = True
            if i == WITH_LOGPROBS:
                body["logprobs"] = True
            bodies.append(body)
        results: list = [None] * len(bodies)
        errors: list = []

        refused = BUCKET_REFUSED if args.chunkedPrefill == 0 else set()

        def worker(i):
            try:
                results[i] = _post(url, bodies[i])
            except urllib.error.HTTPError as e:
                if i in refused and e.code == 422:
                    results[i] = ([], None, None)
                else:
                    errors.append(f"request {i}: HTTP {e.code}: "
                                  f"{e.read()[:200]!r}")
            except Exception as e:  # noqa: BLE001 - reported below
                errors.append(f"request {i}: {type(e).__name__}: {e}")

        cb = server.engine.cb
        if cb.graph is None or cb.pipeline_depth != args.pipelineDepth:
            fail(f"{run}: the batcher on the card must capture its decode "
                 f"step (graph {cb.graph}, depth {cb.pipeline_depth})")
        steps0, chunks0 = cb.decode_steps, cb.prefill_chunks
        replays0 = cb.graph.replays
        kernel_support.reset_launch_counts()
        t0 = time.perf_counter()
        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(len(bodies))]
        for th in threads:
            th.start()
        for th in threads:
            th.join(900)
        wall = time.perf_counter() - t0
        counts = kernel_support.launch_counts()
        launches = counts.get(rpa.route_key(route), 0)
        if errors or any(r is None for r in results):
            fail(f"{run} serving requests failed: {errors}")
        health = server.engine.stats()
        decode_steps = health["decode_steps"] - steps0
        chunks = health["prefill_chunks"] - chunks0
        if cb.graph.replays - replays0 != decode_steps:
            fail(f"{run}: {decode_steps} decode steps but "
                 f"{cb.graph.replays - replays0} graph replays")
        for i, ((toks, lps, _), (plen, max_new)) in enumerate(
                zip(results, REQUESTS)):
            if i in refused:
                continue
            if len(toks) != max_new:
                fail(f"{run}: request {i} (prompt {plen}) returned "
                     f"{len(toks)} tokens, wanted {max_new}")
            if i == WITH_LOGPROBS and (lps is None or len(lps) != max_new
                                       or not all(x <= 0 for x in lps)):
                fail(f"{run}: request {i}: bad logprobs {lps}")
        need = cfg.n_layers * (decode_steps + chunks)
        if launches < need or counts.get(rpa.NAME, 0) != launches:
            fail(f"the kernel launched {launches} times on the {route} "
                 f"route ({counts}); the serving run needs {need} = "
                 f"{cfg.n_layers} layers x ({decode_steps} decode steps + "
                 f"{chunks} prefill chunks), all on that route")
        # the bf16 model: every prefill chunk and every decode step on the
        # tensor cores
        engines = {e: counts.get(kernel_support.engine_key(rpa.NAME, e), 0)
                   for e in kernel_support.ENGINES}
        want_engines = {"cuda_cores": 0, "tensor_cores": need}
        if engines != want_engines:
            fail(f"{run}: launches per engine {engines}, wanted "
                 f"{want_engines} (every launch of the bf16 model on the "
                 "tensor cores)")
        tokens = [r[0] for r in results]
        if dense_tokens is not None and tokens != dense_tokens:
            bad = next(i for i, (x, y) in enumerate(zip(tokens, dense_tokens))
                       if x != y)
            fail(f"{run}: request {bad}'s greedy stream differs from the "
                 "dense run's")
        served = [i for i in range(len(REQUESTS)) if i not in refused]
        kv = health["kv"]
        want_bytes = (65 * 64 if "paged" in route else 8 * 2048) * \
            TOKEN_BYTES[args.cacheQuant]
        if kv["reserved_bytes"] != want_bytes:
            fail(f"{run}: reserved_bytes {kv['reserved_bytes']}, wanted "
                 f"{want_bytes}")
        if health["weights"]["quant"] != args.weightQuant:
            fail(f"{run}: serving {health['weights']} weights, wanted "
                 f"{args.weightQuant}")
        if "paged" in route:
            if kv["admission_rejected"]["pool_pressure"] < 1:
                fail(f"{run}: no admission waited for pages: {kv}")
            cb.pool.check()
            if kv["pages_in_use"] != 0 or cb.pool.in_use != 0:
                fail(f"{run}: pages still in use after the run: {kv}")
        if run == "dense":
            # the streamed request again, alone: its greedy stream must not
            # depend on the batch it was served in
            alone, _, _ = _post(url, {"prompt": bodies[STREAMED]["prompt"],
                                      "max_new": REQUESTS[STREAMED][1]})
            batched = results[STREAMED][0]
            if alone != batched:
                first = next(i for i, (x, y) in enumerate(zip(alone, batched))
                             if x != y)
                fail(f"greedy stream served alone differs from the batched "
                     f"one at token {first}")
        out = {
            "phase": 4, "run": run, "route": route, "flags": SERVING_RUNS[run],
            "requests": len(bodies), "served": len(served),
            "refused_422": sorted(refused), "wall_s": wall,
            "pipeline_depth": args.pipelineDepth,
            "chunked_prefill": args.chunkedPrefill,
            "decode_graph": health["decode"]["graph"],
            "pipeline_flushes": health["decode"]["pipeline_flushes"],
            "launches": launches, "launches_per_engine": engines,
            "decode_steps": decode_steps,
            "prefill_chunks": chunks, "launches_needed": need,
            "ttft_s_p50": health["ttft_s_p50"],
            "stream_ttft_s": results[STREAMED][2],
            "decode_tokens_per_s": health["decode_tokens_per_s"],
            "decode_step_ms_mean": health["decode_step_ms_mean"],
            "prefill_chunk_ms_mean": health["prefill_chunk_ms_mean"],
            "kv": kv, "weights": health["weights"],
            "equals_dense_tokens": dense_tokens is not None or None,
            "alone_equals_batched": run == "dense" or None,
            "max_memory_allocated_gib":
                torch.cuda.max_memory_allocated() / 2**30,
            "tokens": tokens,
        }
        emit({k: v for k, v in out.items() if k != "tokens"})
        return out
    finally:
        server.stop()


# the graph check's requests: (prompt length, max_new, sampler knobs, seed,
# logit bias); the greedy row carries the one bias row (a ban of the
# unbiased first token and a push on another)
GRAPH_REQUESTS = [
    (300, 64, {}, None, "ban"),
    (450, 64, {"temperature": 1.0, "top_k": 50}, 7, None),
    (200, 64, {"temperature": 0.8, "top_p": 0.9}, None, None),
]
GRAPH_STEPS = 3  # replays checked against the eager step, one after another


def _state_tensors(state) -> dict:
    """Every tensor of a BatchState (the cache's planes included)."""
    out = {name: getattr(state, name) for name in
           ("lengths", "last_token", "active", "presence", "budget", "seeds",
            "draws", "pages") if getattr(state, name) is not None}
    for name in ("k", "v", "k_scale", "v_scale"):
        x = getattr(state.cache, name)
        if x is not None:
            out["cache." + name] = x
    return out


def phase_graph(torch, batching, sampling, cfg, params, run: str,
                flags: list) -> dict:
    """The captured decode step against the eager one, on the card. One
    batcher (8 slots, 2048 rows, the run's layout and cache type) serves
    a greedy request with a bias row, a seeded and an unseeded sampled
    request until all three decode; then, GRAPH_STEPS times, a copy of
    the state (every tensor, the cache bytes included) and of the shared
    generator's state takes one eager ``decode_step`` while the batcher
    replays its graph: tokens, logprobs and every state tensor must agree
    bit for bit, and the replay must move the shared generator on (fresh
    unseeded noise each step). Then the seeded request alone in a fresh
    batcher must give the stream it gave among its neighbours."""
    import numpy as np

    kw = dict(n_slots=8, max_len=2048, chunked_prefill=256,
              kv_layout="paged" if "paged" in run else "dense",
              kv_page_size=64, kv_pages=65 if "paged" in run else 0)
    if kw["kv_layout"] == "dense":
        kw.pop("kv_page_size"), kw.pop("kv_pages")
    rcfg = dataclasses.replace(
        cfg, cache_quant=flags[flags.index("--cacheQuant") + 1]
        if "--cacheQuant" in flags else "none")
    rng = np.random.default_rng(SEED + 2)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
               for n, *_ in GRAPH_REQUESTS]

    def serve(cb, which):
        rids = {}
        for i in which:
            _, max_new, knobs, seed, bias = GRAPH_REQUESTS[i]
            rids[i] = cb.submit(
                prompts[i], max_new,
                sampler=sampling.Sampler(**knobs) if knobs else None,
                seed=seed, logit_bias={int(ban): -100.0, 5: 4.0}
                if bias else None)
        return rids

    t0 = time.perf_counter()
    probe = batching.ContinuousBatcher(params, rcfg, decode_graph=False,
                                       **kw)
    rid = probe.submit(prompts[0], 1)
    ban = probe.run()[rid][0]
    del probe
    cb = batching.ContinuousBatcher(params, rcfg, **kw)
    if cb.graph is None:
        fail(f"graph {run}: the batcher captured no decode graph")
    rids = serve(cb, range(len(GRAPH_REQUESTS)))
    while cb.pending or cb.prefilling or len(cb.running) < 3:
        cb.step()
    for _ in range(4):
        cb.step()
    # the check drives the graph itself: nothing may be in flight
    inflight, cb._inflight = cb._inflight, None
    n_read = cb._read_step(inflight)
    checked = []
    for _ in range(GRAPH_STEPS):
        cb._refresh_slot_inputs()
        twin = dataclasses.replace(
            cb.state, cache=dataclasses.replace(cb.state.cache))
        for name, x in _state_tensors(cb.state).items():
            obj, attr = (twin.cache, name[6:]) if name.startswith("cache.") \
                else (twin, name)
            setattr(obj, attr, x.clone())
        gen = torch.Generator(device="cuda")
        gen.set_state(cb.generator.get_state())
        before = cb.generator.get_state()
        e_tok, e_logp = batching.decode_step(
            cb.params, twin, cb._allowed, cb._eos, cb.cfg, cb._knobs, gen,
            bias=cb._bias, seeds=twin.seeds)
        g_tok, g_logp = (x.clone() for x in cb.graph.replay())
        torch.cuda.synchronize()
        moved = not torch.equal(before, cb.generator.get_state())
        same = {"tokens": bool(torch.equal(e_tok, g_tok)),
                "logprobs": bool(torch.equal(e_logp, g_logp))}
        for name, x in _state_tensors(cb.state).items():
            y = getattr(twin.cache, name[6:]) if name.startswith("cache.") \
                else getattr(twin, name)
            if name.startswith("cache.") and kw["kv_layout"] == "paged":
                # the inactive slots' writes all land in the trap page
                # 0, which row of them stays is not defined, and nothing
                # reads it unmasked: the pool's other pages must agree
                x, y = x[:, 1:], y[:, 1:]
            same[name] = bool(torch.equal(x, y))
        bad = [k for k, v in same.items() if not v]
        if bad or not moved:
            fail(f"graph {run}: a replay differs from the eager step in "
                 f"{bad} (generator moved: {moved})")
        checked.append(g_tok.tolist())
        n_read += cb._apply_emitted(g_tok.tolist(), g_logp.tolist())
        del twin
    done = cb.run()
    seeded = done[rids[1]]
    alone_cb = batching.ContinuousBatcher(params, rcfg, **kw)
    alone_rids = serve(alone_cb, [1])
    alone = alone_cb.run()[alone_rids[1]]
    if alone != seeded:
        fail(f"graph {run}: the seeded stream alone differs from the same "
             "stream among its neighbours")
    if done[rids[0]][0] == ban:
        fail(f"graph {run}: the banned token {ban} came out first")
    out = {"phase": 4, "graph_check": run, "flags": flags,
           "steps_checked": GRAPH_STEPS, "tokens_checked": checked,
           "equal_bitwise": True, "state_tensors": len(same),
           "seeded_alone_equals_batched": True,
           "pool_bytes": cb.graph.pool_bytes,
           "launches_per_replay": cb.graph.launches,
           "s": time.perf_counter() - t0}
    emit(out)
    del cb, alone_cb
    gc.collect()
    torch.cuda.empty_cache()
    return out


# --- phase 5 -----------------------------------------------------------------


def flash_cases():
    """The training path's shapes (phase 6: B, S and the 8B heads), a
    window and an hd-64 group-1 case at the same B and S."""
    full = dict(b=TRAIN_BATCH, s=TRAIN_SEQ, hq=32, hkv=8, hd=128)
    return [dict(name="causal", window=0, **full),
            dict(name="causal_window512", window=512, **full),
            dict(name="causal_hd64_group1", window=0, b=TRAIN_BATCH,
                 s=TRAIN_SEQ, hq=8, hkv=8, hd=64)]


def attended_pairs(s: int, window: int) -> int:
    """(query, key) pairs one causal head attends: sum of min(i+1, window)."""
    if window <= 0 or window >= s:
        return s * (s + 1) // 2
    return window * (window + 1) // 2 + (s - window) * window


def flash_bounds(case, dtype_name: str) -> dict:
    """Least time of each kernel for this case's work: every input byte
    read once and every output byte written once, against 4 (forward),
    8 (dK dV) and 6 (dQ) * hd operations per attended (query, key) pair
    of every q head, at the input type's peak."""
    elem = 2 if dtype_name == "bfloat16" else 4
    b, s, hq, hkv, hd = (case[k] for k in ("b", "s", "hq", "hkv", "hd"))
    q_bytes = b * hq * s * hd * elem
    kv_bytes = 2 * b * hkv * s * hd * elem
    row_bytes = b * hq * s * 4                      # one lse or delta
    pairs = b * hq * attended_pairs(s, case["window"])
    work = {
        "flash_fwd": (2 * q_bytes + kv_bytes + row_bytes, 4 * hd * pairs),
        "flash_bwd_dkv": (2 * q_bytes + kv_bytes + 2 * row_bytes
                          + 2 * b * hkv * s * hd * 4, 8 * hd * pairs),
        "flash_bwd_dq": (2 * q_bytes + kv_bytes + 2 * row_bytes
                         + b * hq * s * hd * 4, 6 * hd * pairs),
    }
    out = {}
    for name, (nbytes, flops) in work.items():
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
        out[name] = {"bound_ms": max(t_bytes, t_ops),
                     "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                     "bytes": nbytes, "flops": flops}
    return out


def event_ms(torch, fn, reps: int = 5) -> float:
    """Mean device time of ``fn()`` between CUDA events, without a graph
    (for autograd calls)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def phase_flash(torch, fa, kernel_support) -> list[dict]:
    import torch.nn.functional as F

    results = []
    for case in flash_cases():
        for dtype in (torch.bfloat16, torch.float32):
            dname = str(dtype).split(".")[-1]
            b, s, hq, hkv, hd, window = (case[k] for k in
                                         ("b", "s", "hq", "hkv", "hd",
                                          "window"))
            gen = torch.Generator(device="cuda")
            gen.manual_seed(SEED)

            def randn(rows):
                return torch.randn((rows, s, hd), generator=gen,
                                   device="cuda", dtype=dtype)

            q, k, v, do = randn(b * hq), randn(b * hkv), randn(b * hkv), \
                randn(b * hq)
            kw = dict(scale=hd ** -0.5, causal=True, window=window)
            engine = fa.engine(dtype)
            label = f"{case['name']} {dname}"
            o_r, lse_r = fa.flash_fwd_reference(q, k, v, **kw)
            # both backward routes get the plain forward's lse and delta
            delta = (do.float() * o_r.float()).sum(-1, keepdim=True)
            bwd = (q, k, v, do, lse_r, delta)
            runs = []
            for _ in range(2):  # two launches of each on the same inputs
                kernel_support.reset_launch_counts()
                out = {}
                out["o"], out["lse"] = fa.flash_fwd(q, k, v, **kw)
                out["dk"], out["dv"] = fa.flash_bwd_dkv(*bwd, **kw)
                out["dq"] = fa.flash_bwd_dq(*bwd, **kw)
                runs.append((out, kernel_support.launch_counts()))
            (got, counts), (again, _) = runs
            torch.cuda.synchronize()
            for name in ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq"):
                if counts.get(kernel_support.engine_key(name, engine)) != 1:
                    fail(f"{label}: {name} was not counted on the {engine} "
                         f"engine: {counts}")
            for name in got:
                if not torch.equal(got[name], again[name]):
                    fail(f"{label}: two launches on the same inputs give "
                         f"different {name}")
            del runs, again
            want = {"o": o_r, "lse": lse_r,
                    "dq": fa.flash_bwd_dq_reference(*bwd, **kw)}
            want["dk"], want["dv"] = fa.flash_bwd_dkv_reference(*bwd, **kw)
            bf16 = dtype == torch.bfloat16
            errs, off_one_ulp, grad_checks = {}, None, {}
            if bf16:  # the tensor-core checks (the tolerances above)
                o_p = fa.flash_fwd_reference(q, k, v, p_bf16=True, **kw)[0]
                why = kernel_support.bf16_o_mismatch(got["o"], o_p, o_r,
                                                     fa.o_wide_tol(v))
                if why is not None:
                    fail(f"{label}: {why}")
                errs["o_vs_f32"] = float((got["o"].float()
                                          - o_r.float()).abs().max())
                off_one_ulp = kernel_support.off_one_ulp(got["o"], o_p)
                want["o"] = o_p
                rounded = {"dq": fa.flash_bwd_dq_reference(*bwd, p_bf16=True,
                                                           **kw)}
                rounded["dk"], rounded["dv"] = fa.flash_bwd_dkv_reference(
                    *bwd, p_bf16=True, **kw)
                magnitude = fa.flash_bwd_magnitudes(*bwd, **kw)
                for name, g_p in rounded.items():
                    g, g_r, mag = got[name], want[name], magnitude[name]
                    why = kernel_support.bf16_grad_mismatch(g, g_p, g_r, mag)
                    if why is not None:
                        fail(f"{label}: {name}: {why}")
                    errs[f"{name}_vs_f32"] = float((g - g_r).abs().max())
                    grad_checks[name] = {
                        "tight_ratio": float(((g - g_p).abs() / kernel_support
                                              .grad_tight_tol(mag)).max()),
                        "wide_ratio": float(((g - g_r).abs() / kernel_support
                                             .grad_wide_tol(mag)).max()),
                        "off_tight_elements_rows":
                            kernel_support.off_grad_tight(g, g_p, mag)}
                    want[name] = g_p
                del o_p, rounded, magnitude
            for name in ("o", "lse", "dq", "dk", "dv"):
                if not torch.isfinite(got[name]).all():
                    fail(f"{label}: non-finite kernel {name}")
                errs[name] = float((got[name].float()
                                    - want[name].float()).abs().max())
                if bf16 and name != "lse":
                    continue  # held by the tensor-core checks above
                tol = TOL["float32"] if name == "o" else GRAD_TOL
                if not torch.allclose(got[name].float(), want[name].float(),
                                      **tol):
                    fail(f"{label}: kernel {name} disagrees with its plain "
                         f"version (max abs err {errs[name]:.3e}, {tol})")
            del got, want

            # the library yardstick (never called by the port): SDPA over
            # (B, H, S, hd) views of the same inputs
            qs, ks, vs, dos = (x.view(b, -1, s, hd) for x in (q, k, v, do))
            if window:
                pos = torch.arange(s, device="cuda")
                mask = (pos[:, None] >= pos[None, :]) & \
                    (pos[:, None] - pos[None, :] < window)
                sdpa_kw = dict(attn_mask=mask)
            else:
                sdpa_kw = dict(is_causal=True)
            sdpa_kw.update(scale=kw["scale"], enable_gqa=hq != hkv)

            def library():
                return F.scaled_dot_product_attention(qs, ks, vs, **sdpa_kw)

            qg, kg, vg = (x.detach().requires_grad_() for x in (qs, ks, vs))
            out = F.scaled_dot_product_attention(qg, kg, vg, **sdpa_kw)

            def library_bwd():
                return torch.autograd.grad(out, (qg, kg, vg), dos,
                                           retain_graph=True)

            def library_fwd_bwd():
                o_ = F.scaled_dot_product_attention(qg, kg, vg, **sdpa_kw)
                return torch.autograd.grad(o_, (qg, kg, vg), dos)

            row = {"case": case["name"], "dtype": dname, **case,
                   "engine": engine, "max_abs_err": errs,
                   "o_off_one_ulp_elements_rows": off_one_ulp,
                   "grad_checks": grad_checks,
                   "ms": {
                       "flash_fwd": graph_ms(torch, lambda: fa.flash_fwd(
                           q, k, v, **kw), 5),
                       "flash_bwd_dkv": graph_ms(torch, lambda: fa.flash_bwd_dkv(
                           *bwd, **kw), 5),
                       "flash_bwd_dq": graph_ms(torch, lambda: fa.flash_bwd_dq(
                           *bwd, **kw), 5)},
                   "plain_ms": {
                       "flash_fwd": graph_ms(torch, lambda: fa.flash_fwd_reference(
                           q, k, v, **kw), 1),
                       "flash_bwd_dkv": graph_ms(
                           torch, lambda: fa.flash_bwd_dkv_reference(*bwd, **kw), 1),
                       "flash_bwd_dq": graph_ms(
                           torch, lambda: fa.flash_bwd_dq_reference(*bwd, **kw), 1)},
                   "library_fwd_ms": graph_ms(torch, library, 5),
                   "library_bwd_ms": event_ms(torch, library_bwd),
                   "library_fwd_bwd_ms": event_ms(torch, library_fwd_bwd),
                   "bounds": flash_bounds(case, dname)}
            del out, qg, kg, vg
            emit({"phase": 5, **row})
            results.append(row)
    torch.cuda.empty_cache()
    return results


# --- phase 6 -----------------------------------------------------------------


def phase_training(torch, kernel_support, attention_mod, llama, train,
                   trainer_mod) -> dict:
    """The trainer at Llama-3-8B widths, depth cut to TRAIN_LAYERS, with
    the launch counts of exactly that run; then kernels vs plain
    attention on a 2-layer f32 copy, and the gradients of its bf16 copy
    against the f32 plain path's."""
    cfg = dataclasses.replace(llama.LlamaConfig.llama3_8b(),
                              n_layers=TRAIN_LAYERS)
    tcfg = trainer_mod.TrainerConfig(
        model=cfg, batch_size=TRAIN_BATCH, seq_len=TRAIN_SEQ,
        total_steps=TRAIN_STEPS, warmup_steps=2, log_every=1,
        device="cuda",
    )
    # the same run again from the same seed: its losses must repeat bit
    # for bit (no atomics, fixed summation orders in every kernel)
    repeat = trainer_mod.Trainer(tcfg).run()
    repeat_losses = [h["loss"] for h in repeat.metrics_history if "loss" in h]
    del repeat
    gc.collect()
    torch.cuda.empty_cache()
    trainer = trainer_mod.Trainer(tcfg)
    stamps = []

    def on_step(step, metrics):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    resident_gib = torch.cuda.memory_allocated() / 2**30
    kernel_support.reset_launch_counts()
    t0 = time.perf_counter()
    result = trainer.run(on_step=on_step)
    launches = kernel_support.launch_counts()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    hist = [h for h in result.metrics_history if "loss" in h]
    losses = [h["loss"] for h in hist]
    norms = [h["grad_norm"] for h in hist]
    step_s = [b_ - a_ for a_, b_ in zip([t0] + stamps[:-1], stamps)]
    steady_ms = 1e3 * sum(step_s[1:]) / max(len(step_s) - 1, 1)
    tokens_per_s = TRAIN_BATCH * TRAIN_SEQ / (steady_ms / 1e3)
    mfu = cfg.flops_per_token() * tokens_per_s / PEAK_FLOPS["bfloat16"]
    need = cfg.n_layers * TRAIN_STEPS
    # the random init's logits: unit-RMS hidden states times std-0.02
    # head weights have variance d * 0.02^2, and the expected cross-entropy
    # of iid normal logits is ln V + variance / 2 (plus the z-loss)
    logit_var = cfg.d_model * 0.02 ** 2
    expected_loss = math.log(cfg.vocab_size) + logit_var / 2
    out = {
        "phase": 6, "layers": cfg.n_layers, "batch": TRAIN_BATCH,
        "seq": TRAIN_SEQ, "steps": TRAIN_STEPS,
        "remat_policy": cfg.remat_policy, "losses": losses,
        "grad_norms": norms, "ln_vocab": math.log(cfg.vocab_size),
        "expected_step1_loss": expected_loss,
        "step_ms": [1e3 * x for x in step_s], "steady_step_ms": steady_ms,
        "tokens_per_s": tokens_per_s,
        "trainer_tokens_per_s": result.tokens_per_second,
        "flops_per_token": cfg.flops_per_token(), "mfu": mfu,
        "peak_memory_gib": peak_gib, "resident_before_gib": resident_gib,
        "launches": launches, "launches_needed": need,
        "losses_repeat_bitwise": losses == repeat_losses,
    }
    del trainer, result
    gc.collect()
    torch.cuda.empty_cache()

    # kernels vs plain attention, 2 layers in f32 at the run's B and S: the
    # first update has learning rate 0, so both steps see the same
    # parameters
    cfg32 = dataclasses.replace(cfg, n_layers=2, dtype=torch.float32)
    opt = train.make_optimizer()
    state = train.init_train_state(cfg32, opt, seed=SEED, device="cuda")
    batch = train.synthetic_batch(cfg32, TRAIN_BATCH, TRAIN_SEQ, seed=SEED,
                                  device="cuda")
    routes = []
    for plain in (False, True):
        kernel_support.reset_launch_counts()
        _, m = train.make_train_step(cfg32, opt, plain_attention=plain)(
            state, batch)
        routes.append((m, kernel_support.launch_counts()))
    (m_kernel, kernel_counts), (m_plain, plain_counts) = routes
    cmp = {k: (float(m_kernel[k]), float(m_plain[k]))
           for k in ("loss", "grad_norm")}
    out["f32_two_layer_kernel_vs_plain"] = cmp
    out["f32_two_layer_launches"] = {"kernel_path": kernel_counts,
                                     "plain_path": plain_counts}
    bf16_grads = bf16_gradient_distances(torch, kernel_support, train, cfg32,
                                         state["params"], batch)
    out["bf16_two_layer_gradients"] = bf16_grads
    del state, batch
    gc.collect()
    torch.cuda.empty_cache()
    emit(out)

    if not all(math.isfinite(x) for x in losses + norms):
        fail(f"non-finite loss or grad_norm: {losses} {norms}")
    if len(losses) != TRAIN_STEPS or not all(x > 0 for x in norms):
        fail(f"want {TRAIN_STEPS} logged steps with grad_norm > 0: {hist}")
    if abs(losses[0] - expected_loss) > 0.5:
        fail(f"step-1 loss {losses[0]:.4f} is not within 0.5 of "
             f"ln(vocab) + d * 0.02^2 / 2 = {expected_loss:.4f}")
    for name in ("flash_bwd_dkv", "flash_bwd_dq"):
        if launches.get(name, 0) != need:
            fail(f"{name} launched {launches.get(name, 0)} times; the run "
                 f"needs exactly {need} = {cfg.n_layers} layers x "
                 f"{TRAIN_STEPS} steps")
    for name in ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq"):
        tc = launches.get(kernel_support.engine_key(name, "tensor_cores"), 0)
        if tc != need or launches.get(name, 0) != need:
            fail(f"{name} launched {launches.get(name, 0)} times, {tc} on "
                 f"the tensor cores; the run needs exactly {need} bf16 "
                 "launches")
    if losses != repeat_losses:
        fail(f"the losses of two runs differ: {losses} vs {repeat_losses}")
    if launches.get(attention_mod.MHA_ROUTE, 0):
        fail(f"{launches[attention_mod.MHA_ROUTE]} attention calls took "
             "mha_reference on the card")
    if any(kernel_counts.get(kernel_support.engine_key(name, "cuda_cores"))
           != cfg32.n_layers
           for name in ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq")) or \
            not plain_counts.get(attention_mod.MHA_ROUTE, 0) or \
            any(name.startswith("flash_") for name in plain_counts):
        fail(f"f32 comparison took the wrong routes: {kernel_counts} "
             f"(kernels) and {plain_counts} (plain)")
    worse = {leaf: d for leaf, d in bf16_grads["per_leaf"].items()
             if d["kernel"] > BF16_FACTOR * d["plain"]}
    if worse or bf16_grads["launches"].get(kernel_support.engine_key(
            "flash_bwd_dq", "tensor_cores")) != cfg32.n_layers:
        fail(f"bf16 kernel path's gradients more than {BF16_FACTOR}x the "
             f"plain path's distance from the f32 plain path's: {worse}; "
             f"launches {bf16_grads['launches']}")
    (lk, lp), (gk, gp) = cmp["loss"], cmp["grad_norm"]
    if abs(lk - lp) > LOSS_RTOL * abs(lp) or \
            abs(gk - gp) > GRAD_NORM_RTOL * abs(gp):
        fail(f"f32 kernel path vs plain path: loss {lk} vs {lp}, "
             f"grad_norm {gk} vs {gp}")
    return out


def bf16_gradient_distances(torch, kernel_support, train, cfg32, params,
                            batch) -> dict:
    """The gradients of the f32 model's bf16 copy through the kernels (the
    tensor cores) and through the plain attention, each leaf's relative
    L2 distance from the f32 plain path's gradients: the bf16 check of
    the training path, in the manner of phase 3's (both bf16 paths round
    the weights and activations alike; the kernel path's attention rounds
    only p and dS, so it must lie no further than BF16_FACTOR times the
    plain path)."""
    cfg16 = dataclasses.replace(cfg32, dtype=torch.bfloat16)

    def as_bf16(tree):
        return {k: as_bf16(v) if isinstance(v, dict) else v.bfloat16()
                for k, v in tree.items()}

    def grads(cfg, tree, plain):
        leaves = train.param_leaves(tree)
        with torch.enable_grad():
            for leaf in leaves:
                leaf.requires_grad_(True)
            loss, _ = train.loss_fn(tree, batch, cfg, with_accuracy=False,
                                    plain_attention=plain)
            out = torch.autograd.grad(loss, leaves)
            for leaf in leaves:
                leaf.requires_grad_(False)
        return [g.float() for g in out]

    want = grads(cfg32, params, True)
    params16 = as_bf16(params)
    names = [".".join(path) for path in _leaf_paths(params)]
    per_leaf = {name: {} for name in names}
    for route, plain in (("kernel", False), ("plain", True)):
        kernel_support.reset_launch_counts()
        got = grads(cfg16, params16, plain)
        if not plain:
            launches = kernel_support.launch_counts()
        for name, w, g in zip(names, want, got):
            per_leaf[name][route] = float((g - w).norm() / w.norm())
        del got
    return {"per_leaf": per_leaf, "launches": launches}


def _leaf_paths(tree, prefix=()):
    """The key path of each leaf, in ``train.param_leaves``' order."""
    out = []
    for key, value in tree.items():
        if isinstance(value, dict):
            out.extend(_leaf_paths(value, (*prefix, str(key))))
        else:
            out.append((*prefix, str(key)))
    return out


# --- main --------------------------------------------------------------------


def kernel_entry(name, source, replaces, launches, errs, head, extra):
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": max(errs.values()), **errs, **head, **extra}


def main() -> None:
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("CUDA is not available: this script drives the port on a card")
    sys.path.insert(0, ROOT)
    try:
        from k8s_gpu_device_plugin_torch.models import batching
        from k8s_gpu_device_plugin_torch.models import generate
        from k8s_gpu_device_plugin_torch.models import llama
        from k8s_gpu_device_plugin_torch.models import quantized_serving
        from k8s_gpu_device_plugin_torch.models import sampling
        from k8s_gpu_device_plugin_torch.models import train
        from k8s_gpu_device_plugin_torch.models import trainer as trainer_mod
        from k8s_gpu_device_plugin_torch.ops import attention as attention_mod
        from k8s_gpu_device_plugin_torch.ops import flash_attention as fa
        from k8s_gpu_device_plugin_torch.ops import kernel_support
        from k8s_gpu_device_plugin_torch.ops import quant
        from k8s_gpu_device_plugin_torch.ops import ragged_paged_attention as rpa
        from k8s_gpu_device_plugin_torch.serving import server as server_mod
    except ImportError as e:
        fail(f"the port package is not next to this script: {e}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card = card_line()
    print(card, flush=True)
    emit({"phase": 1, "card": card, "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0],
          "device_count": torch.cuda.device_count()})
    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:  # one nvcc per source, together
        builds = {"ragged_paged_attention": pool.submit(rpa.load_kernel),
                  "flash_attention": pool.submit(fa.load_kernel)}
        libs = {name: b.result() for name, b in builds.items()}
    emit({"phase": 1, "build_s": time.perf_counter() - t0})
    phase_sass(kernel_support, libs)

    cases = phase_kernels(torch, rpa, quant, kernel_support)
    flash = phase_flash(torch, fa, kernel_support)
    cfg = llama.LlamaConfig.llama3_8b()
    # one set of random 8B weights for the model check and the servers
    params = server_mod.load_params(cfg, seed=SEED, device="cuda")
    model = phase_model(torch, generate, cfg, params)
    graphs = {run: phase_graph(torch, batching, sampling, cfg, params, run,
                               SERVING_RUNS[run])
              for run in ("dense", "int8_paged")}
    # the synchronous loop first: its tokens are the ones every
    # unquantized run must give, and the first server of the process pays
    # the engine thread's one-time costs, so that the pipelined chunked
    # and bucketed runs compare their TTFT warm
    serving = {"dense_depth0": phase_serving(
        torch, server_mod, kernel_support, rpa, cfg, params, "dense_depth0")}
    for run in ("dense", "dense_bucketed", "paged", "int8_paged",
                "int8_dense", "int4_dense", "int4_paged"):
        serving[run] = phase_serving(
            torch, server_mod, kernel_support, rpa, cfg, params, run,
            dense_tokens=serving["dense_depth0"]["tokens"]
            if run in ("paged", "dense") else None)
        gc.collect()  # the stopped server's cache and graph pool
        torch.cuda.empty_cache()
    # bucketed prefill rounds its bf16 prompt rows in other places than
    # 256-row chunks do: its greedy streams are compared, not required
    emit({"phase": 4, "run": "dense_bucketed",
          "streams_equal_to_chunked": [
              i for i in range(len(REQUESTS)) if i not in BUCKET_REFUSED
              and serving["dense_bucketed"]["tokens"][i]
              == serving["dense"]["tokens"][i]],
          "ttft_s_p50": {"chunked_256": serving["dense"]["ttft_s_p50"],
                         "bucketed": serving["dense_bucketed"]["ttft_s_p50"]}})
    # each weight width quantized once on the card, checked (phase 3) and
    # served (phase 4), and freed before the next
    for weight_quant, run in (("int8", "w8"), ("int4", "w4_int4_paged")):
        qparams = quantized_serving.quantize_weights(params, weight_quant)
        phase_weights(torch, generate, cfg, qparams, weight_quant, model)
        if run == "w4_int4_paged":
            graphs[run] = phase_graph(torch, batching, sampling, cfg, qparams,
                                      run, SERVING_RUNS[run])
        serving[run] = phase_serving(torch, server_mod, kernel_support, rpa,
                                     cfg, qparams, run)
        del qparams
        gc.collect()
        torch.cuda.empty_cache()
    del params, model
    gc.collect()
    torch.cuda.empty_cache()
    training = phase_training(torch, kernel_support, attention_mod, llama,
                              train, trainer_mod)

    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    head = next(c for c in cases
                if c["case"] == "decode" and c["dtype"] == "bfloat16")
    err_bf16 = max(c["max_abs_err"] for c in cases if c["dtype"] == "bfloat16")
    err_f32 = max(c["max_abs_err"] for c in cases if c["dtype"] == "float32")
    routes = {}
    for route in rpa.ROUTES:  # each route's bf16 decode case heads its entry
        mine = [c for c in cases if c["route"] == route]
        first = next(c for c in mine if c["t"] == 1 and c["window"] == 0
                     and c["dtype"] == "bfloat16" and c["hd"] == 128)
        chunk = next(c for c in mine
                     if chunk_headline(c) and c["dtype"] == "bfloat16")
        routes[route] = {
            "launches": serving[route]["launches"],
            "launches_per_engine": serving[route]["launches_per_engine"],
            # bf16 queries on the tensor cores (decode split over each
            # span), f32 queries on the CUDA cores at every T
            "engine": {"decode": first["engine"], "chunk": chunk["engine"],
                       "float32": "cuda_cores"},
            "decode_cuda_cores_ms": first["cuda_cores_ms"],
            "split_tiles": first["split_tiles"],
            "splits_per_slot": first["splits_per_slot"],
            "blocks_per_sm": first["blocks_per_sm"],
            "chunk_case": chunk["case"],
            **{f"chunk_{k}": chunk[k] for k in keys},
            "chunk_cuda_cores_ms": chunk["cuda_cores_ms"],
            "max_err_bf16": max(c["max_abs_err"] for c in mine
                                if c["dtype"] == "bfloat16"),
            "max_err_bf16_vs_p_bf16": max(
                c["max_abs_err_vs_p_bf16"] for c in mine
                if c["engine"] == "tensor_cores"),
            "max_err_f32": max(c["max_abs_err"] for c in mine
                               if c["dtype"] == "float32"),
            "headline_case": first["case"], **{k: first[k] for k in keys},
            "decode_step_ms_mean": serving[route]["decode_step_ms_mean"],
            "reserved_bytes": serving[route]["kv"]["reserved_bytes"],
            # whole bucketed prompts (--chunkedPrefill 0) at base 0
            "bucket_cases": {
                c["t"]: {k: c[k] for k in keys} for c in mine
                if c["dtype"] == "bfloat16" and c["bases"] == [0]
                and c["t"] in (512, 1024)},
        }
    kernels = [kernel_entry(
        "ragged_paged_attention",
        "k8s_gpu_device_plugin_torch/ops/csrc/ragged_paged_attention.cu",
        "k8s_gpu_device_plugin_tpu/ops/ragged_paged_attention.py:142",
        sum(r["launches"] for r in routes.values()),
        {"max_err_bf16": err_bf16, "max_err_f32": err_f32},
        {k: head[k] for k in keys},
        {"headline_case": "decode bfloat16, B=8 S=2048 Hq=32 Hkv=8 hd=128, "
                          "dense route",
         "routes": routes,
         # the decode step replayed as a CUDA graph, held to the eager step
         "decode_graph": {run: {k: g[k] for k in
                                ("equal_bitwise", "steps_checked",
                                 "pool_bytes")}
                          for run, g in graphs.items()},
         "decode_graph_pool_bytes_serving": {
             run: r["decode_graph"]["pool_bytes"]
             for run, r in serving.items()},
         "cases": [{k: c[k] for k in ("case", "route", "page_size", "dtype",
                                      "engine", "max_abs_err", *keys)}
                   for c in cases]})]
    fhead = next(c for c in flash
                 if c["case"] == "causal" and c["dtype"] == "bfloat16")
    outputs = {"flash_fwd": ("o", "lse"), "flash_bwd_dkv": ("dk", "dv"),
               "flash_bwd_dq": ("dq",)}
    replaces = {"flash_fwd": 164, "flash_bwd_dkv": 412, "flash_bwd_dq": 465}
    for name, outs in outputs.items():
        errs = {f"max_err_{dn}": max(c["max_abs_err"][o] for c in flash
                                     for o in outs if c["dtype"] == dn)
                for dn in ("bfloat16", "float32")}
        kernels.append(kernel_entry(
            name, "k8s_gpu_device_plugin_torch/ops/csrc/flash_attention.cu",
            f"k8s_gpu_device_plugin_tpu/ops/flash_attention.py:{replaces[name]}",
            training["launches"].get(name, 0), errs,
            {"ms": fhead["ms"][name], "plain_ms": fhead["plain_ms"][name],
             "bound_ms": fhead["bounds"][name]["bound_ms"],
             "bound_by": fhead["bounds"][name]["bound_by"],
             # SDPA's forward for K2; its backward (dq, dk, dv in one
             # call) for K3 and K4
             "library_ms": fhead["library_fwd_ms"] if name == "flash_fwd"
             else fhead["library_bwd_ms"]},
            {"headline_case": f"causal bfloat16, B={TRAIN_BATCH} "
                              f"S={TRAIN_SEQ} Hq=32 Hkv=8 hd=128",
             "engine": {"bfloat16": "tensor_cores", "float32": "cuda_cores"},
             "launches_per_engine": {
                 e: training["launches"].get(kernel_support.engine_key(name, e), 0)
                 for e in kernel_support.ENGINES},
             "max_err_bf16_vs_f32_plain": max(
                 c["max_abs_err"][f"{o}_vs_f32"] for c in flash for o in outs
                 if c["dtype"] == "bfloat16" and o != "lse"),
             "cases": [{"case": c["case"], "dtype": c["dtype"],
                        "ms": c["ms"][name], "plain_ms": c["plain_ms"][name],
                        **c["bounds"][name]} for c in flash]}))
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
