#!/usr/bin/env python3
"""Where a decode step of the PyTorch/CUDA port spends its time, on a card.

Builds Llama-3-8B (or ``--preset mixtral_8x7b``) with random weights,
fills all 8 slots of the port's
ContinuousBatcher with ~1000-token prompts (chunked prefill, 256), then
times decode steps on the host clock (the batcher's default pipelined
loop: a step's wall time is one dispatch and one readback) and profiles
a few of them with ``torch.profiler``. Each configuration runs twice in
this one process, in the modes of ``--modes``: ``eager`` (every kernel
of the step launched from Python) and ``graph`` (the step captured once
as a CUDA graph and replayed, the batcher's default on a card); the
graph mode also times a run of back-to-back replays between CUDA events
(the step's device time with no host in the way). Then it profiles one
prefill chunk the way the batcher runs it: a 256-token chunk of one slot
at base 1536 of a fresh cache (the chunks before it written
unprofiled). Prints one JSON line per configuration: the card, and per
mode ms per decode step, device and host time per step, host launches
per step (kernel launches and graph launches apart), the attention
kernel's own device time, the device kernels that take the most time;
and the same for the prefill chunk (``prefill_chunk``).

``--weightQuant``, ``--kvLayout`` and ``--cacheQuant`` take
comma-separated lists; every combination is measured in turn in this one
process, from one set of bf16 weights (quantized once per
``--weightQuant`` value, the copy freed before the next), so a paged
int4 step can be read beside the dense bf16 one from one card.
``--activeSlots N`` fills only N of the 8 slots: the others are the
inactive slots every decode step still computes and discards.
``--preset mixtral_8x7b`` draws Mixtral-8x7B's weights once per
``--weightQuant`` value, its expert stacks quantized as they are drawn
(``serving/server.py::load_params``): its bf16 tree (93.4 GB) does not
fit one card, so it takes ``int8`` or ``int4`` only. Each line's
``device_ms_by_kind`` splits the kernels' device time by their names
into the attention kernel, matrix products (cuBLAS/CUTLASS GEMMs),
element-wise conversions and copies (the widening of weight codes among
them), and the rest.

    python3 tools/torch_decode_profile.py [--preset llama3_8b]
        [--steps 10] [--context 1000]
        [--kvLayout dense,paged] [--cacheQuant none,int8,int4]
        [--weightQuant none,int8,int4] [--activeSlots 8]
        [--modes eager,graph]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def summarize(prof, n: int) -> dict:
    """Device and host ms, launches and the attention kernels' share per
    profiled call, from a torch.profiler run of ``n`` calls."""
    from torch.autograd import DeviceType

    events = prof.key_averages()
    launches = sum(e.count for e in events
                   if e.key in ("cudaLaunchKernel", "cuLaunchKernelEx",
                                "cuLaunchKernel", "cudaLaunchKernelExC"))
    graph_launches = sum(e.count for e in events
                         if e.key in ("cudaGraphLaunch", "cuGraphLaunch"))
    # device time is the kernels' own (as the profiler's table totals it)
    on_device = [e for e in events if e.device_type == DeviceType.CUDA
                 and not e.is_user_annotation]
    device_us = sum(e.self_device_time_total for e in on_device)
    host_us = sum(e.self_cpu_time_total for e in events)
    kernels = sorted(on_device, key=lambda e: -e.self_device_time_total)[:8]
    by_kind: dict[str, float] = {}
    for e in on_device:
        kind = kernel_kind(e.key)
        by_kind[kind] = by_kind.get(kind, 0.0) + \
            e.self_device_time_total / n / 1e3
    # both engines of the ragged-paged kernel (rpa_kernel, rpa_tc_kernel)
    attention = [e for e in on_device if "rpa_" in e.key]
    return {
        "device_ms": device_us / n / 1e3,
        "host_ms_profiled": host_us / n / 1e3,
        "kernel_launches": launches / n,
        "graph_launches": graph_launches / n,
        "attention_kernel_ms":
            sum(e.self_device_time_total for e in attention) / n / 1e3,
        "attention_kernel_calls": sum(e.count for e in attention) / n,
        "device_ms_by_kind": by_kind,
        "top_device_kernels": [
            {"name": e.key[:80], "ms": e.self_device_time_total / n / 1e3,
             "calls": e.count / n}
            for e in kernels
        ],
    }


def kernel_kind(name: str) -> str:
    """A device kernel's kind, from its name: ``attention`` (K1's
    ``rpa_`` kernels), ``matmul`` (cuBLAS / CUTLASS GEMMs), ``convert``
    (element-wise kernels and copies, where a dtype cast such as the
    widening of int8 weight codes runs) or ``other``."""
    low = name.lower()
    if "rpa_" in low:
        return "attention"
    if any(w in low for w in ("gemm", "xmma", "nvjet", "cutlass", "sm90_")):
        return "matmul"
    if any(w in low for w in ("elementwise", "copy", "unrolled",
                              "vectorized")):
        return "convert"
    return "other"


def prefill_chunk(torch, params, cfg, layout: str, page_size: int) -> dict:
    """One bf16 prefill chunk of 256 tokens at base 1536 of one slot's
    fresh cache (dense, or a pool read through an identity table), as the
    batcher's chunked prefill runs it: the six chunks before it written
    unprofiled, the chunk itself run once to warm up and once profiled."""
    from torch.profiler import ProfilerActivity, profile

    from k8s_gpu_device_plugin_torch.models import generate

    pages = None
    if layout == "paged":
        n = 2048 // page_size
        cache = generate.KVCache.init_paged(cfg, n + 1, page_size, "cuda")
        pages = torch.arange(1, n + 1, dtype=torch.int32,
                             device="cuda")[None]
    else:
        cache = generate.KVCache.init(cfg, 1, 2048, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    tokens = torch.randint(1, cfg.vocab_size, (1, 1792), generator=gen,
                           device="cuda")
    for start in range(0, 1792, 256):
        generate._forward_cached(params, tokens[:, start:start + 256], cache,
                                 start, cfg, last_only=True, pages=pages)
    chunk = tokens[:, 1536:]
    generate._forward_cached(params, chunk, cache, 1536, cfg, last_only=True,
                             pages=pages)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        generate._forward_cached(params, chunk, cache, 1536, cfg,
                                 last_only=True, pages=pages)
        torch.cuda.synchronize()
    out = {"t": 256, "base": 1536, **summarize(prof, 1)}
    del cache
    torch.cuda.empty_cache()
    return out


def replay_ms(torch, cb, n: int) -> float:
    """Mean device time of ``n`` back-to-back replays of the batcher's
    captured step, between CUDA events. The replays' tokens are never
    read: run it last, on a batcher that is thrown away after."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(n):
        cb.graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def measure(torch, params, cfg, args, layout: str, quant: str,
            mode: str) -> dict:
    """One (weights, layout, cache) configuration's decode step, eager or
    replayed as a graph."""
    from dataclasses import replace

    from torch.profiler import ProfilerActivity, profile

    from k8s_gpu_device_plugin_torch.models.batching import ContinuousBatcher

    cb = ContinuousBatcher(
        params, replace(cfg, cache_quant=quant), n_slots=8, max_len=2048,
        chunked_prefill=256, kv_layout=layout,
        kv_page_size=args.kvPageSize if layout == "paged" else None,
        decode_graph=mode == "graph")
    # every step of the prefill phase also decodes the slots that are
    # already running: the budget covers those steps too, so that every
    # request is still decoding when the measured window ends
    prefill_steps = args.activeSlots * -(-(args.context + 8) // 256)
    budget = prefill_steps + args.steps + args.profiled + 8
    for i in range(args.activeSlots):
        cb.submit(list(range(1, args.context + i)), max_new=budget)
    while cb.prefilling or cb.pending:
        cb.step()
    for _ in range(3):  # warm-up
        cb.step()
    running_before = len(cb.running)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(args.steps):
        cb.step()
    # the pipelined loop leaves its last step in flight: the window ends
    # when that step does, so it holds the device time of every step in it
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / args.steps * 1e3

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(args.profiled):
            cb.step()
        torch.cuda.synchronize()
    if not running_before == len(cb.running) == args.activeSlots:
        raise RuntimeError(
            f"{len(cb.running)} slots were decoding at the end of the "
            f"window ({running_before} at its start), wanted "
            f"{args.activeSlots}: a request retired inside it")
    stats = summarize(prof, args.profiled)
    graph = None
    if cb.graph is not None:
        graph = {"pool_bytes": cb.graph.pool_bytes,
                 "replay_ms_events": replay_ms(torch, cb, args.steps)}
    return {
        "mode": mode, "pipeline_depth": cb.pipeline_depth,
        "weight_quant": cb.weight_stats["quant"],
        "weight_bytes": cb.weight_stats["resident_bytes"],
        "kv_layout": layout, "cache_quant": quant,
        "slots": cb.n_slots, "active_slots": args.activeSlots,
        "context": args.context,
        "kv": cb.kv_stats(),
        "decode_step_ms": step_ms,
        "device_ms_per_step": stats["device_ms"],
        "host_ms_per_step_profiled": stats["host_ms_profiled"],
        "kernel_launches_per_step": stats["kernel_launches"],
        "graph_launches_per_step": stats["graph_launches"],
        "graph": graph,
        "attention_kernel_ms_per_step": stats["attention_kernel_ms"],
        "attention_kernel_calls_per_step": stats["attention_kernel_calls"],
        "device_ms_by_kind_per_step": stats["device_ms_by_kind"],
        "top_device_kernels": [
            {"name": k["name"], "ms_per_step": k["ms"],
             "calls_per_step": k["calls"]}
            for k in stats["top_device_kernels"]
        ],
    }


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--preset", default="llama3_8b",
                        choices=["llama3_8b", "mixtral_8x7b"])
    parser.add_argument("--steps", type=int, default=10)
    parser.add_argument("--profiled", type=int, default=3)
    parser.add_argument("--context", type=int, default=1000)
    parser.add_argument("--kvLayout", default="dense",
                        help="comma-separated: dense, paged")
    parser.add_argument("--cacheQuant", default="none",
                        help="comma-separated: none, int8, int4")
    parser.add_argument("--weightQuant", default="none",
                        help="comma-separated: none, int8, int4")
    parser.add_argument("--kvPageSize", type=int, default=64)
    parser.add_argument("--activeSlots", type=int, default=8,
                        help="slots that hold a request (of 8)")
    parser.add_argument("--modes", default="eager,graph",
                        help="comma-separated: eager, graph")
    args = parser.parse_args()

    from dataclasses import replace

    import torch

    from k8s_gpu_device_plugin_torch.models.llama import (
        LlamaConfig,
        init_params,
    )
    from k8s_gpu_device_plugin_torch.models.quantized_serving import (
        quantize_weights,
    )
    from k8s_gpu_device_plugin_torch.serving.server import load_params

    cfg = getattr(LlamaConfig, args.preset)()
    if cfg.is_moe and "none" in args.weightQuant.split(","):
        parser.error(f"--preset {args.preset}: its bf16 weights do not fit "
                     "one card; pass --weightQuant int8 or int4")
    params = None if cfg.is_moe else init_params(cfg, seed=0, device="cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
    ).stdout.strip()
    for weight_quant in args.weightQuant.split(","):
        served = load_params(cfg, seed=0, device="cuda",
                             weight_quant=weight_quant) if cfg.is_moe \
            else quantize_weights(params, weight_quant)
        for layout in args.kvLayout.split(","):
            for quant in args.cacheQuant.split(","):
                row = {}
                for mode in args.modes.split(","):
                    row[mode] = measure(torch, served, cfg, args, layout,
                                        quant, mode)
                    torch.cuda.empty_cache()
                row["prefill_chunk"] = prefill_chunk(
                    torch, served,
                    replace(cfg, cache_quant=quant, kv_layout=layout,
                            kv_page_size=args.kvPageSize),
                    layout, args.kvPageSize)
                print(json.dumps({"card": card, "preset": args.preset,
                                  **row}), flush=True)
        del served
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
