#!/usr/bin/env python3
"""Where a training step of the PyTorch/CUDA port spends its time, on a card.

Builds Llama-3-8B widths cut to ``--layers`` layers (random weights, bf16,
the default remat policy; ``--optImpl fused``, ``--fusedCE`` and ``--quant
int8`` as the trainer takes them), then on synthetic batches of ``--batch`` x
``--seq`` tokens: times whole train steps on the host clock (each ends in
a synchronize), times the gradient pass (forward + backward) and the
optimizer update apart, and profiles ``--profiled`` steps with
``torch.profiler``. Prints one JSON line: the card, ms per step and per
part, device time per step split into the flash kernels, the fused
training ops' kernels (K5, K6, K7), the GEMMs (the int8 ones among them)
and everything else, the device's idle share, kernel launches per step
and the kernels that take the most time.

The idle share comes from the profiled steps alone: one minus the time
some device activity ran (the union of their intervals) over the wall
span of the profiled window, both read off the trace's one clock. The
profiler's host overhead can only lengthen that window, so the share is
an upper bound for unprofiled steps; ``profiled_wall_ms_per_step``
beside ``step_ms`` shows by how much.

    python3 tools/torch_train_profile.py [--layers 8] [--batch 2] [--seq 2048]
        [--optImpl fused] [--fusedCE] [--quant int8]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import re
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

GEMM = re.compile(r"gemm|xmma|nvjet|cutlass|cublas", re.IGNORECASE)
# every flash kernel symbol: each engine of K2, K3 and K4
FLASH = re.compile(r"\bflash_\w+_kernel")
# the fused training ops' kernels: K5's three, K6 and K7
FUSED = re.compile(r"\badamw_\w+|\bce_chunk_\w+_kernel")


def union_us(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for lo, hi in sorted(intervals):
        if hi > end:
            total += hi - max(lo, end)
            end = hi
    return total


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--layers", type=int, default=8)
    parser.add_argument("--batch", type=int, default=2)
    parser.add_argument("--seq", type=int, default=2048)
    parser.add_argument("--steps", type=int, default=4)
    parser.add_argument("--profiled", type=int, default=2)
    parser.add_argument("--optImpl", default="optax",
                        choices=["optax", "fused"])
    parser.add_argument("--fusedCE", action="store_true")
    parser.add_argument("--quant", default="none", choices=["none", "int8"])
    args = parser.parse_args()

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from k8s_gpu_device_plugin_torch.models import train
    from k8s_gpu_device_plugin_torch.models.llama import LlamaConfig

    cfg = dataclasses.replace(LlamaConfig.llama3_8b(), n_layers=args.layers,
                              fused_ce=args.fusedCE, quant=args.quant)
    opt = train.make_optimizer(warmup_steps=2, impl=args.optImpl)
    state = train.init_train_state(cfg, opt, seed=0, device="cuda")
    # the trainer's rule: a fused cross-entropy reports no accuracy
    kw = dict(with_accuracy=not cfg.fused_ce)
    step = train.make_train_step(cfg, opt, **kw)
    batches = [train.synthetic_batch(cfg, args.batch, args.seq, seed=i,
                                     device="cuda") for i in range(4)]

    def timed(fn, n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(n):
            fn(i)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / n * 1e3

    timed(lambda i: step(state, batches[i % 4]), 2)  # warm-up
    step_ms = timed(lambda i: step(state, batches[i % 4]), args.steps)
    grads = []
    grads_ms = timed(lambda i: grads.append(
        train._grads(state["params"], batches[i % 4], cfg, **kw)[0]), 1)
    leaves = train.param_leaves(state["params"])
    update_ms = timed(lambda i: opt.update(list(grads[0]), state["opt_state"],
                                           leaves), 1)
    del grads

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i in range(args.profiled):
            step(state, batches[i % 4])
        torch.cuda.synchronize()
    n = args.profiled
    trace = [e for e in prof.events() if e.time_range.end > e.time_range.start]
    window_us = (max(e.time_range.end for e in trace)
                 - min(e.time_range.start for e in trace))
    busy_us = union_us((e.time_range.start, e.time_range.end) for e in trace
                       if e.device_type == DeviceType.CUDA
                       and not e.is_user_annotation)
    events = prof.key_averages()
    launches = sum(e.count for e in events
                   if e.key in ("cudaLaunchKernel", "cuLaunchKernelEx",
                                "cuLaunchKernel"))
    on_device = [e for e in events if e.device_type == DeviceType.CUDA
                 and not e.is_user_annotation]
    split = {"flash_kernels": 0.0, "fused_ops": 0.0, "gemm": 0.0,
             "other": 0.0}
    for e in on_device:
        part = ("flash_kernels" if FLASH.search(e.key) else
                "fused_ops" if FUSED.search(e.key) else
                "gemm" if GEMM.search(e.key) else "other")
        split[part] += e.self_device_time_total / n / 1e3
    device_ms = sum(split.values())
    kernels = sorted(on_device, key=lambda e: -e.self_device_time_total)[:12]
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
    ).stdout.strip()
    tokens = args.batch * args.seq
    print(json.dumps({
        "card": card,
        "layers": args.layers, "batch": args.batch, "seq": args.seq,
        "opt_impl": args.optImpl, "fused_ce": args.fusedCE,
        "quant": args.quant,
        "step_ms": step_ms,
        "tokens_per_s": tokens / step_ms * 1e3,
        "mfu": cfg.flops_per_token() * tokens / (step_ms / 1e3) / 989e12,
        "grads_ms": grads_ms,
        "optimizer_update_ms": update_ms,
        "device_ms_per_step": device_ms,
        "device_ms_split": split,
        "profiled_wall_ms_per_step": window_us / n / 1e3,
        "device_busy_ms_per_step": busy_us / n / 1e3,
        "device_idle_share": 1 - busy_us / window_us,
        "kernel_launches_per_step": launches / n,
        "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30,
        "top_device_kernels": [
            {"name": e.key[:80],
             "ms_per_step": e.self_device_time_total / n / 1e3,
             "calls_per_step": e.count / n}
            for e in kernels
        ],
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
