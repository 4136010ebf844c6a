#!/usr/bin/env python3
"""Where a decode step of the PyTorch/CUDA port spends its time, on a card.

Builds Llama-3-8B with random weights, fills all 8 slots of the port's
ContinuousBatcher with ~1000-token prompts (chunked prefill, 256), then
times decode steps on the host clock (each step ends in its readback)
and profiles a few of them with ``torch.profiler``. Prints one JSON
line: the card, ms per decode step, device and host time per step,
kernel launches per step, and the device kernels that take the most
time.

    python3 tools/torch_decode_profile.py [--steps 10] [--context 1000]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--steps", type=int, default=10)
    parser.add_argument("--profiled", type=int, default=3)
    parser.add_argument("--context", type=int, default=1000)
    args = parser.parse_args()

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from k8s_gpu_device_plugin_torch.models.batching import ContinuousBatcher
    from k8s_gpu_device_plugin_torch.models.llama import (
        LlamaConfig,
        init_params,
    )

    cfg = LlamaConfig.llama3_8b()
    params = init_params(cfg, seed=0, device="cuda")
    cb = ContinuousBatcher(params, cfg, n_slots=8, max_len=2048,
                           chunked_prefill=256)
    budget = args.steps + args.profiled + 8
    for i in range(cb.n_slots):
        cb.submit(list(range(1, args.context + i)), max_new=budget)
    while cb.prefilling or cb.pending:
        cb.step()
    for _ in range(3):  # warm-up
        cb.step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(args.steps):
        cb.step()
    step_ms = (time.perf_counter() - t0) / args.steps * 1e3

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(args.profiled):
            cb.step()
        torch.cuda.synchronize()
    n = args.profiled
    events = prof.key_averages()
    launches = sum(e.count for e in events
                   if e.key in ("cudaLaunchKernel", "cuLaunchKernelEx",
                                "cuLaunchKernel"))
    # device time is the kernels' own (as the profiler's table totals it)
    on_device = [e for e in events if e.device_type == DeviceType.CUDA
                 and not e.is_user_annotation]
    device_us = sum(e.self_device_time_total for e in on_device)
    host_us = sum(e.self_cpu_time_total for e in events)
    kernels = sorted(on_device, key=lambda e: -e.self_device_time_total)[:8]
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
    ).stdout.strip()
    print(json.dumps({
        "card": card,
        "slots": cb.n_slots,
        "context": args.context,
        "decode_step_ms": step_ms,
        "device_ms_per_step": device_us / n / 1e3,
        "host_ms_per_step_profiled": host_us / n / 1e3,
        "kernel_launches_per_step": launches / n,
        "top_device_kernels": [
            {"name": e.key[:80], "ms_per_step": e.self_device_time_total / n / 1e3,
             "calls_per_step": e.count / n}
            for e in kernels
        ],
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
