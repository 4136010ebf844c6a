#!/usr/bin/env python3
"""Registers, spills and shared memory of every kernel the port builds.

Compiles each CUDA source under ``k8s_gpu_device_plugin_torch/ops/csrc``
with the port's own nvcc flags plus ``-Xptxas -v`` into a throwaway
library under ``ops/build/ptxas/`` (gitignored; the kernels' own builds
are not touched), all sources at once, and prints one JSON line per
kernel instantiation: the source, the mangled and the demangled name,
registers a thread, spill stores and loads (bytes), static shared memory
and stack frame (bytes), into ``--out`` (default
``chiprun_out/ptxas_report.jsonl``); on stdout only the kernels that spill
or that match ``--grep``, then each compile error and a summary line.
Exits 1 if a source does not compile. Needs ``nvcc`` (the machine with
the card):

    python3 tools/torch_ptxas_report.py [--source NAME ...] [--grep TEXT]
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

_FUNC = re.compile(r"Compiling entry function '(\S+)'")
_STACK = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                    r"(\d+) bytes spill loads")
_USED = re.compile(r"Used (\d+) registers(?:.*?(\d+) bytes smem)?")


def parse(text: str) -> list[dict]:
    """ptxas's ``-v`` lines -> one dict per entry function."""
    out, cur = [], None
    for line in text.splitlines():
        m = _FUNC.search(line)
        if m:
            cur = {"mangled": m.group(1)}
            out.append(cur)
            continue
        if cur is None:
            continue
        m = _STACK.search(line)
        if m:
            cur.update(stack_bytes=int(m.group(1)),
                       spill_store_bytes=int(m.group(2)),
                       spill_load_bytes=int(m.group(3)))
            continue
        m = _USED.search(line)
        if m:
            cur.update(registers=int(m.group(1)),
                       static_smem_bytes=int(m.group(2) or 0))
    return out


def demangle(names: list[str]) -> list[str]:
    tool = shutil.which("cu++filt") or shutil.which("c++filt")
    if tool is None or not names:
        return names
    proc = subprocess.run([tool], input="\n".join(names), text=True,
                          capture_output=True)
    got = proc.stdout.splitlines()
    return got if len(got) == len(names) else names


def report(kernel_support, source) -> list[dict]:
    out_dir = kernel_support.BUILD_DIR / "ptxas"
    out_dir.mkdir(parents=True, exist_ok=True)
    cmd = kernel_support.build_command(
        kernel_support.find_nvcc(), [source], out_dir / f"{source.stem}.so")
    cmd[1:1] = ["-Xptxas", "-v"]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
    if proc.returncode != 0:
        errors = sorted(set(re.findall(r"\((\d+)\): (error: [^\n]*)",
                                       proc.stderr)), key=lambda e: int(e[0]))
        raise RuntimeError(
            f"nvcc failed on {source.name}: "
            + "; ".join(f"line {n}: {m}" for n, m in errors)
            + f"\n{proc.stderr[-2000:]}")
    rows = parse(proc.stderr + proc.stdout)
    for row, name in zip(rows, demangle([r["mangled"] for r in rows])):
        row["source"] = source.name
        row["kernel"] = name
    return rows


def main() -> int:
    from k8s_gpu_device_plugin_torch.ops import kernel_support

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--source", action="append",
                    help="a source's file name (default: every .cu)")
    ap.add_argument("--grep", action="append", default=[],
                    help="also print kernels whose demangled name has this")
    ap.add_argument("--out", default=os.path.join(
        ROOT, "chiprun_out", "ptxas_report.jsonl"))
    args = ap.parse_args()
    sources = sorted(kernel_support.CSRC_DIR.glob("*.cu"))
    if args.source:
        sources = [s for s in sources if s.name in args.source]
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    errors, rows = [], []
    with ThreadPoolExecutor(len(sources)) as pool:
        jobs = {s.name: pool.submit(report, kernel_support, s) for s in sources}
        for name, job in jobs.items():
            try:
                rows.extend(job.result())
            except RuntimeError as e:
                errors.append({"source": name, "error": str(e)})
    with open(args.out, "w") as f:
        for row in rows:
            f.write(json.dumps(row) + "\n")
    for row in rows:
        if row.get("spill_store_bytes") or row.get("spill_load_bytes") or \
                any(g in row["kernel"] for g in args.grep):
            print(json.dumps(row), flush=True)
    for e in errors:
        print(json.dumps(e), flush=True)
    print(json.dumps({"kernels": len(rows), "spilling": sum(
        1 for r in rows if r.get("spill_store_bytes")), "errors": len(errors),
        "out": args.out}), flush=True)
    return 1 if errors else 0


if __name__ == "__main__":
    sys.exit(main())
