"""Shared kernel scaffolding: shape gates, the nvcc build, launch counts.

Port of ``k8s_gpu_device_plugin_tpu/ops/kernel_support.py``. The shape
gates keep their names (``lane_aligned``, ``gqa_ok``); the TPU build gate
becomes a real build: every CUDA source under ``ops/csrc`` is compiled
with ``nvcc`` for ``sm_90a`` into a shared library with a plain C
interface and loaded with ``ctypes``. Builds happen at first use, from
the sources in the checkout only, into ``ops/build/``; the library name
carries a hash of the sources and flags, so an unchanged tree builds
once and an edited source can never load a stale library.

Each kernel wrapper counts its launches here (``count_launch``), so a
run can show that its main path went through the kernels.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

#: head dims the kernels take
LANE_ALIGNED_HEAD_DIMS = (64, 128)

OPS_DIR = Path(__file__).resolve().parent
CSRC_DIR = OPS_DIR / "csrc"
BUILD_DIR = OPS_DIR / "build"

#: Hopper with the arch-specific features (wgmma, setmaxnreg) enabled
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_libs: dict[str, ctypes.CDLL] = {}
_build_locks: dict[str, threading.Lock] = {}  # one per library: builds run in parallel
_locks_lock = threading.Lock()
_launches: dict[str, int] = {}
_launch_lock = threading.Lock()  # the engine thread counts, others read


def lane_aligned(head_dim: int) -> bool:
    return head_dim in LANE_ALIGNED_HEAD_DIMS


def gqa_ok(n_q_heads: int, n_kv_heads: int) -> bool:
    """q heads fold onto kv heads in whole groups (no K/V expansion)."""
    return n_kv_heads > 0 and n_q_heads % n_kv_heads == 0


def find_nvcc() -> str:
    """``$CUDA_HOME/bin/nvcc`` (default /usr/local/cuda), else PATH."""
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin and PATH): the "
            "CUDA kernels are built from source at first use"
        )
    return found


def build_key(sources) -> str:
    """Hash of every source's bytes and the nvcc flags: the build identity."""
    h = hashlib.sha256()
    for flag in NVCC_FLAGS:
        h.update(flag.encode() + b"\0")
    for src in sources:
        h.update(Path(src).name.encode() + b"\0")
        h.update(Path(src).read_bytes())
    return h.hexdigest()[:16]


def build_command(nvcc: str, sources, out_path) -> list[str]:
    return [nvcc, *NVCC_FLAGS, "-o", str(out_path), *[str(s) for s in sources]]


def load_library(name: str, sources, build_dir=BUILD_DIR) -> ctypes.CDLL:
    """Build (if its hash is new) and load the shared library ``name``
    from ``sources``; cached per process. The build writes to a
    temporary name and renames it into place, so a concurrent or
    interrupted build never leaves a half-written library behind."""
    sources = [Path(s) for s in sources]
    key = build_key(sources)
    out = Path(build_dir) / f"lib{name}_{key}.so"
    with _locks_lock:
        lock = _build_locks.setdefault(str(out), threading.Lock())
    with lock:
        lib = _libs.get(str(out))
        if lib is not None:
            return lib
        if not out.exists():
            out.parent.mkdir(parents=True, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
            os.close(fd)
            try:
                cmd = build_command(find_nvcc(), sources, tmp)
                proc = subprocess.run(cmd, capture_output=True, text=True,
                                      timeout=900)
                if proc.returncode != 0:
                    raise RuntimeError(
                        f"nvcc failed building {name} (exit "
                        f"{proc.returncode}):\n{proc.stderr[-4000:]}"
                    )
                os.replace(tmp, out)
            finally:
                if os.path.exists(tmp):
                    os.unlink(tmp)
        lib = ctypes.CDLL(str(out))
        _libs[str(out)] = lib
        return lib


def count_launch(name: str) -> None:
    """A wrapper calls this once for each launch of its kernel."""
    with _launch_lock:
        _launches[name] = _launches.get(name, 0) + 1


def launch_counts() -> dict[str, int]:
    with _launch_lock:
        return dict(_launches)


def reset_launch_counts() -> None:
    with _launch_lock:
        _launches.clear()
