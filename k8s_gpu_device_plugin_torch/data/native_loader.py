"""ctypes binding to the native data loader (``native/dataload.cc``).

Port of ``k8s_gpu_device_plugin_tpu/data/native_loader.py``.
``NativeMemmapSource`` is a drop-in for ``pipeline.MemmapSource``: the
deterministic window sampling (numpy's generator keyed by (seed, step))
stays in Python, one recipe, so the two sources give the same batches bit
for bit, while the gather itself (page faults and the uint16/uint32 ->
int32 widening of B windows) runs in the C++ worker pool.

The library is built at first use from the port's own source with
``$CXX`` (default ``g++``): ``-O2 -fPIC -std=c++17 -shared -lpthread``,
as the reference's ``native/Makefile`` builds it, into ``native/build/``
(git-ignored) under a name that carries a hash of the source, the
compiler and the flags, written to a temporary name and renamed into
place. A compiler that fails raises with its output; only a machine with
no C++ compiler has no native gather (:func:`native_available` is then
False and the factory takes the Python source, labelled as such).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shlex
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

NATIVE_DIR = Path(__file__).resolve().parent.parent / "native"
SOURCE = NATIVE_DIR / "dataload.cc"
BUILD_DIR = NATIVE_DIR / "build"
CXX_FLAGS = ("-O2", "-Wall", "-Wextra", "-fPIC", "-std=c++17", "-shared")
LINK_FLAGS = ("-lpthread",)

_DTYPE_CODES = {"uint16": 2, "uint32": 4}
_lib: "ctypes.CDLL | None" = None
_lib_lock = threading.Lock()


def find_cxx() -> "list[str] | None":
    """The C++ compiler command: ``$CXX`` (split as a shell word list)
    or ``g++``, when its executable is on the PATH; None otherwise."""
    cmd = shlex.split(os.environ.get("CXX") or "g++")
    if not cmd or shutil.which(cmd[0]) is None:
        return None
    return cmd


def library_path(cxx: "list[str]") -> Path:
    """Where the build of the current source with ``cxx`` lands."""
    h = hashlib.sha256()
    for part in (*cxx, *CXX_FLAGS, *LINK_FLAGS):
        h.update(part.encode() + b"\0")
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libdataload_{h.hexdigest()[:16]}.so"


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.dataload_open.restype = ctypes.c_void_p
    lib.dataload_open.argtypes = [ctypes.c_char_p, ctypes.c_int]
    lib.dataload_len.restype = ctypes.c_int64
    lib.dataload_len.argtypes = [ctypes.c_void_p]
    lib.dataload_gather.restype = ctypes.c_int32
    lib.dataload_gather.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int32,
        ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int32,
    ]
    lib.dataload_close.restype = None
    lib.dataload_close.argtypes = [ctypes.c_void_p]
    return lib


def load_library() -> ctypes.CDLL:
    """Build (once per source, compiler and flags) and load the gather;
    cached per process. Raises RuntimeError without a C++ compiler, or
    with the compiler's output when the build fails."""
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        cxx = find_cxx()
        if cxx is None:
            raise RuntimeError(
                "no C++ compiler ($CXX or g++ on the PATH): the native "
                "gather is built from native/dataload.cc at first use")
        out = library_path(cxx)
        if not out.exists():
            out.parent.mkdir(parents=True, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
            os.close(fd)
            try:
                proc = subprocess.run(
                    [*cxx, *CXX_FLAGS, "-o", tmp, str(SOURCE), *LINK_FLAGS],
                    capture_output=True, text=True, timeout=300)
                if proc.returncode != 0:
                    raise RuntimeError(
                        f"{cxx[0]} failed building the native gather (exit "
                        f"{proc.returncode}):\n{proc.stderr[-4000:]}")
                os.replace(tmp, out)
            finally:
                if os.path.exists(tmp):
                    os.unlink(tmp)
        _lib = _bind(ctypes.CDLL(str(out)))
        return _lib


def native_available() -> bool:
    """True when the gather can be loaded: a C++ compiler is present (a
    build that then fails raises, it does not answer False). The factory
    (``pipeline.make_token_source``) takes the native gather on this."""
    return _lib is not None or find_cxx() is not None


class NativeMemmapSource:
    """``pipeline.TokenSource`` over the C++ gather (see the module
    docstring)."""

    def __init__(self, path: str, dtype: str = "uint16", seed: int = 0,
                 threads: int = 0) -> None:
        if dtype not in _DTYPE_CODES:
            raise ValueError(f"unsupported dtype {dtype!r} (uint16/uint32)")
        self._lib = load_library()
        self._handle = self._lib.dataload_open(
            str(path).encode(), _DTYPE_CODES[dtype])
        if not self._handle:
            raise FileNotFoundError(f"cannot open token file {path}")
        self.n_tokens = int(self._lib.dataload_len(self._handle))
        if self.n_tokens < 2:
            self.close()
            raise ValueError(f"token file {path} too small ({self.n_tokens})")
        self.seed = seed
        self.threads = threads

    def windows(self, step, rows, batch_rows, seq_len):
        n = self.n_tokens - (seq_len + 1)
        if n < 1:
            raise ValueError(
                f"corpus of {self.n_tokens} tokens shorter than seq "
                f"{seq_len}+1")
        # the same sampling recipe as pipeline.MemmapSource: the same
        # batches, so swapping sources never changes a training run
        rng = np.random.default_rng((self.seed, step))
        starts = np.ascontiguousarray(
            rng.integers(0, n + 1, size=batch_rows)[rows], dtype=np.int64)
        out = np.empty((len(starts), seq_len + 1), dtype=np.int32)
        got = self._lib.dataload_gather(
            self._handle,
            starts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            len(starts),
            seq_len + 1,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            self.threads,
        )
        if got != len(starts):
            raise RuntimeError(
                f"native gather failed ({got}/{len(starts)} rows)")
        return out

    def close(self) -> None:
        if getattr(self, "_handle", None):
            self._lib.dataload_close(self._handle)
            self._handle = None

    def __del__(self):  # best effort; close() is the API
        try:
            self.close()
        except Exception:  # noqa: BLE001 - interpreter teardown
            pass
