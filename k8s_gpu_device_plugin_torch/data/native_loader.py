"""ctypes binding to the native data loader (``native/dataload.cc``).

Port of ``k8s_gpu_device_plugin_tpu/data/native_loader.py``.
``NativeMemmapSource`` is a drop-in for ``pipeline.MemmapSource``: the
deterministic window sampling (numpy's generator keyed by (seed, step))
stays in Python, one recipe, so the two sources give the same batches bit
for bit, while the gather itself (page faults and the uint16/uint32 ->
int32 widening of B windows) runs in the C++ worker pool.

The library is built at first use from the port's own source by
``utils/native_build.py`` (``$CXX`` or ``g++``, ``-lpthread`` added, into
the git-ignored ``native/build/``). A compiler that fails raises with its
output; only a machine with no C++ compiler has no native gather
(:func:`native_available` is then False and the factory takes the Python
source, labelled as such).
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np

from k8s_gpu_device_plugin_torch.utils import native_build

SOURCE = native_build.NATIVE_DIR / "dataload.cc"
BUILD_DIR = native_build.BUILD_DIR
LINK_FLAGS = ("-lpthread",)
find_cxx = native_build.find_cxx

_DTYPE_CODES = {"uint16": 2, "uint32": 4}
_lib: "ctypes.CDLL | None" = None
_lib_lock = threading.Lock()


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
        if _lib is None:
            _lib = _bind(ctypes.CDLL(str(native_build.build_library(
                "dataload", SOURCE, "the native gather", LINK_FLAGS,
                build_dir=BUILD_DIR))))
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
