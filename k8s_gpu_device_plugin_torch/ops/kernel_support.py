"""Shared kernel scaffolding: shape gates, the nvcc build, launch counts.

Port of ``k8s_gpu_device_plugin_tpu/ops/kernel_support.py``. The shape
gates keep their names (``lane_aligned``, ``gqa_ok``); the TPU build gate
becomes a real build: every CUDA source under ``ops/csrc`` is compiled
with ``nvcc`` for ``sm_90a`` into a shared library with a plain C
interface and loaded with ``ctypes``. Builds happen at first use, from
the sources in the checkout only, into ``ops/build/``; the library name
carries a hash of the sources, of every header under ``ops/csrc``
(``*.cuh``, which any source may include) and of the flags, so an
unchanged tree builds once and an edited source or header can never load
a stale library.

Each kernel wrapper counts its launches here (``count_launch``), so a
run can show that its main path went through the kernels; a kernel with
two engines also counts each launch under its engine's key
(:func:`engine_key`): ``cuda_cores`` (f32 arithmetic on the CUDA cores)
or ``tensor_cores`` (bf16 products in ``wgmma``, ``csrc/attention_tile.cuh``).
A CUDA graph replays its kernels without reaching the wrappers, so its
capture records their counts (:func:`recording_launches`) and every
replay adds them (:func:`count_replay`).

The tensor-core mainloop rounds its softmax weights to bf16 before the V
product, so both kernels that run it are held to a plain version that
rounds them where it does (:func:`p_bf16_weights`) by one check,
:func:`bf16_o_mismatch`. The tensor-core backward rounds p and dS before
its gradient products; its gradients are held the same way by
:func:`bf16_grad_mismatch`.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import torch

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

#: the engines a kernel may run on
ENGINES = ("cuda_cores", "tensor_cores")

_libs: dict[str, ctypes.CDLL] = {}
_build_locks: dict[str, threading.Lock] = {}  # one per library: builds run in parallel
_locks_lock = threading.Lock()
_launches: dict[str, int] = {}
_launch_lock = threading.Lock()  # the engine thread counts, others read
# per thread: the recording of a CUDA graph capture in progress
_capture = threading.local()


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


def build_key(sources, header_dir=CSRC_DIR) -> str:
    """Hash of every source's bytes, every ``*.cuh`` header's bytes under
    ``header_dir`` and the nvcc flags: the build identity."""
    h = hashlib.sha256()
    for flag in NVCC_FLAGS:
        h.update(flag.encode() + b"\0")
    headers = sorted(Path(header_dir).glob("*.cuh"))
    for src in [*sources, *headers]:
        h.update(Path(src).name.encode() + b"\0")
        h.update(Path(src).read_bytes())
    return h.hexdigest()[:16]


def build_command(nvcc: str, sources, out_path,
                  header_dir=CSRC_DIR) -> list[str]:
    return [nvcc, *NVCC_FLAGS, f"-I{header_dir}", "-o", str(out_path),
            *[str(s) for s in sources]]


def load_library(name: str, sources, build_dir=BUILD_DIR,
                 header_dir=CSRC_DIR) -> ctypes.CDLL:
    """Build (if its hash is new) and load the shared library ``name``
    from ``sources``, with the headers of ``header_dir`` on the include
    path; cached per process. The build writes to a temporary name and
    renames it into place, so a concurrent or interrupted build never
    leaves a half-written library behind."""
    sources = [Path(s) for s in sources]
    key = build_key(sources, header_dir)
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
                cmd = build_command(find_nvcc(), sources, tmp, header_dir)
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


#: o's tolerance in bf16 against the ``p_bf16`` plain version: one ulp (at
#: most 2^-7 of the value) plus 1e-3
O_TOL_BF16 = dict(atol=1e-3, rtol=8e-3)

#: rows of o (one query vector's hd outputs) that may miss one ulp of the
#: ``p_bf16`` plain version: at least FLIP_ROWS, else this share of them.
#: A weight within the scores' summation-order error of a bf16 rounding
#: boundary can round the other way in the kernel and in the plain
#: version, moving every output of its row by 2^-8 of that weight's share
#: of |v|, beyond one ulp where a row has few weights. Such flips are
#: rare (on the card, one or two rows of a test with many few-key rows);
#: a rounding fault misses on hundreds to thousands of rows.
FLIP_ROWS = 4
FLIP_ROW_SHARE = 1e-3

#: kv rows per tile of the tensor-core mainloop (``attn_tile::kKv``)
TC_KV_TILE = 64


def p_bf16_weights(s: torch.Tensor, m: torch.Tensor,
                   tile: int = TC_KV_TILE,
                   split_tiles: "int | None" = None) -> torch.Tensor:
    """The softmax weights ``exp(s - m)`` as the tensor-core mainloop
    feeds them to the V product: each ``tile``-column tile's
    ``exp(s - m_j)``, with ``m_j`` the row's running max over tiles
    ``<= j``, rounded to bf16, then rescaled to the final max ``m`` in f32.
    With ``split_tiles`` the running max restarts at every split of that
    many tiles (tiles ``[z K, (z + 1) K)``: a split launch's blocks, each
    walking its own split). ``s`` holds f32 scores (masked ones at -1e30)
    over kv positions from 0; a last partial tile is padded with masked
    columns."""
    s_len = s.shape[-1]
    pad = -s_len % tile
    if pad:
        s = torch.nn.functional.pad(s, (0, pad), value=-1e30)
    tiles = s.unflatten(-1, (-1, tile))
    t_max = tiles.amax(dim=-1)
    if split_tiles:
        n = t_max.shape[-1]
        t_max = torch.nn.functional.pad(t_max, (0, -n % split_tiles),
                                        value=-1e30)
        m_run = (t_max.unflatten(-1, (-1, split_tiles)).cummax(dim=-1)
                 .values.flatten(-2)[..., :n])
    else:
        m_run = t_max.cummax(dim=-1).values
    p = (torch.exp(tiles - m_run[..., None]).to(torch.bfloat16).float()
         * torch.exp(m_run - m)[..., None])
    return p.flatten(-2)[..., :s_len]


def off_one_ulp(o, o_p) -> tuple[int, int]:
    """(elements, rows) of ``o`` past :data:`O_TOL_BF16` of ``o_p``; a
    row is the last axis (one query vector's outputs)."""
    tight = O_TOL_BF16
    over = ((o.float() - o_p.float()).abs()
            > tight["atol"] + tight["rtol"] * o_p.float().abs())
    return int(over.sum()), int(over.any(-1).sum())


def bf16_o_mismatch(o, o_p, o_r, wide: dict) -> "str | None":
    """Why a bf16 tensor-core forward's ``o`` fails its checks, or None:
    against the ``p_bf16`` plain version ``o_p``, at most
    max(FLIP_ROWS, FLIP_ROW_SHARE * rows) rows with an element off by
    more than :data:`O_TOL_BF16`; against the kernel's f32 plain version
    ``o_r``, every element within ``wide`` (atol, rtol: the kernel's own
    bound)."""
    elements, rows = off_one_ulp(o, o_p)
    allowed = max(FLIP_ROWS, int(FLIP_ROW_SHARE * o[..., 0].numel()))
    if rows > allowed:
        return (f"{rows} rows ({elements} elements) of o miss {O_TOL_BF16} "
                f"of the p_bf16 plain version (at most {allowed} rows may)")
    o, o_r = o.float(), o_r.float()
    if ((o - o_r).abs() > wide["atol"] + wide["rtol"] * o_r.abs()).any():
        return (f"o misses the plain version by "
                f"{float((o - o_r).abs().max()):.3e} ({wide})")
    return None


#: The tensor-core backward's gradients against the plain version that
#: rounds p and dS where the kernels do (``p_bf16=True``), per element, of
#: its ``magnitude`` (sum, largest): the sum of |terms| and the largest
#: |term| of the element's sum of products.
#: - ``rtol`` of the sum: both sum the same bf16 products in f32, in
#:   another order. wgmma truncates each 16-product step's sum to 24 bits,
#:   at most 2^-23 of the sum of |terms|; the training shapes sum at most
#:   8192 products an element (a group of 4 q heads x S 2048) in 512
#:   steps: 512 * 2^-23 = 2^-14.
#: - ``flip`` of the largest term: the kernel computes p and dS in f32 in
#:   another order than the plain version (exp2 of a wgmma sum against exp
#:   of a cuBLAS one), so an operand within that difference of a bf16
#:   rounding boundary rounds the other way in one of them, moving its term
#:   by one bf16 spacing, at most 2^-7 of it. An element has about one such
#:   operand when it sums thousands of terms, so one flip of its largest
#:   term is allowed everywhere.
#: - ``atol``: elements whose magnitude is about 0.
#: A row may still miss (FLIP_ROWS, FLIP_ROW_SHARE): two flips in one
#: element, or row 0 of a causal head, whose one dS is p (dP - delta) with
#: delta = dP: f32 rounding noise in both versions.
GRAD_TIGHT = dict(atol=1e-7, rtol=2.0 ** -14, flip=2.0 ** -7)

#: Against the f32 plain version: rounding an operand to bf16 moves it by
#: at most half its spacing, 2^-8 of a value just above a power of two
#: (2^-7 between 1 and 2), so at most 2^-8 / (1 - 2^-8) of the rounded
#: value; the element moves by at most that of its sum of |terms|, plus
#: the summation term of the f32 gradients (atol 1e-4).
GRAD_WIDE = dict(atol=1e-4, rtol=2.0 ** -8 / (1 - 2.0 ** -8))


def grad_tight_tol(magnitude) -> torch.Tensor:
    """:data:`GRAD_TIGHT` per element, for ``magnitude`` = (sum of
    |terms|, largest |term|)."""
    total, largest = magnitude
    return (GRAD_TIGHT["atol"] + GRAD_TIGHT["rtol"] * total
            + GRAD_TIGHT["flip"] * largest)


def grad_wide_tol(magnitude) -> torch.Tensor:
    """:data:`GRAD_WIDE` per element."""
    return GRAD_WIDE["atol"] + GRAD_WIDE["rtol"] * magnitude[0]


def off_grad_tight(g, g_p, magnitude) -> tuple[int, int]:
    """(elements, rows) of gradient ``g`` past :func:`grad_tight_tol` of
    the ``p_bf16`` plain version ``g_p``; a row is the last axis (one
    position's hd gradients)."""
    over = (g.float() - g_p.float()).abs() > grad_tight_tol(magnitude)
    return int(over.sum()), int(over.any(-1).sum())


def bf16_grad_mismatch(g, g_p, g_r, magnitude) -> "str | None":
    """Why a gradient of the tensor-core backward fails its checks, or
    None: against the ``p_bf16`` plain version ``g_p``, at most
    max(FLIP_ROWS, FLIP_ROW_SHARE * rows) rows with an element past
    :func:`grad_tight_tol`; against the f32 plain version ``g_r``, every
    element within :func:`grad_wide_tol`. ``magnitude``: (sum of |terms|,
    largest |term|) per element, ``flash_attention.flash_bwd_magnitudes``."""
    elements, rows = off_grad_tight(g, g_p, magnitude)
    allowed = max(FLIP_ROWS, int(FLIP_ROW_SHARE * g[..., 0].numel()))
    if rows > allowed:
        return (f"{rows} rows ({elements} elements) miss the p_bf16 plain "
                f"version by more than {GRAD_TIGHT} of their magnitude (at "
                f"most {allowed} rows may)")
    worst = float(((g.float() - g_r.float()).abs()
                   / grad_wide_tol(magnitude)).max())
    if worst > 1:
        return (f"the f32 plain version is missed by {worst:.3f} times "
                f"{GRAD_WIDE} of the magnitude")
    return None


def engine_key(name: str, engine: str) -> str:
    """The ``launch_counts()`` key of kernel ``name``'s launches on one
    engine of :data:`ENGINES`."""
    if engine not in ENGINES:
        raise ValueError(f"engine must be one of {ENGINES}, got {engine!r}")
    return f"{name}<{engine}>"


def count_launch(name: str) -> None:
    """A wrapper calls this once for each launch of its kernel. Inside
    :func:`recording_launches` (a CUDA graph capture, which launches
    nothing) the call is recorded for the capture instead."""
    recording = getattr(_capture, "launches", None)
    if recording is not None:
        recording[name] = recording.get(name, 0) + 1
        return
    with _launch_lock:
        _launches[name] = _launches.get(name, 0) + 1


@contextlib.contextmanager
def recording_launches():
    """While a CUDA graph is captured on this thread: the wrappers'
    counts go into the yielded dict, the launches one replay will make,
    and not into :func:`launch_counts`."""
    _capture.launches = recording = {}
    try:
        yield recording
    finally:
        _capture.launches = None


def count_replay(launches: dict[str, int]) -> None:
    """A graph replay launches the kernels its capture recorded
    (:func:`recording_launches`): count each of them once more."""
    with _launch_lock:
        for name, n in launches.items():
            _launches[name] = _launches.get(name, 0) + n


def launch_counts() -> dict[str, int]:
    with _launch_lock:
        return dict(_launches)


def reset_launch_counts() -> None:
    with _launch_lock:
        _launches.clear()
