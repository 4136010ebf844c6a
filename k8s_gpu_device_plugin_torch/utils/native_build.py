"""Build a C++ source of ``native/`` into a shared library at first use.

One recipe for every C ABI library the port loads with ``ctypes``
(``native/dataload.cc``, the token gather; ``native/gpuenum.cc``, the GPU
enumerator): ``$CXX`` (split as a shell word list; default ``g++``) with
``-O2 -fPIC -std=c++17 -shared``, as the reference's ``native/Makefile``
builds its libraries, into ``native/build/`` (git-ignored) under a name
that carries a hash of the source, the compiler and the flags. The
build writes a temporary name and renames it into place, so a process
never loads a half-written library and concurrent builds of one source
agree. A compiler that fails raises with its own output.
"""

from __future__ import annotations

import hashlib
import os
import shlex
import shutil
import subprocess
import tempfile
from pathlib import Path

NATIVE_DIR = Path(__file__).resolve().parent.parent / "native"
BUILD_DIR = NATIVE_DIR / "build"
CXX_FLAGS = ("-O2", "-Wall", "-Wextra", "-fPIC", "-std=c++17", "-shared")


def find_cxx() -> "list[str] | None":
    """The C++ compiler command: ``$CXX`` (split as a shell word list)
    or ``g++``, when its executable is on the PATH; None otherwise."""
    cmd = shlex.split(os.environ.get("CXX") or "g++")
    if not cmd or shutil.which(cmd[0]) is None:
        return None
    return cmd


def library_path(name: str, source: Path, cxx: "list[str]",
                 link_flags=(), build_dir: "Path | None" = None,
                 headers=()) -> Path:
    """Where the build of ``source`` (and the ``headers`` it includes)
    with ``cxx`` lands."""
    h = hashlib.sha256()
    for part in (*cxx, *CXX_FLAGS, *link_flags):
        h.update(part.encode() + b"\0")
    for path in (source, *headers):
        h.update(Path(path).read_bytes())
    return Path(build_dir or BUILD_DIR) / f"lib{name}_{h.hexdigest()[:16]}.so"


def build_library(name: str, source: Path, what: str, link_flags=(),
                  build_dir: "Path | None" = None, headers=()) -> Path:
    """Build ``source`` (once per source, compiler and flags) into
    ``build_dir`` (``BUILD_DIR`` when None) and return the library's
    path. ``what`` names the library in errors. Raises
    RuntimeError without a C++ compiler, or with the compiler's output
    when the build fails."""
    cxx = find_cxx()
    if cxx is None:
        raise RuntimeError(
            f"no C++ compiler ($CXX or g++ on the PATH): {what} is built "
            f"from native/{Path(source).name} at first use")
    out = library_path(name, source, cxx, link_flags, build_dir, headers)
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    try:
        proc = subprocess.run(
            [*cxx, *CXX_FLAGS, "-o", tmp, str(source), *link_flags],
            capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(
                f"{cxx[0]} failed building {what} (exit "
                f"{proc.returncode}):\n{proc.stderr[-4000:]}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out
