"""Build and load the package's hand-written CUDA kernels.

Each kernel lives under ``csrc/`` as a ``.cu`` file with a plain C
interface; the Hopper helpers they share are in ``csrc/*.cuh``
(``hopper.cuh``).  At first use a source is compiled with ``nvcc`` for
``sm_90a`` into ``build/kernels/`` at the repository root, under a name
keyed on a hash of its bytes, every header's bytes and the compiler
flags (an edit to a header rebuilds every library), and loaded with
``ctypes`` — seconds per kernel, where a build that includes PyTorch's
headers takes minutes.  Nothing is compiled or loaded at import time: the
CPU tests import every module here.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# One lock per source, so that two sources build at once (each in its own
# nvcc) while two callers of the same source never build it twice.
_locks_guard = threading.Lock()
_locks: dict[str, threading.Lock] = {}
_libs: dict[str, ctypes.CDLL] = {}
# Seconds nvcc took for each library this process built, and what ptxas
# said of each kernel (registers, shared memory, spills); a library that
# was already on disk has no entry.  chip_smoke.py reports both.
build_seconds: dict[str, float] = {}
build_logs: dict[str, str] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError(
        "nvcc not found: the CUDA kernels are built from csrc/ at first use "
        "and need the CUDA toolkit on PATH or under /usr/local/cuda"
    )


def _source_key(src: Path) -> bytes:
    """What a build depends on: the source, every header beside it (by
    name and bytes, in name order) and the flags."""
    parts = [src.read_bytes()]
    for hdr in sorted(CSRC_DIR.glob("*.cuh")):
        parts += [hdr.name.encode(), hdr.read_bytes()]
    parts.append(" ".join(NVCC_FLAGS).encode())
    return b"\0".join(parts)


def load(source: str) -> ctypes.CDLL:
    """The shared library built from ``csrc/<source>``, compiling it first
    if no build of this exact source exists yet.  Thread-safe; different
    sources build concurrently."""
    with _locks_guard:
        lock = _locks.setdefault(source, threading.Lock())
    with lock:
        lib = _libs.get(source)
        if lib is not None:
            return lib
        src = CSRC_DIR / source
        digest = hashlib.sha256(_source_key(src)).hexdigest()[:16]
        out = BUILD_DIR / f"{src.stem}_{digest}.so"
        if not out.exists():
            t0 = time.perf_counter()
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            # Build to a private name, then rename: concurrent builders
            # never load a half-written library.
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed for {source} ({proc.returncode}):\n"
                    f"{proc.stdout}\n{proc.stderr}"
                )
            os.replace(tmp, out)
            build_seconds[source] = time.perf_counter() - t0
            build_logs[source] = proc.stderr
        lib = ctypes.CDLL(str(out))
        lib.dtm_cuda_error_string.argtypes = [ctypes.c_int]
        lib.dtm_cuda_error_string.restype = ctypes.c_char_p
        _libs[source] = lib
        return lib


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise if a kernel's C entry point returned a CUDA error."""
    if rc != 0:
        msg = lib.dtm_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what} failed: cudaError {rc} ({msg})")
