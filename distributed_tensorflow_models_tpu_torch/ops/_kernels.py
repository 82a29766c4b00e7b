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

Each kernel's wrapper counts its launches in attributes of its own
(``fn.launches``), registered here with :func:`counted`.  A CUDA graph
replays launches without running the wrappers, so a captured step takes
the counts its capture added (:func:`launch_counts` before and after),
takes them back off (nothing launched then) and adds them again on every
replay (:func:`add_launches`).
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
DEFAULT_BUILD_DIR = PACKAGE_DIR.parent / "build" / "kernels"
# Where builds go and are looked up; harness/startup.py points it
# elsewhere (a config's xla_cache_dir).  Libraries already loaded stay
# loaded when it moves.
BUILD_DIR = DEFAULT_BUILD_DIR
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
# (wrapper, attribute) of every launch counter, in registration order.
_counters: list[tuple[object, str]] = []


def counted(fn, *attrs: str) -> None:
    """Register ``fn``'s launch counters ``attrs`` and set them to 0."""
    for attr in attrs:
        setattr(fn, attr, 0)
        _counters.append((fn, attr))


def launch_counts() -> dict[tuple[object, str], int]:
    """Every registered counter's value, keyed by (wrapper, attribute)."""
    return {(fn, attr): getattr(fn, attr) for fn, attr in _counters}


def add_launches(counts: dict[tuple[object, str], int],
                 times: int = 1) -> None:
    """Add ``times`` x ``counts`` to the counters (a negative ``times``
    takes them off)."""
    for (fn, attr), n in counts.items():
        if n:
            setattr(fn, attr, getattr(fn, attr) + times * n)


def set_build_dir(path: str | os.PathLike) -> Path:
    """Build into and load from ``path`` from now on; returns it."""
    global BUILD_DIR
    BUILD_DIR = Path(path)
    return BUILD_DIR


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
    for hdr in sorted(src.parent.glob("*.cuh")):
        parts += [hdr.name.encode(), hdr.read_bytes()]
    parts.append(" ".join(NVCC_FLAGS).encode())
    return b"\0".join(parts)


def load(source: str, csrc: Path = CSRC_DIR) -> ctypes.CDLL:
    """The shared library built from ``<csrc>/<source>`` (the package's
    ``csrc/`` by default; another tree's, to compare two versions of a
    kernel in one process), compiling it first if no build of this exact
    source exists yet.  Thread-safe; different sources build concurrently.
    ``build_seconds`` and ``build_logs`` key a source of another directory
    by its path."""
    src = Path(csrc) / source
    name = source if Path(csrc) == CSRC_DIR else str(src)
    with _locks_guard:
        lock = _locks.setdefault(name, threading.Lock())
    with lock:
        lib = _libs.get(name)
        if lib is not None:
            return lib
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
            build_seconds[name] = time.perf_counter() - t0
            build_logs[name] = proc.stderr
        lib = ctypes.CDLL(str(out))
        lib.dtm_cuda_error_string.argtypes = [ctypes.c_int]
        lib.dtm_cuda_error_string.restype = ctypes.c_char_p
        _libs[name] = lib
        return lib


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise if a kernel's C entry point returned a CUDA error."""
    if rc != 0:
        msg = lib.dtm_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what} failed: cudaError {rc} ({msg})")
