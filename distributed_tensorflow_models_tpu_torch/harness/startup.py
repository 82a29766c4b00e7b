"""Cold start: the kernel build cache, and the work of the first chunk
that runs while ``fit`` restores the checkpoint.

PyTorch counterpart of ``distributed_tensorflow_models_tpu/harness/startup.py``.
A (re)launched ``fit`` pays serial costs before its first step: building
the state, restoring the checkpoint, loading (or, on a fresh machine,
building with ``nvcc``) the kernel libraries the step launches, counting
the step's FLOPs, filling the input pipeline, the eager first step and the
capture.  Two of them need nothing the restore produces, and move under it:

- **The kernel build cache** (:func:`apply_compile_cache`).  Where the JAX
  package kept a persistent XLA compilation cache, the port keeps its
  ``nvcc`` builds (``ops/_kernels.py``, keyed on the source, the headers
  and the flags).  ``ExperimentConfig.xla_cache_dir`` names the directory:
  ``None`` keeps the process's (``build/kernels/`` at the repository root
  unless an explicit setting came first), a path is used as it is, and
  ``""`` keeps no persistent cache: the kernels build into a fresh
  temporary directory, removed at exit.
- **The background threads** (:class:`AotTrainStep`, the JAX name).
  Started once the state is built, before the restore: one thread per
  kernel library the step will launch loads it (:func:`kernel_loaders`
  on the live model: the implicit-GEMM conv for convs routed to ``mxu``,
  the flash library for ``attn_impl="flash"``; none off CUDA, where every
  kernel's wrapper takes its plain version), and one runs the FLOPs count
  on the meta device (``harness/train.py::step_flops_fn``, at
  :func:`abstract_batch`'s shapes).  Neither allocates on the device, so
  the restore may copy into the live tensors meanwhile.  A build is
  ``nvcc`` in a subprocess and overlaps everything; the FLOPs count is
  Python (mostly the first import of torch's meta-tensor machinery) and
  shares the interpreter lock with the main thread, so it overlaps only
  the main thread's waits.  ``fit`` calls :meth:`AotTrainStep.acquire`
  with the first chunk's signature: if it matches, the main thread waits
  for what is left of the work (that wait is the only part of it the
  first step pays) and a failed load is raised there; a wrong guess of
  the signature wastes the background work and changes nothing of the
  program (the step loads what it needs itself, waiting on the same
  per-source lock).

Telemetry: the threads stamp ``startup/aot_compile_s`` (from their start
to the last one's end, partly hidden behind the restore) and trace
``startup/aot_compile``, ``startup/kernel_load`` and
``startup/flops_count`` on the run's timeline; ``startup/aot_join`` is the
wait at :meth:`~AotTrainStep.acquire`, which ``fit`` adds to the first
capture's ``train/compile`` record.
"""

from __future__ import annotations

import atexit
import logging
import os
import shutil
import tempfile
import threading
import time
from pathlib import Path
from typing import Callable, Mapping, Optional

import torch

from distributed_tensorflow_models_tpu_torch import telemetry
from distributed_tensorflow_models_tpu_torch.core import mesh as meshlib
from distributed_tensorflow_models_tpu_torch.harness.config import (
    PREEMPT_POLL_STEPS_DEFAULT,
    ExperimentConfig,
)
from distributed_tensorflow_models_tpu_torch.ops import _kernels
from distributed_tensorflow_models_tpu_torch.ops import attention as attnlib
from distributed_tensorflow_models_tpu_torch.ops import conv as convlib
from distributed_tensorflow_models_tpu_torch.ops import conv_mxu

log = logging.getLogger("dtm")

Batch = Mapping[str, torch.Tensor]

# --------------------------------------------------------------------------
# The kernel build cache
# --------------------------------------------------------------------------

# False while the builds go to a temporary directory (xla_cache_dir="").
_persistent = True


def configured_cache_dir() -> Optional[str]:
    """The directory kernel builds go to and load from, or None when it is
    a temporary one (no persistent cache)."""
    return str(_kernels.BUILD_DIR) if _persistent else None


def apply_compile_cache(xla_cache_dir: Optional[str]) -> Optional[str]:
    """Point the kernel builds at ``xla_cache_dir`` and return the
    persistent cache in force (None: none).

    ``""`` builds into a fresh temporary directory (removed at exit); a
    path is used as it is; ``None`` keeps the process's directory, or
    returns to the default ``build/kernels/`` after a ``""``.  Libraries
    this process has loaded stay loaded."""
    global _persistent
    if xla_cache_dir == "":
        tmp = tempfile.mkdtemp(prefix="dtm-kernels-")
        atexit.register(shutil.rmtree, tmp, True)
        _kernels.set_build_dir(tmp)
        _persistent = False
        log.info("no persistent kernel build cache: building into %s", tmp)
        return None
    if xla_cache_dir is None:
        if not _persistent:
            _kernels.set_build_dir(_kernels.DEFAULT_BUILD_DIR)
            _persistent = True
        return configured_cache_dir()
    _kernels.set_build_dir(os.path.abspath(xla_cache_dir))
    _persistent = True
    log.info("kernel build cache at %s", _kernels.BUILD_DIR)
    return configured_cache_dir()


def cache_entry_count(cache_dir: Optional[str]) -> int:
    """Built kernel libraries (``*.so``) under ``cache_dir`` (0 when unset
    or missing): the delta across a build is the cache-miss signal."""
    if not cache_dir or not os.path.isdir(cache_dir):
        return 0
    return sum(1 for _ in Path(cache_dir).rglob("*.so"))


# --------------------------------------------------------------------------
# The batch the pipeline will produce, from the config alone
# --------------------------------------------------------------------------


def abstract_batch(cfg: ExperimentConfig,
                   mesh: Optional[meshlib.Mesh] = None) -> Optional[dict]:
    """Meta-device tensors of the shapes and dtypes of the batches
    ``DevicePrefetcher`` will hand the step for ``cfg``: this process's
    rows of the global batch (all of it without a mesh), and a language
    model's columns over a seq axis; None where the dataset's batch
    structure is unknown."""
    rows = (cfg.global_batch_size if mesh is None
            else meshlib.local_batch_size(cfg.global_batch_size, mesh))

    def leaf(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")

    if cfg.task == "lm":
        if cfg.dataset != "ptb":
            return None
        cols = cfg.num_steps
        if mesh is not None and mesh.seq_size > 1:
            cols //= mesh.seq_size
        return {"inputs": leaf((rows, cols), torch.int32),
                "targets": leaf((rows, cols), torch.int32)}
    if cfg.dataset not in ("mnist", "cifar10", "imagenet",
                           "imagenet_synthetic"):
        return None
    size = cfg.image_size
    channels = 3 if size > 28 else 1
    return {"image": leaf((rows, size, size, channels), torch.float32),
            "label": leaf((rows,), torch.int32)}


def stacked_batch(batch: Batch, k: int) -> dict:
    """The K-step chunk of ``batch``: a leading axis of ``k``, as
    ``BatchStacker`` stacks it."""
    return {key: torch.empty((k, *v.shape), dtype=v.dtype, device="meta")
            for key, v in batch.items()}


def dominant_chunk_len(cfg: ExperimentConfig, nproc: int = 1) -> int:
    """The length most of ``fit``'s chunks have under ``cfg``: the
    config-determined shrink triggers of ``harness/train.py::_chunk_len``
    (the log cadence, ``train_steps``, the step-cadence checkpoint, the
    multi-process preemption poll).  A clock-due save or a user hook can
    still cut another length."""
    k = max(1, min(int(cfg.steps_per_loop), int(cfg.train_steps)))
    if cfg.log_every_steps and cfg.log_every_steps > 0:
        k = min(k, int(cfg.log_every_steps))
    if cfg.checkpoint_every_steps:
        k = min(k, int(cfg.checkpoint_every_steps))
    if nproc > 1:
        k = min(k, max(1, int(cfg.preempt_poll_steps
                              or PREEMPT_POLL_STEPS_DEFAULT)))
    return max(1, k)


# --------------------------------------------------------------------------
# The work overlapped with the restore
# --------------------------------------------------------------------------


def kernel_loaders(model: torch.nn.Module,
                   device: str | torch.device) -> dict[str, Callable]:
    """The loader of each kernel library a step of ``model`` launches on
    ``device``, by source: ``conv_implicit_gemm.cu`` (K1/K6) when a conv
    routes to the implicit-GEMM core, ``flash_attention.cu`` (K2-K5) when
    attention runs ``flash``.  Empty off CUDA."""
    if torch.device(device).type != "cuda":
        return {}
    out: dict[str, Callable] = {}
    for m in model.modules():
        if isinstance(m, convlib.Conv2D):
            kh, kw, cin, _ = m.kernel.shape
            if (convlib.resolve_conv_impl(m.impl) == "mxu"
                    and conv_mxu._use_mxu_kernel(kh, kw, cin)):
                out["conv_implicit_gemm.cu"] = conv_mxu._load
        if getattr(m, "attn_impl", None) == "flash":
            out["flash_attention.cu"] = attnlib._load
    return out


def signature(batch: Batch) -> tuple:
    """A batch's signature: its keys, row shapes and dtypes (the format of
    ``core/train_loop.py``'s chunk signature, on a chunk)."""
    return tuple((key, tuple(v.shape[1:]), v.dtype)
                 for key, v in sorted(batch.items()))


class AotTrainStep:
    """The first chunk's work that needs no restored value, on daemon
    threads that :meth:`start` starts (``fit``: before the restore): each
    kernel library of ``loaders`` loaded, built first where no build of
    its source exists, on a thread of its own, and ``flops_of`` run on one
    row of ``chunk`` (meta tensors) on another.

    ``acquire(sig)`` with the live first chunk's signature: when it
    matches ``chunk``'s, waits for every thread (the wait is returned: the
    only part of the work the first step paid) and raises the first error
    of a load; a mismatch returns None at once and the step does the work
    itself.  Nothing the threads do changes the program: the kernels and
    the count are those the step would load and take."""

    def __init__(self, chunk: Batch, *, loaders: Mapping[str, Callable],
                 flops_of: Optional[Callable[[Batch], float]] = None,
                 registry: Optional[telemetry.MetricsRegistry] = None,
                 label: str = "train-step"):
        self._chunk = chunk
        self._sig = signature(chunk)
        self._flops_of = flops_of
        self._registry = (registry if registry is not None
                          else telemetry.get_registry())
        self._label = label
        self._error: Optional[BaseException] = None
        self._acquired = False
        self._lock = threading.Lock()
        self._threads: list[threading.Thread] = []
        self._loaders = dict(loaders)
        self._t0 = 0.0
        self._span = 0.0
        self._traced = False

    def _spawn(self, name: str, target, *args) -> None:
        thread = threading.Thread(target=target, args=args, name=name,
                                  daemon=True)
        self._threads.append(thread)
        thread.start()

    def start(self) -> "AotTrainStep":
        self._t0 = time.perf_counter()
        for load in self._loaders.values():
            self._spawn("aot-kernel-load", self._load, load)
        if self._flops_of is not None:
            self._spawn("aot-flops-count", self._count)
        return self

    def _timed(self, name: str, fn) -> None:
        t0 = time.perf_counter()
        try:
            fn()
        finally:
            t1 = time.perf_counter()
            with self._lock:
                # The span from start() to the last thread's end.
                self._span = max(self._span, t1 - self._t0)
                self._registry.gauge(telemetry.STARTUP_AOT_COMPILE).set(
                    self._span)
            self._registry.trace.complete(f"startup/{name}", t1 - t0,
                                          ts_mono=t0,
                                          args={"label": self._label})

    def _count(self) -> None:
        row = {k: v[0] for k, v in self._chunk.items()}
        try:
            self._timed("flops_count", lambda: self._flops_of(row))
        except Exception:  # noqa: BLE001 — telemetry, not training
            # The step counts again, and logs a count it cannot take as 0
            # (core/train_loop.py::MultiStep).
            log.warning("the startup thread could not count the step's "
                        "FLOPs", exc_info=True)

    def _load(self, load: Callable) -> None:
        before = cache_entry_count(configured_cache_dir())
        try:
            self._timed("kernel_load", load)
        except BaseException as e:  # noqa: BLE001 — raised at acquire()
            with self._lock:
                self._error = self._error or e
        built = cache_entry_count(configured_cache_dir()) - before
        if built:
            log.info("startup: built %d kernel libraries of the %s", built,
                     self._label)

    def _join_all(self, timeout: Optional[float] = None,
                  waiter: bool = False) -> Optional[float]:
        """Join the threads; the clock read (``perf_counter``) at which all
        were seen ended, None while one still runs.  A ``waiter`` (the
        join that waited for them) ends the span there: the span is then
        at least the wait, whatever the wake-up after the last thread's
        own clock read cost."""
        deadline = None if timeout is None else time.monotonic() + timeout
        for thread in self._threads:
            thread.join(None if deadline is None
                        else max(0.0, deadline - time.monotonic()))
        if any(t.is_alive() for t in self._threads):
            return None
        end = time.perf_counter()
        if waiter:
            with self._lock:
                self._span = max(self._span, end - self._t0)
                self._registry.gauge(telemetry.STARTUP_AOT_COMPILE).set(
                    self._span)
        if not self._traced:
            self._traced = True
            self._registry.trace.complete(
                "startup/aot_compile", self._span, ts_mono=self._t0,
                args={"label": self._label, "ok": self._error is None,
                      "kernels": sorted(self._loaders)})
            log.info("startup work for the %s done in %.2fs (%d kernel "
                     "libraries)", self._label, self._span,
                     len(self._loaders))
        return end

    def acquire(self, sig: tuple) -> Optional[float]:
        """Seconds waited for the threads when ``sig`` is the signature
        they worked for (0.0 if they were done), else None.  Raises a
        load's error.  Only the first call waits; later calls return
        None."""
        if self._acquired or sig != self._sig:
            return None
        self._acquired = True
        t0 = time.perf_counter()
        waiting = any(t.is_alive() for t in self._threads)
        # The wait and the span's end are one clock read.
        end = self._join_all(waiter=waiting)
        wait = end - t0 if waiting else 0.0
        self._registry.trace.complete("startup/aot_join", wait, ts_mono=t0,
                                      args={"label": self._label})
        if self._error is not None:
            raise self._error
        return wait

    def disable(self) -> None:
        """Offer nothing more: a later :meth:`acquire` returns None."""
        self._acquired = True

    def join(self, timeout: Optional[float] = None) -> None:
        """Reap the threads (an ``nvcc`` build cannot be cancelled, so an
        aborted ``fit`` must not leave one running into its caller)."""
        if self._join_all(timeout) is None:
            log.warning("the %s startup work still runs after %.0fs of "
                        "teardown; leaving its daemon threads to finish",
                        self._label, timeout or 0.0)
