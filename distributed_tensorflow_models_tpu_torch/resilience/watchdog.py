"""Step-progress watchdog: a hung run must say so.

The port's copy of ``distributed_tensorflow_models_tpu/resilience/
watchdog.py`` (stdlib and the port's telemetry names).

A deadlocked collective (one host dead, seven blocked in an all-reduce)
or a wedged input pipeline stalls the train loop *silently* — the
process is alive, the logs stop, and the run never ends.  The watchdog is a daemon thread
that watches a heartbeat the train loop touches once per completed chunk
and:

- maintains the ``train/watchdog_last_progress_s`` gauge (live
  seconds-since-last-progress, in the run's registry),
- logs an ERROR diagnosis when no chunk completes within ``timeout_s``,
  repeated each further timeout interval while the stall persists,
- with ``abort=True``, calls ``abort_fn`` from the second interval on —
  but only once at least one chunk has ever completed (before the first
  ``beat()``, "no progress" is usually the first step's kernel builds
  and graph capture, which must never be killed; it still gets the
  warning + gauge).  The default ``abort_fn``
  (``_thread.interrupt_main``) simulates SIGINT in the main thread:
  under the :mod:`preemption` listener the first firing requests a
  graceful checkpoint-and-exit and the next escalates to
  ``KeyboardInterrupt`` — an escalation ladder that can unstick
  Python-level waits.  A hang inside a NCCL collective or a replayed
  CUDA graph does not poll signals; for that domain the watchdog's value
  is the diagnosis (external supervisors kill on the log line / gauge).
"""

from __future__ import annotations

import _thread
import logging
import threading
import time
from typing import Callable, Optional

from distributed_tensorflow_models_tpu_torch import telemetry

log = logging.getLogger("dtm")


class ProgressWatchdog:
    """``beat()`` per completed chunk; warn/abort when the gap exceeds
    ``timeout_s``.  ``stop()`` is idempotent and joins the thread."""

    def __init__(
        self,
        timeout_s: float,
        *,
        registry: Optional[telemetry.MetricsRegistry] = None,
        abort: bool = False,
        abort_fn: Optional[Callable[[], None]] = None,
        poll_s: Optional[float] = None,
    ):
        if timeout_s <= 0:
            raise ValueError(f"watchdog timeout must be > 0, got {timeout_s}")
        self._timeout = float(timeout_s)
        self._registry = (
            registry if registry is not None else telemetry.get_registry()
        )
        if (
            abort
            and abort_fn is None
            and threading.current_thread() is not threading.main_thread()
        ):
            # The default abort (interrupt_main) always targets the MAIN
            # thread; when the training loop runs elsewhere it would
            # interrupt the caller's unrelated work and never unstick
            # the stalled loop.  Keep the diagnosis, drop the abort.
            log.warning(
                "watchdog abort disabled: training is not on the main "
                "thread, so the default interrupt_main abort would hit "
                "unrelated code (pass an explicit abort_fn to re-enable)"
            )
            abort = False
        self._abort = abort
        self._abort_fn = abort_fn or _thread.interrupt_main
        self._poll = poll_s if poll_s is not None else min(1.0, timeout_s / 4)
        # Guards _last/_last_step/_fired/_beats: beat() runs on the
        # train loop while _run polls them — snapshotting all four under
        # one lock keeps "idle since" and "which step" consistent, and
        # makes beat()'s _fired reset visible before _run re-arms it.
        self._lock = threading.Lock()
        self._last = time.perf_counter()
        self._last_step: Optional[int] = None
        self._fired = 0  # timeout intervals elapsed in the current stall
        # Abort arms only after the first beat: before any chunk has
        # completed, "no progress" is usually the first step's kernel
        # builds and capture — diagnose it (warn + gauge), never kill it.
        self._beats = 0
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._run, name="progress-watchdog", daemon=True
        )
        self._thread.start()

    def beat(self, step: Optional[int] = None) -> None:
        """Record progress (one completed chunk).  Cheap: an
        uncontended lock and four writes."""
        with self._lock:
            self._last = time.perf_counter()
            self._last_step = step
            self._fired = 0
            self._beats += 1
        self._registry.gauge(telemetry.WATCHDOG_LAST_PROGRESS).set(0.0)

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(timeout=5.0)

    def _run(self) -> None:
        gauge = self._registry.gauge(telemetry.WATCHDOG_LAST_PROGRESS)
        while not self._stop.wait(self._poll):
            with self._lock:
                idle = time.perf_counter() - self._last
                last_step = self._last_step
                beats = self._beats
                intervals = int(idle // self._timeout)
                stalled = intervals > self._fired
                if stalled:
                    self._fired = intervals
            gauge.set(idle)
            if not stalled:
                continue
            at = (
                f"after step {last_step}"
                if last_step is not None
                else "before the first step"
            )
            log.error(
                "watchdog: no training progress for %.1fs (timeout %.1fs, "
                "%s) — suspect a hung collective or input-pipeline "
                "deadlock; thread dump via SIGQUIT/py-spy",
                idle,
                self._timeout,
                at,
            )
            if self._abort and intervals >= 2 and beats > 0:
                log.error(
                    "watchdog: aborting stalled run (interval %d)", intervals
                )
                try:
                    self._abort_fn()
                except Exception:  # noqa: BLE001 — watchdog must not die
                    log.exception("watchdog abort_fn failed")
