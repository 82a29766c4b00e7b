"""Training hooks: the reference's session-hook set, step-callback style.

The port's copy of the part of ``distributed_tensorflow_models_tpu/
harness/hooks.py`` that the chunked loop of ``fit`` needs: the ``Hook``
protocol (with ``wants_step``), :class:`LazyMetricRow`, the stop, step
counter, NaN guard, logging, metric-writer, TensorBoard, telemetry,
checkpoint, fault-injection and profiler hooks, and the two walks.  The
logic is the JAX package's; device values are read with torch, the
checkpoint hook's multi-process clock poll and the telemetry hook's
per-process gather go through ``resilience/consensus.py`` (host tensors
on a gloo group), and the profiler is ``torch.profiler``.

Metric readback note: ``after_step`` receives the *device* metrics (a
:class:`LazyMetricRow` over a chunk's stacked metrics, or a dict of 0-d
tensors); hooks that need host floats call ``float(...)`` themselves, and
only on the steps where they fire, so the loop never forces a sync on
quiet steps.
"""

from __future__ import annotations

import json
import logging
import math
import os
import time
from collections.abc import MutableMapping
from typing import Any, Iterator, Mapping, Optional, Sequence

from distributed_tensorflow_models_tpu_torch import telemetry

log = logging.getLogger("dtm")

Metrics = Mapping[str, Any]


class Hook:
    def begin(self, state) -> None: ...

    def wants_step(self, step: int) -> bool:
        """Does this hook need :meth:`after_step` called at ``step``?

        The chunked loop of ``fit`` consults this to skip whole hook walks
        on steps where no hook would act, and ends a chunk at the first
        step a hook wants.  Returning ``True`` is always safe; the default
        keeps per-step semantics (chunks of one step) for arbitrary user
        hooks.  Must be cheap, side-effect-free and deterministic in
        ``step``."""
        return True

    def after_step(self, state, metrics: Metrics, step: int) -> None: ...

    def end(self, state) -> None: ...

    def abort(self, state) -> None:
        """Cleanup on the *failure* path.  Defaults to :meth:`end`."""
        self.end(state)


class LazyMetricRow(MutableMapping):
    """One step's lazy view into a chunk's stacked on-device metrics.

    The K-step call returns every metric as a ``[K]``-stacked device
    tensor; materialising K host dicts per chunk would put back the
    per-step host cost.  This row indexes a column only when a hook reads
    the key (the result is still a 0-d device tensor: only ``float()``
    waits for the device), so hooks that fire every N steps never sync the
    other N-1 rows.

    Writes land in a host-side overlay that shadows the stacked columns.
    Chunk-aware consumers (:class:`NanGuardHook`) reach the whole chunk
    through :meth:`stacked` with :attr:`chunk_start_step` and
    :attr:`index` to attribute a mid-chunk event to its exact step.
    """

    def __init__(self, stacked: Mapping, index: int, chunk_start_step: int):
        self._stacked = stacked
        self._index = index
        self._start = chunk_start_step  # global step of row 0
        self._overlay: dict = {}

    @property
    def index(self) -> int:
        return self._index

    @property
    def chunk_start_step(self) -> int:
        return self._start

    def stacked(self, key: str):
        """The full ``[K]`` column behind ``key`` (raises KeyError for
        overlay-only keys, which have no per-step history)."""
        return self._stacked[key]

    def __getitem__(self, key):
        if key in self._overlay:
            return self._overlay[key]
        return self._stacked[key][self._index]

    def __setitem__(self, key, value):
        self._overlay[key] = value

    def __delitem__(self, key):
        del self._overlay[key]

    def __iter__(self) -> Iterator[str]:
        yield from self._stacked
        for k in self._overlay:
            if k not in self._stacked:
                yield k

    def __len__(self) -> int:
        return len(set(self._stacked) | set(self._overlay))


class StopRequested(Exception):
    """Raised by hooks to end training (StopAtStepHook's mechanism)."""


class StopAtStepHook(Hook):
    """Stop after ``last_step`` (TF basic_session_run_hooks.py:393)."""

    def __init__(self, last_step: int):
        self._last = last_step

    def wants_step(self, step):
        return step >= self._last

    def after_step(self, state, metrics, step):
        if step >= self._last:
            raise StopRequested


class StepCounterHook(Hook):
    """steps/sec (and examples/sec) every ``every_steps``: the reference's
    throughput meter (TF basic_session_run_hooks.py:674), on the host's
    clock."""

    def __init__(self, every_steps: int = 100,
                 batch_size: Optional[int] = None):
        self._every = every_steps
        self._batch = batch_size
        self._t0 = None
        self._s0 = 0
        self.last_steps_per_sec: Optional[float] = None

    def begin(self, state):
        self._t0 = time.perf_counter()
        self._s0 = int(state.step)

    def wants_step(self, step):
        return step % self._every == 0

    def after_step(self, state, metrics, step):
        if step % self._every:
            return
        now = time.perf_counter()
        dt = now - self._t0
        if dt <= 0:
            return
        sps = (step - self._s0) / dt
        self.last_steps_per_sec = sps
        msg = f"step {step}: {sps:.2f} steps/sec"
        if self._batch:
            msg += f", {sps * self._batch:.1f} examples/sec"
        log.info(msg)
        self._t0, self._s0 = now, step


class NanGuardHook(Hook):
    """Abort on non-finite loss (NanTensorHook, TF
    basic_session_run_hooks.py:761).  Checks every ``every_steps`` to avoid
    forcing a device sync each step."""

    def __init__(self, every_steps: int = 100, key: str = "loss"):
        self._every = every_steps
        self._key = key

    def wants_step(self, step):
        return step % self._every == 0

    def after_step(self, state, metrics, step):
        if step % self._every:
            return
        if isinstance(metrics, LazyMetricRow):
            # A chunk's row: check EVERY row of the chunk up to this one
            # (one [K] read back, the same sync as the scalar) so a
            # mid-chunk NaN is caught at the boundary walk and attributed
            # to its exact step, not the chunk's end.
            arr = metrics.stacked(self._key)[: metrics.index + 1].tolist()
            for i, value in enumerate(arr):
                if not math.isfinite(value):
                    raise FloatingPointError(
                        f"{self._key} is {value} at step "
                        f"{metrics.chunk_start_step + i}"
                    )
            return
        value = float(metrics[self._key])
        if not math.isfinite(value):
            raise FloatingPointError(
                f"{self._key} is {value} at step {step}"
            )


class LoggingHook(Hook):
    """Log scalar metrics every N steps (LoggingTensorHook :169)."""

    def __init__(self, every_steps: int = 100,
                 keys: Optional[Sequence[str]] = None):
        self._every = every_steps
        self._keys = keys

    def wants_step(self, step):
        return step % self._every == 0

    def after_step(self, state, metrics, step):
        if step % self._every:
            return
        keys = self._keys or sorted(metrics)
        parts = []
        for k in keys:
            v = metrics.get(k)
            if v is None:
                continue
            try:
                parts.append(f"{k}={float(v):.4f}")
            except (TypeError, ValueError, RuntimeError):
                # Array-valued metric: skip.  Logging must never be the
                # thing that kills training.
                continue
        log.info("step %d: %s", step, ", ".join(parts))


class MetricWriterHook(Hook):
    """Append scalar metrics to ``<workdir>/metrics.jsonl`` every N steps:
    the SummarySaverHook role (TF monitored_session.py:585-590), one JSON
    object per line, each row one ``write`` of the full line (line
    buffered), so a concurrent ``tail -f`` never sees a torn line."""

    def __init__(self, workdir: str, every_steps: int = 100):
        self._path = os.path.join(workdir, "metrics.jsonl")
        self._every = every_steps
        os.makedirs(workdir, exist_ok=True)
        self._f = open(self._path, "a", buffering=1)

    def write_row(self, row: Mapping[str, Any]) -> None:
        """Append one row (atomic single write of the full line)."""
        if self._f.closed:  # post-end() stragglers must not crash
            self._f = open(self._path, "a", buffering=1)
        self._f.write(json.dumps(row) + "\n")

    def wants_step(self, step):
        return step % self._every == 0

    def after_step(self, state, metrics, step):
        if step % self._every:
            return
        row = {"step": step, "time": time.time()}
        for k, v in metrics.items():
            try:
                row[k] = float(v)
            except (TypeError, ValueError, RuntimeError):
                continue
        self.write_row(row)

    def end(self, state):
        if not self._f.closed:
            self._f.close()


def _process_index() -> int:
    import torch.distributed as dist

    return dist.get_rank() if dist.is_initialized() else 0


class TensorBoardHook(Hook):
    """Scalar summaries into TensorBoard event files every ``every_steps``
    (default 100, the reference's SummarySaverHook cadence — TF
    monitored_session.py:517-518), via the no-TF writer in
    :mod:`harness.summary`.  Chief-only, like the reference's
    SummarySaverHook: only process 0 (``process_index``, by default the
    process group's rank) writes, so no duplicate event streams."""

    def __init__(self, workdir: str, every_steps: int = 100, *,
                 process_index: Optional[int] = None):
        self._writer = None
        pid = _process_index() if process_index is None else process_index
        if pid == 0:
            from distributed_tensorflow_models_tpu_torch.harness.summary import (
                SummaryWriter,
            )

            self._writer = SummaryWriter(os.path.join(workdir, "tensorboard"))
        self._every = every_steps

    def wants_step(self, step):
        return self._writer is not None and step % self._every == 0

    def after_step(self, state, metrics, step):
        if self._writer is None or step % self._every:
            return
        values = {}
        for k, v in metrics.items():
            try:
                values[k] = float(v)
            except (TypeError, ValueError, RuntimeError):
                continue
        self._writer.scalars(step, values)
        # Flush each write (log cadence, ~50 bytes a scalar): a live
        # TensorBoard sees events at once and a SIGKILL loses nothing.
        self._writer.flush()

    def end(self, state):
        if self._writer is not None:
            self._writer.close()


class TelemetryHook(Hook):
    """Snapshot the telemetry registry every ``every_steps`` and inject the
    derived scalars into the step's ``metrics``, where the writer hooks
    after it (``MetricWriterHook`` → ``metrics.jsonl``, ``TensorBoardHook``
    → event files) pick them up on the same cadence.  **Must be ordered
    before the writer hooks** (``fit`` does this).  It reads only the
    registry, on the host: no device value, so no sync of its own.

    Injected keys (interval = since the previous cadence firing), the JAX
    package's: ``step_time_s``, ``data_wait_s`` and ``dispatch_s`` (means
    per step or per record), ``steps_per_sec``, ``stall_fraction`` (the
    wait for input's share of the interval's wall), ``mfu`` (FLOPs retired
    over interval wall × peak; 0.0 when the device has no known peak or
    the FLOPs are unknown), ``compile_count``/``compile_s``,
    ``checkpoint_s`` and ``checkpoint/fence_s``, the three ``startup/*``
    gauges, ``host_queue_depth`` and the ``restarts``/``rollbacks``/
    ``skipped_batches`` counters.

    The peak is the device's (``telemetry.peak_flops`` of
    ``telemetry.device_kind(device)``; a CPU has none) times
    ``n_devices`` (default: the process group's world), since the FLOPs
    counted are the global batch's.  With several processes the
    ``[steps/s, stall_fraction]`` pairs are gathered through
    ``consensus`` (a gloo group of host tensors, never the step's stream
    or its graph; every process runs the hook at the same steps), and the
    chief's writers record ``hosts/steps_per_sec_{min,mean}`` and
    ``hosts/stall_fraction_max``."""

    def __init__(self, registry: telemetry.MetricsRegistry,
                 every_steps: int = 100,
                 process_count: Optional[int] = None, *,
                 device=None, n_devices: Optional[int] = None,
                 consensus=None):
        from distributed_tensorflow_models_tpu_torch.resilience import (
            consensus as conslib,
        )

        self._reg = registry
        self._every = every_steps
        self._consensus = (conslib.Consensus() if consensus is None
                           else consensus)
        self._nproc = (self._consensus.process_count if process_count is None
                       else process_count)
        try:
            peak = telemetry.peak_flops(telemetry.device_kind(device))
            n = telemetry.device_count() if n_devices is None else n_devices
            self._peak = peak and peak * n
        except Exception:  # noqa: BLE001 — telemetry must never crash
            self._peak = None
        self._last: Optional[tuple[float, int, dict]] = None
        self.last_emitted: Optional[dict] = None

    def begin(self, state):
        self._last = (time.perf_counter(), int(state.step),
                      self._reg.snapshot())

    def wants_step(self, step):
        # Deterministic in step: the multi-process branch of after_step is
        # a collective, so every process must walk the same rows.
        return step % self._every == 0

    def after_step(self, state, metrics, step):
        if step % self._every:
            return
        now = time.perf_counter()
        snap = self._reg.snapshot()
        t0, s0, prev = self._last or (now, step, {})
        self._last = (now, step, snap)
        d_wall = max(now - t0, 1e-9)
        d_steps = max(step - s0, 0)

        def delta(key: str) -> float:
            return snap.get(key, 0.0) - prev.get(key, 0.0)

        def mean(name: str) -> float:
            n = delta(f"{name}/count")
            return delta(f"{name}/total_s") / n if n else 0.0

        data_wait = delta(f"{telemetry.DATA_WAIT}/total_s")
        sps = d_steps / d_wall
        stall_frac = data_wait / d_wall
        flops_done = delta(telemetry.FLOPS_TOTAL)
        out = {
            "step_time_s": mean(telemetry.STEP_TIME),
            "data_wait_s": data_wait / max(d_steps, 1),
            "dispatch_s": mean(telemetry.DISPATCH),
            "steps_per_sec": sps,
            "stall_fraction": stall_frac,
            "mfu": (flops_done / (d_wall * self._peak)
                    if self._peak and flops_done > 0 else 0.0),
            "compile_count": snap.get(f"{telemetry.COMPILE}/count", 0.0),
            "compile_s": snap.get(f"{telemetry.COMPILE}/total_s", 0.0),
            "checkpoint_s": (
                snap.get(f"{telemetry.CKPT_SAVE}/total_s", 0.0)
                + snap.get(f"{telemetry.CKPT_RESTORE}/total_s", 0.0)
                + snap.get(f"{telemetry.CKPT_WAIT}/total_s", 0.0)
                + snap.get(f"{telemetry.CKPT_FENCE}/total_s", 0.0)
            ),
            "checkpoint/fence_s": snap.get(
                f"{telemetry.CKPT_FENCE}/total_s", 0.0),
            "startup/restore_s": snap.get(telemetry.STARTUP_RESTORE, 0.0),
            "startup/aot_compile_s": snap.get(
                telemetry.STARTUP_AOT_COMPILE, 0.0),
            "startup/time_to_first_step_s": snap.get(
                telemetry.STARTUP_FIRST_STEP, 0.0),
            "host_queue_depth": snap.get(telemetry.HOST_QUEUE_DEPTH, 0.0),
            # Always the three together (the schema lint checks the set).
            "restarts": snap.get(telemetry.RESTARTS, 0.0),
            "rollbacks": snap.get(telemetry.ROLLBACKS, 0.0),
            "skipped_batches": snap.get(telemetry.SKIPPED_BATCHES, 0.0),
        }
        if self._nproc > 1:
            gathered = self._consensus.allgather_floats(
                [sps, stall_frac], label="telemetry")
            rates = [row[0] for row in gathered]
            out["hosts/steps_per_sec_min"] = min(rates)
            out["hosts/steps_per_sec_mean"] = sum(rates) / len(rates)
            out["hosts/stall_fraction_max"] = max(row[1] for row in gathered)
        self.last_emitted = out
        if isinstance(metrics, MutableMapping):
            # A dict, or a LazyMetricRow (overlay write): both carry the
            # injection to the writer hooks after this one.
            metrics.update(out)


class CheckpointHook(Hook):
    """Save every ``every_secs`` (default 600 s, the reference's
    CheckpointSaverHook default — TF monitored_session.py:525-528), every
    ``every_steps`` steps when set, and at ``end``.  ``save_fn(state,
    step)`` is provided by ``fit`` so the hook stays agnostic of the
    checkpoint layout.

    With several processes every process must decide "save now" at the
    *same step* (the save decisions are agreed through consensus, a
    collective).  A per-process wall clock cannot guarantee that, so the
    chief alone reads the clock and its decision is gathered, polled every
    ``poll_every_steps`` steps (``fit`` passes ``cfg.preempt_poll_steps``,
    the cadence of its preemption poll) to keep the collective off the
    per-step path; step-based triggers are deterministic on every process
    and need no poll.  ``consensus`` defaults to the live process group's."""

    def __init__(self, save_fn, every_secs: Optional[float] = 600.0,
                 every_steps: Optional[int] = None, *,
                 poll_every_steps: int, consensus=None):
        from distributed_tensorflow_models_tpu_torch.resilience import (
            consensus as conslib,
        )

        self._save = save_fn
        self._every_secs = every_secs
        self._every_steps = every_steps
        self._poll = max(1, poll_every_steps)
        self._last_time = time.time()
        self._consensus = (conslib.Consensus() if consensus is None
                           else consensus)
        self._multiproc = self._consensus.active

    def _time_due(self, step: int) -> bool:
        if self._every_secs is None:
            return False
        if not self._multiproc:
            return time.time() - self._last_time >= self._every_secs
        if step % self._poll:
            return False
        chief_due = (self._consensus.is_chief
                     and time.time() - self._last_time >= self._every_secs)
        return bool(self._consensus.allgather_int(
            int(chief_due), label="checkpoint-clock")[0])

    def wants_step(self, step):
        # Step triggers and the multi-process poll cadence are
        # deterministic in step (required: the poll is a collective); the
        # single-process clock check is local, so reading it here is safe.
        if self._every_steps and step % self._every_steps == 0:
            return True
        if self._every_secs is None:
            return False
        if self._multiproc:
            return step % self._poll == 0
        return time.time() - self._last_time >= self._every_secs

    def after_step(self, state, metrics, step):
        due_step = self._every_steps and step % self._every_steps == 0
        if due_step or self._time_due(step):
            self._save(state, step)
            self._last_time = time.time()

    def end(self, state):
        self._save(state, int(state.step))

    def abort(self, state):
        # A crash-time save is safe (and valuable) with one process; with
        # peers its decision is a collective this lone failing process
        # must NOT enter — the others are blocked elsewhere.  Recovery
        # then restores the last scheduled checkpoint.
        if not self._multiproc:
            self._save(state, int(state.step))
        else:
            log.warning(
                "skipping crash-time checkpoint save on a multi-process "
                "failure (its decision is a collective one process cannot "
                "run)"
            )


class FaultInjectionHook(Hook):
    """Raise a chosen exception at a chosen step, once.

    The reference has no fault injection anywhere; the rebuild adds it as
    a first-class hook so the recovery path — the analogue of
    ``_RecoverableSession``'s retry loop (TF
    monitored_session.py:1261-1274) — is testable on demand rather than
    only on real preemptions."""

    def __init__(self, step: int, exc_factory=None):
        self._step = step
        self._fired = False
        self._exc_factory = exc_factory or (
            lambda: RuntimeError("injected preemption")
        )

    def wants_step(self, step):
        return step == self._step and not self._fired

    def after_step(self, state, metrics, step):
        if step == self._step and not self._fired:
            self._fired = True
            raise self._exc_factory()


class ProfilerHook(Hook):
    """Profile steps [start, stop) with ``torch.profiler`` (host and, on
    a card, device activity) and export a Chrome trace to
    ``<workdir>/profile/trace_<start>_<stop>.json``: the Timeline/
    FULL_TRACE replacement (SURVEY.md §5.1; TF client/timeline.py:410).
    In the chunked loop a chunk ends at each of the two steps, so the
    trace holds exactly the chunks of those steps."""

    def __init__(self, workdir: str, start_step: int, stop_step: int):
        self._dir = os.path.join(workdir, "profile")
        self._start = start_step
        self._stop = stop_step
        self._prof = None
        self.path: Optional[str] = None

    def wants_step(self, step):
        return (self._prof is None and step == self._start) or (
            self._prof is not None and step >= self._stop)

    def after_step(self, state, metrics, step):
        if step == self._start and self._prof is None:
            import torch

            acts = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self._prof = torch.profiler.profile(activities=acts)
            self._prof.start()
        elif step >= self._stop and self._prof is not None:
            self._finish(step)

    def _finish(self, step: int) -> None:
        prof, self._prof = self._prof, None
        prof.stop()
        os.makedirs(self._dir, exist_ok=True)
        self.path = os.path.join(self._dir,
                                 f"trace_{self._start}_{step}.json")
        prof.export_chrome_trace(self.path)

    def end(self, state):
        if self._prof is not None:
            self._finish(int(state.step))


def run_hooks_after_step(hooks: Sequence[Hook], state, metrics, step) -> bool:
    """Returns False when a hook requested stop.  Every hook runs every
    step: a StopRequested from one hook must not starve later hooks of the
    final step's metrics."""
    stop = False
    for h in hooks:
        try:
            h.after_step(state, metrics, step)
        except StopRequested:
            stop = True
    return not stop


def run_hooks_after_chunk(
    hooks: Sequence[Hook],
    state,
    stacked_metrics: Mapping,
    start_step: int,
    length: int,
    registry: Optional[telemetry.MetricsRegistry] = None,
    final_row: Optional[LazyMetricRow] = None,
) -> bool:
    """Walk hooks for the ``length`` steps of one chunk, skipping every
    step no hook wants (:meth:`Hook.wants_step`): the quiet steps cost one
    predicate sweep each, no metric sync, no hook walk.

    The chunk covers steps ``start_step+1 .. start_step+length``; each
    walked step gets a :class:`LazyMetricRow` over ``stacked_metrics``
    (row i is step ``start_step+1+i``).  ``state`` is the end-of-chunk
    state, the only one the K-step call leaves.

    Full walks are counted into ``registry``'s ``train/hook_walks``.
    Per-walk semantics match :func:`run_hooks_after_step`: every hook runs,
    StopRequested defers to the end of the walk, and nothing is walked
    after the stop step.  ``final_row``, when given, is the last row's
    metrics object, so overlay writes are visible to the caller.
    """
    stop = False
    for i in range(length):
        step = start_step + 1 + i
        if not any(h.wants_step(step) for h in hooks):
            continue
        if registry is not None:
            registry.counter(telemetry.HOOK_WALKS).inc()
        if i == length - 1 and final_row is not None:
            row = final_row
        else:
            row = LazyMetricRow(stacked_metrics, i, start_step + 1)
        for h in hooks:
            try:
                h.after_step(state, row, step)
            except StopRequested:
                stop = True
        if stop:
            break
    return not stop
