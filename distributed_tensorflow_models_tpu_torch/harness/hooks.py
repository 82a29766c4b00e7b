"""Training hooks: the reference's session-hook set, step-callback style.

The port's copy of the part of ``distributed_tensorflow_models_tpu/
harness/hooks.py`` that the chunked loop of ``fit`` needs: the ``Hook``
protocol (with ``wants_step``), :class:`LazyMetricRow`, the stop, step
counter, NaN guard, logging, metric-writer, checkpoint and
fault-injection hooks, and the two walks.  The logic is the JAX
package's; device values are read with torch, and the checkpoint hook's
multi-process clock poll goes through ``resilience/consensus.py``.

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
