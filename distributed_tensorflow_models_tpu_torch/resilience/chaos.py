"""Deterministic chaos injection: faults on demand, once, at exact positions.

The port's copy of ``distributed_tensorflow_models_tpu/resilience/
chaos.py``: the same keys, positions and fire-once rules.  Two methods
are the port's own: :meth:`ChaosInjector.poison_batch` writes the NaN
into the torch chunk ``fit`` is about to run (``BatchStacker``'s fresh
stack, on the stream the captured step's input copies run on), and
:meth:`ChaosInjector.tear_checkpoint` deletes the files whose absence
``resilience/fsck.py`` reports as a torn write in the port's layout.

The reference has no fault injection anywhere (SURVEY.md §5.3) — its
recovery story was only ever exercised by real preemptions.  This module
makes every failure domain the resilience subsystem handles reproducible
in a tier-1 test (and drillable in production canaries) with four
injection points, all **off by default** and driven by
``ExperimentConfig.chaos`` / ``--chaos``:

- ``pipeline_fail_at_batch=i`` — the dataset's ``assemble`` raises
  :class:`ChaosPipelineError` for the i-th dispatched batch (0-based).
  Injection is marked at ``next_work`` time — the serial cursor — so it
  lands on exactly batch *i* at any ``data_workers`` count, and the
  ordered pipeline surfaces it at exactly position *i*.  *i* counts
  dispatches since process start: exact for the first pipeline of the
  process, but after a mid-process rebuild at a rewound cursor (a
  rollback replay) abandoned lookahead dispatches have consumed indices,
  so an armed-but-unfired fault's position shifts (warned at
  ``set_state`` time) — combine it with the other faults accordingly.
- ``nan_at_step=k`` — the batch feeding train step *k* is poisoned with
  NaN (float tensors only), driving the real NaN-guard path.  Fires on
  the ``chaos_host`` process only (default 0 — single-process runs are
  unaffected): multi-host, the drill is ONE host's shard going bad.
- ``torn_checkpoint_at_step=k`` — after the step-*k* checkpoint is
  durable, its ``COMMITTED`` and ``manifest.json`` are deleted, simulating
  post-finalization damage the restore hardening must walk back over.
- ``sigterm_at_step=k`` — a real SIGTERM is delivered to the process
  after step *k* (via a hook, so the fused loop's chunk ends exactly
  there), driving the preemption-grace path end-to-end.

Cross-host faults target ONE process of a fleet — the one
whose index equals ``chaos_host`` (default 0; set it to pick the
victim).  Drillable from two-process ``launch_local`` runs:

- ``kill_at_step=k`` — the target host SIGKILLs itself after step *k*:
  no grace, no teardown — the supervisor's dead-peer detection and
  fleet restart are what recover.  **Durably at-most-once per
  workdir** (a marker file under ``<workdir>/.chaos_fired/``): unlike
  the in-process faults, the recovery from a kill is a *new process*
  re-traversing step *k*, so per-process memoization would re-kill on
  every restart and the drill would never complete.
- ``hide_newest_ckpt=1`` — the target host's checkpoint *view*
  (``CheckpointManager.all_steps``/``latest_step`` and the restore-walk
  candidates) omits the newest step, simulating cross-host
  storage-visibility skew: the listing lags but reads go through —
  exactly the de-sync chief-decides consensus absorbs (the chief names
  the step; the skewed follower restores it strictly, and the read
  succeeds).
- ``straggler_delay_ms=d`` — the target host sleeps *d* ms in every
  hook walk, slowing the lock-step fleet to its pace: the drill that
  proves delay changes wall time and the ``fleet/*`` gauges, never
  results.

**Once per process per workdir**: injectors are memoized on
``(workdir, spec, seed)`` and each fault fires at most once, so the
recovery that follows — a ``recoverable_fit`` restart, a rollback replay
— re-traverses the same positions *without* re-faulting.  A genuinely
new process (real preemption resume) re-arms, which is exactly the
at-least-once behavior a chaos drill wants.  (``kill_at_step`` is the
one exception — durable at-most-once, above.)

``seed`` is carried for future randomized modes (and keys the memo); the
current injection points are all positional, so runs are bit-reproducible
by construction.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import signal
import threading
from typing import Any, Iterator, Optional

from distributed_tensorflow_models_tpu_torch.resilience import fsck as fscklib

log = logging.getLogger("dtm")


class ChaosPipelineError(ConnectionError):
    """Injected producer failure.  A ``ConnectionError`` subclass on
    purpose: it must look preemption-class to ``recoverable_fit``'s
    default recoverable set, so the drill exercises the real
    restore-and-retry path."""


_FIELDS = (
    "pipeline_fail_at_batch",
    "nan_at_step",
    "torn_checkpoint_at_step",
    "sigterm_at_step",
    "kill_at_step",
    "hide_newest_ckpt",
    "straggler_delay_ms",
    "chaos_host",
)

# Fault fields proper (everything but the cross-host target selector).
_FAULT_FIELDS = tuple(f for f in _FIELDS if f != "chaos_host")


@dataclasses.dataclass(frozen=True)
class ChaosConfig:
    pipeline_fail_at_batch: Optional[int] = None
    nan_at_step: Optional[int] = None
    torn_checkpoint_at_step: Optional[int] = None
    sigterm_at_step: Optional[int] = None
    # Cross-host faults: fire only on the process whose index is
    # ``chaos_host`` (module docstring).
    kill_at_step: Optional[int] = None
    hide_newest_ckpt: Optional[int] = None
    straggler_delay_ms: Optional[int] = None
    chaos_host: int = 0
    seed: int = 0

    @classmethod
    def from_dict(cls, spec: dict, seed: int = 0) -> "ChaosConfig":
        unknown = set(spec) - set(_FIELDS)
        if unknown:
            raise ValueError(
                f"unknown chaos keys {sorted(unknown)}; have {list(_FIELDS)}"
            )
        return cls(seed=seed, **{k: int(v) for k, v in spec.items()})


def parse_chaos_spec(text: str) -> dict[str, int]:
    """``--chaos "nan_at_step=5,sigterm_at_step=9"`` → dict.  Raises
    ValueError (argparse-friendly) on malformed entries or unknown keys."""
    out: dict[str, int] = {}
    for part in text.split(","):
        part = part.strip()
        if not part:
            continue
        key, sep, value = part.partition("=")
        if not sep:
            raise ValueError(f"chaos entry {part!r} is not key=value")
        key = key.strip()
        if key not in _FIELDS:
            raise ValueError(
                f"unknown chaos key {key!r}; have {list(_FIELDS)}"
            )
        try:
            out[key] = int(value)
        except ValueError as e:
            raise ValueError(f"chaos value for {key!r} must be int: {e}")
    return out


class _ChaosMarked:
    """Wrapper tagging the work item whose ``assemble`` must raise."""

    __slots__ = ("work", "index")

    def __init__(self, work, index: int):
        self.work = work
        self.index = index


class _ChaosDataset:
    """Dataset proxy: transparent except for the worker-pool split, where
    ``next_work`` tags the fault batch and ``assemble`` raises on the tag
    — so the fault fires inside the pipeline worker (or the serial
    producer via ``iterate_via_work``), never on the cursor thread, and
    surfaces through the pipeline's ordered error contract."""

    def __init__(self, dataset, injector: "ChaosInjector"):
        self._dataset = dataset
        self._injector = injector

    def __getattr__(self, name):  # get_state/batches_per_epoch/...
        return getattr(self._dataset, name)

    def set_state(self, state) -> None:
        self._dataset.set_state(state)
        inj = self._injector
        if (
            inj.config.pipeline_fail_at_batch is not None
            and not inj._pipeline_fired
            and inj._dispatch_count > 0
        ):
            # A mid-process rebuild (rollback replay / in-process restart)
            # rewound the cursor, but the fault index keeps counting
            # dispatches — including the abandoned lookahead — so the
            # armed fault no longer lands on logical batch i.  Say so
            # rather than let a combined drill silently misfire.
            log.warning(
                "chaos: cursor repositioned with pipeline_fail_at_batch=%d "
                "still armed after %d dispatches — the fault index counts "
                "dispatches since process start (abandoned lookahead "
                "included), so its stream position is no longer exact",
                inj.config.pipeline_fail_at_batch, inj._dispatch_count,
            )

    def next_work(self):
        work = self._dataset.next_work()
        idx = self._injector._next_dispatch_index()
        if self._injector._arm_pipeline_fault(idx):
            return _ChaosMarked(work, idx)
        return work

    def assemble(self, work):
        if isinstance(work, _ChaosMarked):
            log.warning(
                "chaos: failing pipeline assemble at batch %d", work.index
            )
            self._injector._trace_fire(
                "pipeline_fail_at_batch", batch=work.index
            )
            raise ChaosPipelineError(
                f"chaos: injected pipeline failure at batch {work.index}"
            )
        return self._dataset.assemble(work)

    def __iter__(self) -> Iterator:
        # Serial-producer path: the SAME iteration the real datasets use
        # (lazy import — module-level layering stays telemetry-only).
        from distributed_tensorflow_models_tpu_torch.data.datasets import (
            iterate_via_work,
        )

        return iterate_via_work(self)


class _TearAtStep:
    """Duck-typed hook (harness.hooks.Hook protocol, no import) forcing a
    checkpoint at ``torn_checkpoint_at_step`` so the tear always has a
    durable step-k directory to damage.  Without it the fault only fires
    if some save cadence happens to land at exactly step k — with the
    default 600 s clock cadence a drill like ``torn_checkpoint_at_step=500``
    would silently never inject.  The tear itself still runs inside the
    harness save path (``should_tear``/``tear_checkpoint`` after the save
    is durable), so drill and production code share one seam."""

    def __init__(self, injector: "ChaosInjector", step: int, save_fn):
        self._injector = injector
        self._step = step
        self._save_fn = save_fn

    def begin(self, state) -> None: ...

    def wants_step(self, step: int) -> bool:
        return step == self._step and not self._injector._tear_fired

    def after_step(self, state, metrics, step: int) -> None:
        if step == self._step and not self._injector._tear_fired:
            log.warning(
                "chaos: forcing a checkpoint at step %d for the "
                "torn-write injection", step,
            )
            self._save_fn(state, step, force=True)

    def end(self, state) -> None: ...

    def abort(self, state) -> None: ...


class _SigtermAtStep:
    """Duck-typed hook (harness.hooks.Hook protocol, no import — this
    package stays below the harness) delivering a real SIGTERM after its
    step.  ``wants_step`` makes the fused loop end a chunk exactly there,
    so the preemption flag is observed at the very next boundary."""

    def __init__(self, injector: "ChaosInjector", step: int):
        self._injector = injector
        self._step = step

    def begin(self, state) -> None: ...

    def wants_step(self, step: int) -> bool:
        return step == self._step and not self._injector._sigterm_fired

    def after_step(self, state, metrics, step: int) -> None:
        if step == self._step and not self._injector._sigterm_fired:
            self._injector._sigterm_fired = True
            log.warning("chaos: delivering SIGTERM after step %d", step)
            self._injector._trace_fire("sigterm_at_step", step=step)
            signal.raise_signal(signal.SIGTERM)

    def end(self, state) -> None: ...

    def abort(self, state) -> None: ...


class _KillAtStep:
    """Duck-typed hook SIGKILLing the *target host* after step k — the
    ungraceful death (no teardown, no emergency checkpoint) whose
    recovery is the supervisor's dead-peer detection + fleet restart.

    ``wants_step`` must be identical on every host (chunk boundaries
    must match: the steps' collectives run in lock-step), so it keys on
    (step, durable fired-marker) — both fleet-consistent — and the host
    check happens only inside ``after_step``.  The marker is written *before* the
    SIGKILL: a marker with no kill is a skipped drill (visible via the
    unfired audit), a kill with no marker is an infinite kill-loop
    across supervisor restarts."""

    def __init__(self, injector: "ChaosInjector", step: int):
        self._injector = injector
        self._step = step

    def begin(self, state) -> None: ...

    def wants_step(self, step: int) -> bool:
        return step == self._step and not self._injector._kill_fired()

    def after_step(self, state, metrics, step: int) -> None:
        inj = self._injector
        if step != self._step or inj._kill_fired():
            return
        if not inj._on_target_host():
            return
        inj._mark_kill_fired()
        log.warning(
            "chaos: SIGKILLing this process (host %d) after step %d",
            inj.config.chaos_host, step,
        )
        inj._trace_fire("kill_at_step", step=step)
        # SIGKILL allows no teardown — the flight record must be on disk
        # BEFORE the kill or the drill leaves no forensics on the victim.
        fd = inj.flight_dump
        if fd is not None:
            try:
                fd("chaos_kill")
            except Exception:  # noqa: BLE001 — the kill still proceeds
                log.exception("pre-kill flight-record dump failed")
        import os

        os.kill(os.getpid(), signal.SIGKILL)

    def end(self, state) -> None: ...

    def abort(self, state) -> None: ...


class _StragglerDelay:
    """Duck-typed hook sleeping ``delay_s`` in every hook walk on the
    target host — the one-slow-host drill.  ``wants_step`` is True
    uniformly (host-independent, as chunk alignment requires), which
    degrades fused loops to per-step walks on EVERY host — uniform, so
    programs stay in lock-step; the drill measures the fleet slowing to
    the straggler's pace, never a result change."""

    def __init__(self, injector: "ChaosInjector", delay_s: float):
        self._injector = injector
        self._delay = delay_s

    def begin(self, state) -> None: ...

    def wants_step(self, step: int) -> bool:
        return True

    def after_step(self, state, metrics, step: int) -> None:
        inj = self._injector
        if inj._on_target_host():
            if not inj._straggler_fired:
                inj._straggler_fired = True
                log.warning(
                    "chaos: straggler delay %.0f ms/step active on host %d",
                    1000 * self._delay, inj.config.chaos_host,
                )
                inj._trace_fire(
                    "straggler_delay_ms",
                    step=step, delay_ms=1000 * self._delay,
                )
            import time

            time.sleep(self._delay)

    def end(self, state) -> None: ...

    def abort(self, state) -> None: ...


class ChaosInjector:
    """One injector per (workdir, spec, seed); all fired-state lives here
    so recovery replays within the process do not re-fault.
    (``kill_at_step`` alone persists its fired-state to
    ``<scope>/.chaos_fired/`` — the module docstring's durable
    at-most-once.)"""

    def __init__(self, config: ChaosConfig, scope: str = ""):
        self.config = config
        self._scope = scope
        self._lock = threading.Lock()
        self._dispatch_count = 0
        self._pipeline_fired = False
        self._nan_fired = False
        self._tear_fired = False
        self._sigterm_fired = False
        self._kill_fired_mem = False  # fallback when scope is empty
        self._hide_fired = False
        self._straggler_fired = False
        self._process_index: Optional[int] = None
        # Flight-recorder wiring, (re)set by each fit (the injector is
        # memoized across fits on one workdir): ``tracer`` records every
        # fire as a ``chaos/*`` instant on the run's event timeline;
        # ``flight_dump(reason)`` lets the kill fault dump forensics
        # BEFORE the SIGKILL — the one fault whose process cannot dump
        # on the way down.
        self.tracer = None
        self.flight_dump = None

    def _trace_fire(self, fault: str, **args) -> None:
        tr = self.tracer
        if tr is not None:
            try:
                tr.instant(f"chaos/{fault}", args or None)
            except Exception:  # noqa: BLE001 — forensics never fault chaos
                log.exception("chaos trace event failed")

    # -- cross-host targeting ---------------------------------------------

    def _on_target_host(self) -> bool:
        """Is this process the cross-host faults' victim?  Resolved
        lazily (the rank in the default ``torch.distributed`` group, 0
        without one) so single-process unit tests never need a
        cluster."""
        if self._process_index is None:
            try:
                import torch.distributed as dist

                self._process_index = (dist.get_rank()
                                       if dist.is_initialized() else 0)
            except Exception:  # noqa: BLE001 — no backend = process 0
                self._process_index = 0
        return self._process_index == self.config.chaos_host

    # -- pipeline worker fault --------------------------------------------

    def _next_dispatch_index(self) -> int:
        with self._lock:
            idx = self._dispatch_count
            self._dispatch_count += 1
            return idx

    def _arm_pipeline_fault(self, index: int) -> bool:
        target = self.config.pipeline_fail_at_batch
        if target is None or self._pipeline_fired or index != target:
            return False
        self._pipeline_fired = True
        return True

    def wrap_dataset(self, dataset):
        """Interpose the assemble-raise injection point.  Requires the
        worker-pool split (every dataset in ``datasets.py`` has it)."""
        if self.config.pipeline_fail_at_batch is None:
            return dataset
        if not (hasattr(dataset, "next_work") and hasattr(dataset, "assemble")):
            raise ValueError(
                "chaos pipeline_fail_at_batch requires the next_work/"
                f"assemble split, which {type(dataset).__name__} lacks"
            )
        return _ChaosDataset(dataset, self)

    # -- train-step NaN ----------------------------------------------------

    def poison_batch(self, batch, first_step: int, k: int):
        """NaN-poison the row of ``batch`` feeding ``nan_at_step`` when it
        falls in steps ``[first_step, first_step + k)``.  ``batch`` maps
        names to tensors (or numpy arrays); ``k > 1`` means a stacked
        chunk (leading axis = chunk row), whose row is written in place:
        the caller owns it (``fit`` passes ``BatchStacker.next_chunk``'s
        fresh ``torch.stack``, never a buffer the pipeline reuses), and
        the write is queued on the current stream, the one the K-step
        call copies the chunk's rows into the captured step's inputs
        on.  ``k == 1`` poisons the whole batch (a new tensor).  Only
        float tensors are poisoned (integer token streams cannot carry
        NaN — a config pointing chaos at one gets a warning).  Numpy
        arrays are copied before the write.

        Fires only on the ``chaos_host`` process (default 0 — every
        single-process run is its own target): the multi-process drill is
        *one process's* shard going bad, with the fleet-agreed divergence
        verdict — not the fleet-wide NaN of poisoning every shard —
        rolling every process back together."""
        target = self.config.nan_at_step
        if (
            target is None
            or self._nan_fired
            or not first_step <= target < first_step + k
            or not self._on_target_host()
        ):
            return batch
        self._nan_fired = True
        import numpy as np
        import torch

        row = target - first_step
        poisoned_any = False

        def poison(x):
            nonlocal poisoned_any
            if isinstance(x, torch.Tensor):
                if not x.is_floating_point():
                    return x
                poisoned_any = True
                if k > 1:
                    x[row].fill_(float("nan"))
                    return x
                return torch.full_like(x, float("nan"))
            if not np.issubdtype(np.asarray(x).dtype, np.floating):
                return x
            poisoned_any = True
            if k > 1:
                x = np.array(x, copy=True)
                x[row] = np.nan
                return x
            return np.full_like(x, np.nan)

        out = {key: poison(x) for key, x in batch.items()}
        if poisoned_any:
            log.warning("chaos: poisoned the batch for step %d with NaN", target)
            self._trace_fire("nan_at_step", step=target)
        else:
            log.warning(
                "chaos: nan_at_step=%d found no float leaves to poison "
                "(integer-only batch); injection skipped", target,
            )
        return out

    # -- torn checkpoint ---------------------------------------------------

    def should_tear(self, step: int) -> bool:
        return (
            self.config.torn_checkpoint_at_step == step
            and not self._tear_fired
        )

    def tear_checkpoint(self, ckpt_dir: str, step: int) -> None:
        """Damage a *durable* step dir (caller waits for the async save
        first): delete its ``COMMITTED`` marker and manifest — exactly the
        post-finalization torn write ``resilience/fsck.py`` detects (the
        file names come from fsck's own constants, so the drill and the
        detector cannot drift apart)."""
        import os

        if not self.should_tear(step):
            return
        self._tear_fired = True
        self._trace_fire("torn_checkpoint_at_step", step=step)
        step_dir = os.path.join(ckpt_dir, str(step))
        removed = []
        for name in (fscklib.COMMITTED, fscklib.MANIFEST):
            path = os.path.join(step_dir, name)
            if os.path.exists(path):
                os.remove(path)
                removed.append(name)
        log.warning(
            "chaos: tore checkpoint step %d (removed %s from %s)",
            step, removed, step_dir,
        )

    # -- SIGTERM delivery --------------------------------------------------

    def sigterm_hook(self):
        """The hook ``fit`` appends when ``sigterm_at_step`` is set."""
        if self.config.sigterm_at_step is None:
            return None
        return _SigtermAtStep(self, self.config.sigterm_at_step)

    def tear_hook(self, save_fn, *, final_step: int):
        """The hook ``fit`` appends when ``torn_checkpoint_at_step`` is
        set: forces a save at step k so the fault fires under ANY
        checkpoint cadence (``save_fn`` is the harness save path, which
        tears the durable dir via ``should_tear``/``tear_checkpoint``).

        None when k >= ``final_step``: the end-of-run save lands at
        ``final_step`` and tears there itself — a forced tear at the
        final step's *walk* would be silently repaired by that very save
        (``CheckpointManager.save`` replaces torn dirs), leaving the
        drill with nothing to detect."""
        k = self.config.torn_checkpoint_at_step
        if k is None or k >= final_step:
            return None
        return _TearAtStep(self, k, save_fn)

    # -- cross-host: kill -9 -----------------------------------------------

    def _kill_marker(self) -> str:
        import os

        return os.path.join(self._scope, ".chaos_fired", "kill_at_step")

    def _kill_fired(self) -> bool:
        if self._kill_fired_mem:
            return True
        if not self._scope:
            return False
        import os

        return os.path.exists(self._kill_marker())

    def _mark_kill_fired(self) -> None:
        self._kill_fired_mem = True
        if not self._scope:
            return
        import os

        path = self._kill_marker()
        try:
            os.makedirs(os.path.dirname(path), exist_ok=True)
            with open(path, "w") as f:
                f.write(str(self.config.kill_at_step))
                f.flush()
                os.fsync(f.fileno())
        except OSError:  # the kill still proceeds; worst case re-fires
            log.exception("chaos: failed to persist kill fired-marker")

    def kill_hook(self):
        """The hook ``fit`` appends when ``kill_at_step`` is set."""
        if self.config.kill_at_step is None:
            return None
        return _KillAtStep(self, self.config.kill_at_step)

    # -- cross-host: straggler ---------------------------------------------

    def straggler_hook(self):
        """The hook ``fit`` appends when ``straggler_delay_ms`` > 0."""
        if not self.config.straggler_delay_ms:
            return None
        return _StragglerDelay(self, self.config.straggler_delay_ms / 1000.0)

    # -- cross-host: checkpoint-visibility skew ----------------------------

    def step_filter(self):
        """``CheckpointManager`` view filter for ``hide_newest_ckpt``:
        on the target host the newest retained step vanishes from
        listings (``all_steps``/``latest_step``/restore-walk
        candidates) while the files stay readable — metadata lag, the
        real shape of object-store visibility skew.  None when off."""
        if not self.config.hide_newest_ckpt:
            return None

        def _filter(steps):
            steps = list(steps)
            if not steps or not self._on_target_host():
                return steps
            newest = max(steps)
            if not self._hide_fired:
                self._hide_fired = True
                log.warning(
                    "chaos: hiding newest checkpoint step %d from host "
                    "%d's view (visibility-skew simulation)",
                    newest, self.config.chaos_host,
                )
                self._trace_fire("hide_newest_ckpt", step=newest)
            return [s for s in steps if s != newest]

        return _filter

    # -- drill accounting --------------------------------------------------

    def unfired(self) -> list[str]:
        """Configured-but-never-fired faults, as ``key=value`` strings.
        A zero value on the flag-like fields (``hide_newest_ckpt``,
        ``straggler_delay_ms``) means *off*, not armed-at-zero."""
        flags = {
            "pipeline_fail_at_batch": self._pipeline_fired,
            "nan_at_step": self._nan_fired,
            "torn_checkpoint_at_step": self._tear_fired,
            "sigterm_at_step": self._sigterm_fired,
            "kill_at_step": self._kill_fired(),
            "hide_newest_ckpt": self._hide_fired,
            "straggler_delay_ms": self._straggler_fired,
        }
        zero_is_off = ("hide_newest_ckpt", "straggler_delay_ms")
        # Host-targeted faults with purely local fired-state can only be
        # audited on their target host — a non-target process reporting
        # them "unfired" would be a false alarm.  (kill_at_step's
        # durable marker is fleet-wide, so every host audits it.)
        target_only = (
            "hide_newest_ckpt", "straggler_delay_ms", "nan_at_step",
        )
        out = []
        for field in _FAULT_FIELDS:
            value = getattr(self.config, field)
            if value is None or (field in zero_is_off and value == 0):
                continue
            if field in target_only and not self._on_target_host():
                continue
            if not flags[field]:
                out.append(f"{field}={value}")
        return out

    def export_unfired(self, registry) -> None:
        """Set the ``chaos/armed_unfired`` gauge (→ telemetry.json via
        the registry snapshot the goodput report embeds): an exit-0
        drill with this nonzero exercised nothing."""
        from distributed_tensorflow_models_tpu_torch import telemetry

        registry.gauge(telemetry.CHAOS_ARMED_UNFIRED).set(
            float(len(self.unfired()))
        )

    def warn_unfired(self) -> None:
        """End-of-run audit: a drill whose fault never injected must not
        read as a passed drill.  (Expected on recovery replays within one
        process — the fault already fired in an earlier attempt — which
        is why this logs only when the fault NEVER fired.)"""
        pending = self.unfired()
        if pending:
            log.warning(
                "chaos: configured fault(s) never fired: %s — this run "
                "did NOT exercise them (fault position beyond the run's "
                "end?)", ", ".join(pending),
            )


# Injector memo: one per (scope, spec, seed) per process, so restart /
# rollback replays inside one process share fired-state (each fault is
# at-most-once) while distinct runs (different workdirs) stay independent.
_INJECTORS: dict[str, ChaosInjector] = {}
_INJECTORS_LOCK = threading.Lock()


def get_injector(
    spec: Optional[dict[str, Any]], *, seed: int = 0, scope: str = ""
) -> Optional[ChaosInjector]:
    """The harness entry point: None when chaos is off (empty spec)."""
    if not spec:
        return None
    config = ChaosConfig.from_dict(dict(spec), seed=seed)
    key = json.dumps(
        {"scope": scope, "seed": seed, **{f: getattr(config, f) for f in _FIELDS}},
        sort_keys=True,
    )
    with _INJECTORS_LOCK:
        inj = _INJECTORS.get(key)
        if inj is None:
            inj = _INJECTORS[key] = ChaosInjector(config, scope=scope)
            log.warning("chaos injection ACTIVE: %s", config)
        return inj
