"""Continuous deployment: checkpoint following, canarying, rollback.

A copy of ``distributed_tensorflow_models_tpu/serving/deploy.py`` whose
gate reads the port's checkpoints (``harness/checkpoint.py``: the
``params/<name>`` tensors of a step's ``state.pt``) in place of orbax, and
hands the engine the ``{name: tensor}`` mapping ``install_canary`` takes.

The trainer and the server have, until now, only ever met through a cold
start: a replica loads whatever weights it was born with and serves them
until it dies.  This module closes the loop: a
:class:`CheckpointFollower` attached to a live replica watches the
trainer's checkpoint root for newly fleet-valid steps, gates
each candidate BEFORE it touches a live program, canaries the survivor
on a deterministic slice of traffic, and promotes or rolls back on SLO
verdicts — all without a restart or a recompile.

The gate (``gate_candidate``) is the highest-blast-radius defence in the
system: a torn, NaN-poisoned, or aval-drifted checkpoint reaching live
traffic poisons every response until a human notices.  Candidates must
pass, in order:

1. **structural fsck** — ``resilience.fsck.validate_step_dir`` plus the
   fleet-sidecar completeness bar (the same *fleet-valid* standard the
   multi-host restore walk prefers);
2. **finiteness** — every floating leaf finite (the serving twin of
   ``core.train_loop.state_is_finite``, evaluated host-side on the
   restored tensors so the poison never reaches a device program);
3. **signature match** — ``tree_signature`` of the candidate equals the
   live engine's: same names, shapes, dtypes, or the copy into the
   captured programs' parameters could not happen.

Rejections are LOUD: a counter, a ``deploy_events.jsonl`` line, and a
flight-recorder dump per candidate — never a silent skip.

Swap mechanics (why this is zero-downtime *and* zero-recapture): the
engine keeps every live version's tensors on its device, and a dispatch
for another version copies that version's tensors into the decode
model's parameters, whose addresses the captured programs read.  Because
the gate proved name, shape and dtype equality, no program is rebuilt:
``compile_counts()`` stays where it was across install, promote and
rollback.  The follower
runs on the server's worker thread — the same single thread that calls
``scheduler.step()`` — so every swap lands exactly at a burst boundary
by construction.  Requests admitted under version V keep V's weights
via the engine's per-slot version pin until they retire, so an in-flight
stream is byte-identical to a solo ``generate()`` with V's weights no
matter when the swap lands.

Determinism: this module is inside dtm-lint's determinism scope — the
routing decision (which request sees the canary) and every controller
verdict must replay bit-identically from the journal.  Canary routing
hashes the request id with a seeded crc32 (``rid_fraction``); the
process-salted builtin ``hash`` and any wall-clock read are forbidden
here.  All timestamps are passed IN by the caller (``server.py``, which
is outside the scope) — this file never reads a clock.

torch-free at import: the supervisor and the drill parent import this
module to parse journals and drive controllers; torch appears only inside
``load_candidate_params`` and ``check_finite``.
"""

from __future__ import annotations

import json
import os
import zlib
from typing import Dict, List, Optional, Sequence, Tuple

from distributed_tensorflow_models_tpu_torch.resilience import fsck as fscklib
from distributed_tensorflow_models_tpu_torch.telemetry import registry as reglib
from distributed_tensorflow_models_tpu_torch.telemetry import slo as slolib
from distributed_tensorflow_models_tpu_torch.telemetry import trace as tracelib

# Shared journal of deploy transitions (one line per event, O_APPEND so
# every replica in the fleet writes the same file safely).
DEPLOY_EVENTS_NAME = "deploy_events.jsonl"

# Version id of the weights a replica booted with (checkpoint steps are
# >= 1, so 0 never collides with a followed step).
BOOT_VERSION = 0

# Gauge value for "no canary in flight".
NO_CANARY = -1

EVENT_KINDS = (
    "canary_start",
    "promote",
    "rollback",
    "reject",
    "skip",
)


# ---------------------------------------------------------------------------
# Deterministic canary routing
# ---------------------------------------------------------------------------


def rid_fraction(seed: int, rid: str) -> float:
    """Stable per-request uniform in [0, 1) from a seeded rid hash.

    crc32, not ``hash()``: the builtin is salted per process, so two
    replicas (or a replay) would route the same rid differently — the
    exact nondeterminism the canary audit must exclude.  crc32 of
    ``"{seed}:{rid}"`` is cheap, stable across processes and runs, and
    uniform enough for traffic splitting.
    """
    return zlib.crc32(f"{seed}:{rid}".encode()) / 2**32


def route_version(
    seed: int,
    rid: str,
    fraction: float,
    primary: int,
    canary: Optional[int],
) -> int:
    """The weight version request ``rid`` is admitted under.

    Pure: (seed, rid, fraction, live versions) → version, no state, no
    clock — admission-time routing replays bit-identically.
    """
    if canary is None:
        return primary
    return canary if rid_fraction(seed, rid) < fraction else primary


# ---------------------------------------------------------------------------
# Candidate gate: tree signatures, finiteness, checkpoint load
# ---------------------------------------------------------------------------


def _walk_leaves(tree, path: str, out: list) -> None:
    if isinstance(tree, dict):
        for k in sorted(tree):
            _walk_leaves(tree[k], f"{path}/{k}", out)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            _walk_leaves(v, f"{path}/{i}", out)
    elif tree is None:
        return
    else:
        out.append((path, tree))


def tree_signature(tree) -> Tuple[Tuple[str, tuple, str], ...]:
    """``(path, shape, dtype)`` per leaf, sorted — the aval fingerprint.

    Duck-typed on ``.shape``/``.dtype``, so a checkpoint's ``{name:
    tensor}`` mapping and the live engine's produce identical signatures
    without this module importing torch.  Equality of signatures is
    exactly "the swap cannot rebuild a program": every tensor copies into
    a live parameter of the same shape and dtype.
    """
    pairs: list = []
    _walk_leaves(tree, "", pairs)
    sig = []
    for path, leaf in pairs:
        if hasattr(leaf, "shape") and hasattr(leaf, "dtype"):
            shape = tuple(int(d) for d in leaf.shape)
            dtype = str(leaf.dtype)
        else:  # python scalar leaf: no aval, pin the python type
            shape = ()
            dtype = type(leaf).__name__
        sig.append((path, shape, dtype))
    return tuple(sorted(sig))


def signature_diff(
    expected: Sequence[tuple], got: Sequence[tuple]
) -> List[str]:
    """Human-readable aval mismatches (empty = compatible)."""
    exp = {p: (s, d) for p, s, d in expected}
    new = {p: (s, d) for p, s, d in got}
    out: List[str] = []
    for p in sorted(set(exp) - set(new)):
        out.append(f"missing leaf {p} {exp[p][0]}:{exp[p][1]}")
    for p in sorted(set(new) - set(exp)):
        out.append(f"unexpected leaf {p} {new[p][0]}:{new[p][1]}")
    for p in sorted(set(exp) & set(new)):
        if exp[p] != new[p]:
            out.append(
                f"aval drift at {p}: expected {exp[p][0]}:{exp[p][1]}, "
                f"got {new[p][0]}:{new[p][1]}"
            )
    return out


def check_finite(tree) -> List[str]:
    """Paths of non-finite floating leaves (the serving twin of
    ``state_is_finite``, but host-side and per-leaf so the rejection
    names the poisoned tensor).  Leaves are torch tensors (a checkpoint's
    ``params``) or numpy arrays."""
    import numpy as np

    pairs: list = []
    _walk_leaves(tree, "", pairs)
    bad: List[str] = []
    for path, leaf in pairs:
        if not (hasattr(leaf, "shape") and hasattr(leaf, "dtype")):
            continue
        if type(leaf).__module__.startswith("torch"):
            import torch  # noqa: lazy — the journal half stays torch-free

            if not leaf.is_floating_point():
                continue
            if not bool(torch.isfinite(leaf).all()):
                bad.append(path)
            continue
        arr = np.asarray(leaf)
        if not np.issubdtype(arr.dtype, np.floating):
            continue
        if not bool(np.isfinite(arr).all()):
            bad.append(path)
    return bad


def load_candidate_params(step_dir: str) -> dict:
    """The weights of one finalized step (host-side): ``{name: tensor}``
    of the ``params/<name>`` tensors ``harness/checkpoint.py``'s
    :class:`CheckpointManager` wrote into the step's ``state.pt``, loaded
    on the CPU with ``torch.load(..., weights_only=True)``.

    Function-level torch import: the journal/controller half of this
    module must stay importable on torch-free supervisor hosts.
    """
    import torch  # noqa: lazy heavy dep

    flat = torch.load(
        os.path.join(step_dir, fscklib.STATE_FILE), map_location="cpu",
        weights_only=True,
    )
    prefix = "params/"
    params = {k[len(prefix):]: v for k, v in flat.items()
              if k.startswith(prefix)}
    if not params:
        raise ValueError(f"checkpoint at {step_dir} has no 'params' item")
    return params


def fleet_valid(ckpt_dir: str, step: int,
                process_count: Optional[int]) -> bool:
    """The fleet-sidecar bar: every process of ``process_count`` left its
    sidecar at ``step``.  The port's ``CheckpointManager`` writes
    per-process sidecars only with more than one process, so a step of a
    one-process trainer (or an unset count) passes by itself."""
    if process_count is None or process_count <= 1:
        return True
    return fscklib.fleet_sidecars_complete(ckpt_dir, step, process_count)


def gate_candidate(
    ckpt_dir: str,
    step: int,
    *,
    process_count: Optional[int] = None,
    expected_signature: Optional[Sequence[tuple]] = None,
):
    """Full pre-swap admission gate for one candidate step.

    Returns ``(params, reasons, structural)``: ``params`` is the
    restored weight tree on pass (reasons empty), else None with the
    rejection reasons.  ``structural`` marks failures that can be a
    save still landing (torn layout, missing sidecars, restore error) —
    the follower retries those a few polls before rejecting for good;
    semantic failures (non-finite, aval drift) are final immediately.
    """
    step_dir = os.path.join(ckpt_dir, str(step))
    issues = fscklib.validate_step_dir(step_dir)
    if issues:
        return None, [f"fsck: {msg}" for msg in issues], True
    if not fleet_valid(ckpt_dir, step, process_count):
        present = fscklib.sidecar_presence(ckpt_dir, step)
        return (
            None,
            [
                f"not fleet-valid: sidecars {present} do not cover "
                f"process_count={process_count}"
            ],
            True,
        )
    try:
        params = load_candidate_params(step_dir)
    except Exception as e:  # torn torch.save content surfaces here
        return None, [f"restore failed: {e!r}"], True
    bad = check_finite(params)
    if bad:
        return (
            None,
            [f"non-finite leaves: {', '.join(bad[:8])}"
             + (f" (+{len(bad) - 8} more)" if len(bad) > 8 else "")],
            False,
        )
    if expected_signature is not None:
        diff = signature_diff(expected_signature, tree_signature(params))
        if diff:
            return (
                None,
                [f"avals: {msg}" for msg in diff[:8]],
                False,
            )
    return params, [], False


# ---------------------------------------------------------------------------
# Canary verdict state machine
# ---------------------------------------------------------------------------


class CanaryController:
    """warmup → observe → promoted | rolled_back, with hysteresis.

    Clock-free and evaluation-counted like
    :class:`~.admission.AutoscalePolicy`: the caller owns the poll
    cadence, the controller only ever sees ``(samples, breached)``
    pairs, so every verdict replays from the journal.

    - **warmup**: promote evidence does not accrue until the candidate
      has absorbed ``warmup`` samples — its first requests land on cold
      SLO windows and a lucky empty window must not promote.  Breach
      evidence DOES accrue during warmup: a candidate bad enough to
      breach while barely warmed is exactly the one to pull fastest
      (the candidate never recompiles, so there is no cold-start
      transient to forgive — the live program is already compiled).
    - **observe**: ``promote_after`` consecutive healthy evaluations
      promote; ``rollback_after`` consecutive breaching evaluations
      roll back.  Opposite evidence resets the streak (no-flap).
    - terminal states return None forever; one controller per
      candidate, by construction.
    """

    WARMUP = "warmup"
    OBSERVE = "observe"
    PROMOTED = "promoted"
    ROLLED_BACK = "rolled_back"

    def __init__(
        self,
        *,
        warmup: int = 8,
        promote_after: int = 6,
        rollback_after: int = 2,
    ):
        if warmup < 0:
            raise ValueError(f"warmup must be >= 0: {warmup}")
        if promote_after < 1 or rollback_after < 1:
            raise ValueError("promote_after / rollback_after must be >= 1")
        self.warmup = int(warmup)
        self.promote_after = int(promote_after)
        self.rollback_after = int(rollback_after)
        self.state = self.WARMUP if warmup > 0 else self.OBSERVE
        self._ok_streak = 0
        self._breach_streak = 0

    def observe(self, *, samples: int, breached: bool) -> Optional[str]:
        """One evaluation; returns "promote", "rollback", or None."""
        if self.state in (self.PROMOTED, self.ROLLED_BACK):
            return None
        if self.state == self.WARMUP and samples >= self.warmup:
            self.state = self.OBSERVE
        if breached:
            self._breach_streak += 1
            self._ok_streak = 0
        else:
            self._breach_streak = 0
            if self.state == self.OBSERVE:
                self._ok_streak += 1
        if self._breach_streak >= self.rollback_after:
            self.state = self.ROLLED_BACK
            return "rollback"
        if (
            self.state == self.OBSERVE
            and self._ok_streak >= self.promote_after
        ):
            self.state = self.PROMOTED
            return "promote"
        return None


# ---------------------------------------------------------------------------
# Journal helpers
# ---------------------------------------------------------------------------


def deploy_events_path(workdir: str) -> str:
    return os.path.join(workdir, DEPLOY_EVENTS_NAME)


def append_deploy_event(workdir: str, record: dict) -> None:
    """One journal line, written with a single O_APPEND syscall so
    concurrent replicas never interleave mid-line."""
    data = (json.dumps(record) + "\n").encode()
    fd = os.open(
        deploy_events_path(workdir),
        os.O_WRONLY | os.O_CREAT | os.O_APPEND,
        0o644,
    )
    try:
        os.write(fd, data)
    finally:
        os.close(fd)


def load_deploy_events(workdir: str) -> List[dict]:
    """Parse the journal, skipping torn tail lines (crash mid-append)."""
    path = deploy_events_path(workdir)
    try:
        with open(path, "rb") as f:
            lines = f.read().splitlines()
    except OSError:
        return []
    out: List[dict] = []
    for raw in lines:
        try:
            row = json.loads(raw)
        except ValueError:
            continue
        if isinstance(row, dict) and row.get("event") in EVENT_KINDS:
            out.append(row)
    return out


# ---------------------------------------------------------------------------
# The follower
# ---------------------------------------------------------------------------


class CheckpointFollower:
    """Drive one replica's engine to follow the trainer's checkpoints.

    Owned and polled by the server's worker thread (the thread that runs
    ``scheduler.step()``), so every engine mutation — install, promote,
    rollback — lands between bursts.  The follower keeps its OWN
    registry + tracer for forensics (the FleetAutoscaler pattern): the
    flight record dumped at each terminal event carries the evaluation
    instants that led to it, while the replica's public registry gets
    only the deploy counter/gauge family.

    Retry discipline: a *structural* gate failure (torn layout, missing
    sidecars, restore error) is retried for ``reject_after_polls``
    polls — it may be a save still landing — then rejected for good; a
    *semantic* failure (NaN, aval drift) is final on first sight.  While
    a canary is in flight no new step is examined: one candidate at a
    time, and the journal shows every candidate reaching a terminal
    event.
    """

    def __init__(
        self,
        ckpt_dir: str,
        engine,
        *,
        workdir: str,
        process_index: int = 0,
        registry: Optional[reglib.MetricsRegistry] = None,
        process_count: Optional[int] = None,
        canary_fraction: float = 0.25,
        seed: int = 0,
        canary_warmup: int = 8,
        promote_after: int = 6,
        rollback_after: int = 2,
        slo_specs: Sequence = (),
        poll_interval_s: float = 0.25,
        reject_after_polls: int = 4,
        ring_events: int = 512,
    ):
        if not 0.0 <= canary_fraction <= 1.0:
            raise ValueError(
                f"canary_fraction must be in [0, 1]: {canary_fraction}"
            )
        self.ckpt_dir = ckpt_dir
        self.engine = engine
        self.workdir = workdir
        self.process_index = int(process_index)
        self.registry = (
            registry if registry is not None else reglib.get_registry()
        )
        self.process_count = process_count
        self.canary_fraction = float(canary_fraction)
        self.seed = int(seed)
        self.canary_warmup = int(canary_warmup)
        self.promote_after = int(promote_after)
        self.rollback_after = int(rollback_after)
        self.slo_specs = tuple(slo_specs)
        self.poll_interval_s = float(poll_interval_s)
        self.reject_after_polls = int(reject_after_polls)
        self._last_poll = float("-inf")
        self._examined: set = set()  # steps at a terminal event
        self._fail_polls: Dict[int, int] = {}
        self._canary_vid: Optional[int] = None
        self._canary_controller: Optional[CanaryController] = None
        self._canary_monitor: Optional[slolib.SLOMonitor] = None
        self._canary_samples = 0
        self._events = 0
        # Private forensic registry: candidate SLO breach counters and
        # evaluate instants stay out of the replica's public metrics.
        self._registry = reglib.MetricsRegistry()
        self._registry.trace = tracelib.Tracer(ring_events)
        # Public deploy family is full-set-or-absent: pre-create so an
        # attached-but-idle follower reports zeros.
        self.registry.counter(reglib.SERVE_DEPLOY_SWAPS)
        self.registry.counter(reglib.SERVE_DEPLOY_ROLLBACKS)
        self.registry.counter(reglib.SERVE_DEPLOY_REJECTED)
        self.registry.gauge(reglib.SERVE_VERSION_ACTIVE).set(
            getattr(engine, "version", BOOT_VERSION)
        )
        self.registry.gauge(reglib.SERVE_VERSION_CANARY).set(NO_CANARY)

    # -- routing (called by the scheduler at admission) --------------------

    @property
    def canary_vid(self) -> Optional[int]:
        return self._canary_vid

    def route(self, rid: str) -> int:
        """Version request ``rid`` is admitted under (pure, replayable)."""
        return route_version(
            self.seed,
            rid,
            self.canary_fraction,
            self.engine.version,
            self._canary_vid,
        )

    # -- telemetry taps (called by the scheduler) --------------------------

    def observe_sample(
        self, vid: int, key: str, value: float, now: float
    ) -> None:
        """Feed one candidate-version latency sample into the canary's
        SLO windows (no-op for primary traffic or unwatched keys)."""
        monitor = self._canary_monitor
        if monitor is None or vid != self._canary_vid:
            return
        if key not in monitor.keys:
            return
        monitor.observe(key, value, now)
        self._canary_samples += 1

    # -- journal + forensics -----------------------------------------------

    def _journal(self, event: str, now_wall: float, **fields) -> dict:
        record = {
            "ts_wall": now_wall,
            "proc": self.process_index,
            "event": event,
            **fields,
        }
        append_deploy_event(self.workdir, record)
        self._registry.trace.instant(f"deploy/{event}", dict(record))
        if event in ("reject", "promote", "rollback", "canary_start"):
            self._registry.trace.dump_flight_record(
                os.path.join(
                    self.workdir,
                    f"flight_deploy_p{self.process_index}_"
                    f"{self._events}.json",
                ),
                f"deploy_{event}",
                registry=self._registry,
            )
            self._events += 1
        return record

    def _reject(
        self, step: int, reasons: List[str], now_wall: float
    ) -> dict:
        self._examined.add(step)
        self._fail_polls.pop(step, None)
        self.registry.counter(reglib.SERVE_DEPLOY_REJECTED).inc()
        return self._journal(
            "reject", now_wall, step=step, reasons=list(reasons)
        )

    # -- canary lifecycle --------------------------------------------------

    def _start_canary(self, step: int, params, now_wall: float) -> dict:
        self.engine.install_canary(step, params)
        self._canary_vid = step
        self._canary_controller = CanaryController(
            warmup=self.canary_warmup,
            promote_after=self.promote_after,
            rollback_after=self.rollback_after,
        )
        # breach_after/recover_after of 1: the controller owns all
        # hysteresis — the monitor only turns windows into raw verdicts.
        self._canary_monitor = slolib.SLOMonitor(
            self.slo_specs,
            self._registry,
            eval_interval_s=0.0,
            breach_after=1,
            recover_after=1,
            warmup_samples=0,
        )
        self._canary_samples = 0
        self.registry.gauge(reglib.SERVE_VERSION_CANARY).set(step)
        return self._journal(
            "canary_start",
            now_wall,
            step=step,
            fraction=self.canary_fraction,
            warmup=self.canary_warmup,
            promote_after=self.promote_after,
            rollback_after=self.rollback_after,
        )

    def _end_canary(self) -> None:
        self._canary_vid = None
        self._canary_controller = None
        self._canary_monitor = None
        self._canary_samples = 0
        self.registry.gauge(reglib.SERVE_VERSION_CANARY).set(NO_CANARY)

    def _evaluate_canary(self, now: float, now_wall: float) -> List[dict]:
        step = self._canary_vid
        monitor = self._canary_monitor
        controller = self._canary_controller
        assert step is not None and monitor and controller
        monitor.evaluate(now, force=True)
        breached = bool(monitor.breached())
        verdict = controller.observe(
            samples=self._canary_samples, breached=breached
        )
        self._registry.trace.instant(
            "deploy/evaluate",
            {
                "step": step,
                "state": controller.state,
                "samples": self._canary_samples,
                "breached": sorted(monitor.breached()),
                "margins": monitor.margins(),
                "verdict": verdict,
            },
        )
        if verdict is None:
            return []
        self._examined.add(step)
        if verdict == "promote":
            old = self.engine.promote_canary()
            self.registry.counter(reglib.SERVE_DEPLOY_SWAPS).inc()
            self.registry.gauge(reglib.SERVE_VERSION_ACTIVE).set(step)
            record = self._journal(
                "promote",
                now_wall,
                step=step,
                from_version=old,
                samples=self._canary_samples,
                margins=monitor.margins(),
            )
        else:
            self.engine.rollback_canary()
            self.registry.counter(reglib.SERVE_DEPLOY_ROLLBACKS).inc()
            record = self._journal(
                "rollback",
                now_wall,
                step=step,
                keep_version=self.engine.version,
                samples=self._canary_samples,
                breached=sorted(monitor.breached()),
                margins=monitor.margins(),
            )
        self._end_canary()
        return [record]

    # -- checkpoint scan ---------------------------------------------------

    def _new_steps(self) -> List[int]:
        """Unexamined finalized-looking steps newer than the primary
        (in-flight ``<step>.tmp-*`` dirs are not digit-named, so a bare
        listdir never sees a half-renamed step)."""
        try:
            names = os.listdir(self.ckpt_dir)
        except OSError:
            return []
        floor = self.engine.version
        steps = []
        for name in names:
            if not name.isdigit():
                continue
            step = int(name)
            if step <= floor or step in self._examined:
                continue
            if not os.path.isdir(os.path.join(self.ckpt_dir, name)):
                continue
            steps.append(step)
        return sorted(steps)

    def _scan(self, now_wall: float) -> List[dict]:
        steps = self._new_steps()
        if not steps:
            return []
        events: List[dict] = []
        # Structural pre-check on EVERY new step so torn candidates are
        # rejected loudly instead of silently shadowed by a newer save.
        structurally_ok: List[int] = []
        for step in steps:
            step_dir = os.path.join(self.ckpt_dir, str(step))
            issues = fscklib.validate_step_dir(step_dir)
            if not issues:
                if not fleet_valid(self.ckpt_dir, step, self.process_count):
                    issues = [
                        "not fleet-valid for process_count="
                        f"{self.process_count}"
                    ]
            if issues:
                fails = self._fail_polls.get(step, 0) + 1
                self._fail_polls[step] = fails
                if fails >= self.reject_after_polls:
                    events.append(
                        self._reject(
                            step,
                            [f"fsck: {m}" for m in issues],
                            now_wall,
                        )
                    )
            else:
                structurally_ok.append(step)
        if not structurally_ok:
            return events
        # Follow the NEWEST structurally-valid step; older ones were
        # superseded before this replica ever saw them — journal the
        # skip so the timeline shows why they never canaried.
        candidate = structurally_ok[-1]
        for step in structurally_ok[:-1]:
            self._examined.add(step)
            self._fail_polls.pop(step, None)
            events.append(
                self._journal(
                    "skip", now_wall, step=step, superseded_by=candidate
                )
            )
        params, reasons, structural = gate_candidate(
            self.ckpt_dir,
            candidate,
            process_count=self.process_count,
            expected_signature=tree_signature(self.engine.params),
        )
        if params is None:
            if structural:
                fails = self._fail_polls.get(candidate, 0) + 1
                self._fail_polls[candidate] = fails
                if fails >= self.reject_after_polls:
                    events.append(
                        self._reject(candidate, reasons, now_wall)
                    )
            else:  # NaN / aval drift: final on first sight
                events.append(self._reject(candidate, reasons, now_wall))
            return events
        self._fail_polls.pop(candidate, None)
        events.append(self._start_canary(candidate, params, now_wall))
        return events

    # -- the worker-thread entry point -------------------------------------

    def poll(self, now: float, now_wall: float) -> List[dict]:
        """One rate-limited follower tick; returns the journal records
        appended this tick.  ``now`` is monotonic (SLO windows / rate
        limit), ``now_wall`` stamps the journal — both passed in by the
        caller so this module never reads a clock."""
        if now - self._last_poll < self.poll_interval_s:
            return []
        self._last_poll = now
        if self._canary_vid is not None:
            return self._evaluate_canary(now, now_wall)
        return self._scan(now_wall)
