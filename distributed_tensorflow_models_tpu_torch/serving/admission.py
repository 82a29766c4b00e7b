"""Admission-control and autoscale decision logic for the serving stack.

Overload protection is three separate decisions, and this module keeps
all three PURE — no clocks read, no threads, no I/O — so they unit-test
as arithmetic and the scheduler/supervisor layers stay thin:

1. **Priority classes** (:class:`AdmissionPolicy`).  Every request
   carries a class name; admission serves the highest class first (FIFO
   within a class, so TTFT stays arrival-ordered *per class* and a
   class can never starve itself).  Classes are ordered lowest →
   highest priority at construction.
2. **Shedding** (:class:`AdmissionPolicy`).  Two triggers, both
   producing a *response* (``finish_reason="shed"``), never a silent
   drop: a per-request TTFT deadline (the request is worthless after
   its deadline — answering it late wastes arena pages a live request
   needs), and an SLO breach (the SLO monitor says the fleet is out
   of SLO → shed the lowest class first to protect the classes that
   matter).  ``shed_quota`` bounds sheds per scheduler iteration so one
   breached evaluation can't mass-evict the queue.
3. **Backpressure** (:class:`BackpressureGate`).  Intake pauses BEFORE
   the arena exhausts — engage/release thresholds on free KV blocks
   and queue depth form a hysteresis band, so the gate doesn't chatter
   at the boundary; episodes (engagements) are counted, not samples.
4. **Autoscale** (:class:`AutoscalePolicy`).  Per-replica backlog over
   consecutive evaluations decides scale-up/scale-down with the same
   episode-style hysteresis the SLO monitor uses (``up_after`` /
   ``down_after`` consecutive evaluations) plus a post-decision
   cooldown, so a single spike can't flap the fleet.

Design constraints (mirroring ``telemetry/slo.py``):

- **torch-free, stdlib-only.**  The supervisor (``launch.py``) imports
  this for its fleet controller; importing it must never pull in torch.
- **No clock reads.**  Deadline math takes explicit ``now`` /
  ``t_submit`` stamps (the scheduler's ``time.perf_counter`` frame);
  wall-clock sampling here would make shed decisions unreplayable and
  is a determinism-hazard under dtm-lint (this module is in the lint's
  determinism scope).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

__all__ = [
    "DEFAULT_CLASSES",
    "AdmissionPolicy",
    "BackpressureGate",
    "AutoscalePolicy",
]

# Lowest → highest priority.  "batch" sheds first, "interactive" last.
DEFAULT_CLASSES: Tuple[str, ...] = ("batch", "standard", "interactive")


class AdmissionPolicy:
    """Priority ordering + shed rules (pure; the scheduler executes).

    ``classes`` is ordered lowest → highest priority; ``default``
    (middle class unless given) is what a request that names no class
    gets.  ``shed_on_slo`` lists SLO *names* (see ``telemetry/slo.py``)
    whose breach triggers load shedding; ``max_shed_per_step`` bounds
    how many waiters one scheduler iteration may shed on that trigger
    (deadline sheds are not quota-bound — an overdue request is dead
    weight regardless of pacing).
    """

    def __init__(
        self,
        classes: Sequence[str] = DEFAULT_CLASSES,
        *,
        default: Optional[str] = None,
        shed_on_slo: Sequence[str] = (),
        max_shed_per_step: int = 1,
    ):
        classes = tuple(classes)
        if not classes:
            raise ValueError("need at least one priority class")
        if len(set(classes)) != len(classes):
            raise ValueError(f"duplicate priority class in {classes!r}")
        for c in classes:
            if not c or "/" in c:
                raise ValueError(
                    f"class names must be non-empty, slash-free "
                    f"(they become serve/shed/<class> keys): {c!r}"
                )
        if max_shed_per_step < 1:
            raise ValueError(
                f"max_shed_per_step must be >= 1, got {max_shed_per_step}"
            )
        self.classes = classes
        self.default = default if default is not None else (
            classes[(len(classes) - 1) // 2]
        )
        if self.default not in classes:
            raise ValueError(
                f"default class {self.default!r} not in {classes!r}"
            )
        self.shed_on_slo = tuple(shed_on_slo)
        self.max_shed_per_step = int(max_shed_per_step)
        self._rank = {c: i for i, c in enumerate(classes)}

    def rank(self, cls: str) -> int:
        """Admission rank of ``cls`` (higher = served first); raises
        ``ValueError`` for unknown classes — rejecting at the door
        beats silently misfiling into some default bucket."""
        try:
            return self._rank[cls]
        except KeyError:
            raise ValueError(
                f"unknown priority class {cls!r} (have {self.classes})"
            ) from None

    def resolve(self, cls: Optional[str]) -> str:
        """Map an optional request-carried class to a concrete one."""
        if cls is None or cls == "":
            return self.default
        self.rank(cls)  # validate
        return cls

    def overdue(
        self, t_submit: float, deadline_s: Optional[float], now: float
    ) -> bool:
        """Deadline math: True when the request has waited past its
        TTFT deadline (both stamps in the same monotonic frame)."""
        if deadline_s is None:
            return False
        return (now - t_submit) > deadline_s

    def shed_quota(self, breached: Sequence[str]) -> int:
        """How many waiters this iteration may shed for SLO pressure:
        ``max_shed_per_step`` while any configured SLO name is in
        ``breached``, else 0."""
        if not self.shed_on_slo:
            return 0
        if any(name in self.shed_on_slo for name in breached):
            return self.max_shed_per_step
        return 0


class BackpressureGate:
    """Hysteresis gate that pauses intake before the arena exhausts.

    Engage when free KV blocks drop TO/below ``engage_blocks_free`` or
    queue depth rises TO/above ``engage_queue_depth``; release only
    when blocks recover past ``release_blocks_free`` AND the queue
    drains below ``release_queue_depth``.  The release thresholds must
    be strictly easier than the engage thresholds so the gate has a
    real band to cross — a gate that engages and releases at the same
    value chatters every sample.  Either signal may be disabled
    (``None``).  ``episodes`` counts engage *transitions*.
    """

    def __init__(
        self,
        *,
        engage_blocks_free: Optional[int] = None,
        release_blocks_free: Optional[int] = None,
        engage_queue_depth: Optional[int] = None,
        release_queue_depth: Optional[int] = None,
    ):
        if (engage_blocks_free is None) != (release_blocks_free is None):
            raise ValueError(
                "engage_blocks_free and release_blocks_free go together"
            )
        if (engage_queue_depth is None) != (release_queue_depth is None):
            raise ValueError(
                "engage_queue_depth and release_queue_depth go together"
            )
        if engage_blocks_free is None and engage_queue_depth is None:
            raise ValueError("backpressure gate needs at least one signal")
        if (
            engage_blocks_free is not None
            and release_blocks_free <= engage_blocks_free
        ):
            raise ValueError(
                f"release_blocks_free ({release_blocks_free}) must exceed "
                f"engage_blocks_free ({engage_blocks_free}) — the "
                "hysteresis band"
            )
        if (
            engage_queue_depth is not None
            and release_queue_depth >= engage_queue_depth
        ):
            raise ValueError(
                f"release_queue_depth ({release_queue_depth}) must be "
                f"below engage_queue_depth ({engage_queue_depth}) — the "
                "hysteresis band"
            )
        self.engage_blocks_free = engage_blocks_free
        self.release_blocks_free = release_blocks_free
        self.engage_queue_depth = engage_queue_depth
        self.release_queue_depth = release_queue_depth
        self.engaged = False
        self.episodes = 0

    def update(self, *, blocks_free: int, queue_depth: int) -> bool:
        """Feed one sample of both signals; returns the gate state."""
        blocks_low = (
            self.engage_blocks_free is not None
            and blocks_free <= self.engage_blocks_free
        )
        queue_high = (
            self.engage_queue_depth is not None
            and queue_depth >= self.engage_queue_depth
        )
        if not self.engaged:
            if blocks_low or queue_high:
                self.engaged = True
                self.episodes += 1
        else:
            blocks_ok = (
                self.engage_blocks_free is None
                or blocks_free >= self.release_blocks_free
            )
            queue_ok = (
                self.engage_queue_depth is None
                or queue_depth <= self.release_queue_depth
            )
            if blocks_ok and queue_ok:
                self.engaged = False
        return self.engaged


class AutoscalePolicy:
    """Closed-loop replica-count decisions with episode hysteresis.

    Fed one evaluation at a time (``observe``), returns the replica
    delta to apply *now*: +1, -1, or 0.  The load signal is backlog
    (requests offered minus served, fleet-wide) normalized per live
    replica; an SLO breach counts as high load regardless of backlog.
    A decision needs ``up_after`` / ``down_after`` CONSECUTIVE
    qualifying evaluations (episodes, exactly like the SLO monitor's
    ``breach_after``), and after any decision ``cooldown`` evaluations
    are skipped outright — the fleet's response to the last decision
    must land in the telemetry before the next one is considered, or a
    single spike scales up, observes its own transient, and flaps.
    Evaluations, not seconds: the caller owns the poll cadence, so the
    policy stays clock-free and replayable.
    """

    def __init__(
        self,
        *,
        min_replicas: int = 1,
        max_replicas: int = 4,
        up_backlog: float = 4.0,
        down_backlog: float = 1.0,
        up_after: int = 2,
        down_after: int = 4,
        cooldown: int = 4,
    ):
        if min_replicas < 1:
            raise ValueError(f"min_replicas must be >= 1: {min_replicas}")
        if max_replicas < min_replicas:
            raise ValueError(
                f"max_replicas ({max_replicas}) < min_replicas "
                f"({min_replicas})"
            )
        if down_backlog >= up_backlog:
            raise ValueError(
                f"down_backlog ({down_backlog}) must be below up_backlog "
                f"({up_backlog}) — the hysteresis band"
            )
        if up_after < 1 or down_after < 1:
            raise ValueError("up_after / down_after must be >= 1")
        if cooldown < 0:
            raise ValueError(f"cooldown must be >= 0: {cooldown}")
        self.min_replicas = int(min_replicas)
        self.max_replicas = int(max_replicas)
        self.up_backlog = float(up_backlog)
        self.down_backlog = float(down_backlog)
        self.up_after = int(up_after)
        self.down_after = int(down_after)
        self.cooldown = int(cooldown)
        self._up_streak = 0
        self._down_streak = 0
        self._cooldown_left = 0

    def observe(
        self,
        *,
        replicas: int,
        backlog: float,
        slo_breached: bool = False,
    ) -> int:
        """One evaluation; returns the replica delta (+1 / -1 / 0)."""
        if replicas < 1:
            raise ValueError(f"replicas must be >= 1: {replicas}")
        if self._cooldown_left > 0:
            # Streaks do not accrue during cooldown: evidence gathered
            # while the last decision is still settling is the last
            # decision's transient, not a new signal.
            self._cooldown_left -= 1
            self._up_streak = 0
            self._down_streak = 0
            return 0
        load = float(backlog) / float(replicas)
        if slo_breached or load > self.up_backlog:
            self._up_streak += 1
            self._down_streak = 0
        elif load < self.down_backlog:
            self._down_streak += 1
            self._up_streak = 0
        else:
            # Inside the band: neither direction accumulates evidence.
            self._up_streak = 0
            self._down_streak = 0
        if self._up_streak >= self.up_after and replicas < self.max_replicas:
            self._up_streak = 0
            self._down_streak = 0
            self._cooldown_left = self.cooldown
            return 1
        if (
            self._down_streak >= self.down_after
            and replicas > self.min_replicas
        ):
            self._up_streak = 0
            self._down_streak = 0
            self._cooldown_left = self.cooldown
            return -1
        return 0
