"""Declarative rolling-window SLO monitor for the serving stack.

The registry's :class:`~.registry.Timer` reservoir answers "what were
latencies like over the run" — an SLO asks a different question: "is the
pXX of metric K over the last W seconds under threshold T *right now*?"
This module evaluates exactly that, over bounded timestamped sample
windows, and turns transitions into telemetry:

- ``serve/slo_breach/<name>`` counter — breach *episodes* (hysteresis-
  debounced), not breaching evaluations.  A 40 s stall is one breach.
- ``serve/slo_margin/<name>`` gauge — ``threshold − observed`` at the
  last evaluation; negative while out of SLO, and how negative is how
  far out.
- trace instants ``serve/slo_breach`` / ``serve/slo_recovered`` on each
  state transition, so the flight recorder shows breach onset against
  the per-request waterfall that caused it.

Hysteresis: a spec must fail ``breach_after`` consecutive evaluations to
enter breach and pass ``recover_after`` consecutive ones to leave, so a
single reservoir outlier doesn't flap the pager.

Design constraints (mirroring registry.py):

1. **torch-free, stdlib-only.**  The supervisor and the torch-free server
   front half both read this; importing it must never pull in torch.
2. **perf_counter only.**  Windows are keyed on the monotonic clock —
   wall-clock sampling here would corrupt windows across NTP steps and
   is a determinism-hazard under dtm-lint (this module is in the lint's
   determinism scope).
3. **Hot-path cost.**  ``observe`` is one deque append (amortized one
   pop); percentile sorting happens only inside rate-limited
   ``evaluate`` calls.

Spec syntax (``parse_slo_spec``)::

    [name=]<metric key>:p<QQ><<threshold>@<window>s

    serve/ttft_s:p99<0.25@30s           # name defaults to "ttft_s_p99"
    ttft=serve/ttft_s:p99<0.25@30s      # explicit name
"""

from __future__ import annotations

import re
import time
from collections import deque
from dataclasses import dataclass
from typing import Deque, Dict, Iterable, List, Optional, Sequence, Tuple, Union

from distributed_tensorflow_models_tpu_torch.telemetry import registry as reglib

# Trace instant names for state transitions (not registry metric keys).
BREACH_INSTANT = "serve/slo_breach"
RECOVERY_INSTANT = "serve/slo_recovered"

DEFAULT_MAX_SAMPLES = 2048


@dataclass(frozen=True)
class SLOSpec:
    """One declarative objective: pXX of ``key`` over ``window_s`` stays
    under ``threshold``."""

    name: str
    key: str  # metric key whose samples feed the window (e.g. serve/ttft_s)
    percentile: float  # quantile in (0, 1), e.g. 0.99
    threshold: float  # breach when window percentile exceeds this
    window_s: float  # rolling window length, seconds

    def __post_init__(self):
        if not self.name or "/" in self.name:
            raise ValueError(f"SLO name must be non-empty, slash-free: {self.name!r}")
        if not 0.0 < self.percentile < 1.0:
            raise ValueError(f"percentile must be in (0, 1): {self.percentile}")
        if self.threshold <= 0.0:
            raise ValueError(f"threshold must be positive: {self.threshold}")
        if self.window_s <= 0.0:
            raise ValueError(f"window_s must be positive: {self.window_s}")


_SPEC_RE = re.compile(
    r"^(?:(?P<name>[A-Za-z0-9_.-]+)=)?"
    r"(?P<key>[A-Za-z0-9_./-]+)"
    r":p(?P<q>\d+(?:\.\d+)?)"
    r"<(?P<thr>[0-9.eE+-]+)"
    r"@(?P<win>[0-9.]+)s?$"
)


def parse_slo_spec(text: str) -> SLOSpec:
    """Parse ``[name=]key:pQQ<threshold@WINDOWs`` into an :class:`SLOSpec`.

    ``pQQ`` is the percentile as a percentage (``p99`` → 0.99, ``p99.9``
    → 0.999).  The name defaults to ``<key basename>_p<QQ>`` with dots
    flattened (``serve/ttft_s:p99<…`` → ``ttft_s_p99``).
    """
    m = _SPEC_RE.match(text.strip())
    if m is None:
        raise ValueError(
            f"bad SLO spec {text!r} (want [name=]key:pQQ<threshold@WINDOWs, "
            f"e.g. serve/ttft_s:p99<0.25@30s)"
        )
    qtext = m.group("q")
    q = float(qtext) / 100.0
    name = m.group("name")
    if name is None:
        base = m.group("key").rsplit("/", 1)[-1]
        name = f"{base}_p{qtext}".replace(".", "_")
    return SLOSpec(
        name=name,
        key=m.group("key"),
        percentile=q,
        threshold=float(m.group("thr")),
        window_s=float(m.group("win")),
    )


class RollingWindow:
    """Bounded deque of ``(t_mono, value)`` samples with time pruning.

    Percentiles use the same nearest-rank rule as ``Timer.percentiles``
    (``ordered[min(n-1, int(q*n))]``) so a window covering the whole run
    agrees with the registry's reservoir view sample-for-sample.
    """

    __slots__ = ("window_s", "max_samples", "_samples")

    def __init__(self, window_s: float, max_samples: int = DEFAULT_MAX_SAMPLES):
        if window_s <= 0.0:
            raise ValueError(f"window_s must be positive: {window_s}")
        if max_samples < 1:
            raise ValueError(f"max_samples must be >= 1: {max_samples}")
        self.window_s = float(window_s)
        self.max_samples = int(max_samples)
        self._samples: Deque[Tuple[float, float]] = deque()

    def observe(self, value: float, t: Optional[float] = None) -> None:
        if t is None:
            t = time.perf_counter()
        self._samples.append((t, float(value)))
        if len(self._samples) > self.max_samples:
            self._samples.popleft()

    def prune(self, now: float) -> None:
        cutoff = now - self.window_s
        samples = self._samples
        while samples and samples[0][0] < cutoff:
            samples.popleft()

    def __len__(self) -> int:
        return len(self._samples)

    def percentile(self, q: float, now: Optional[float] = None) -> Optional[float]:
        """Nearest-rank percentile of in-window samples; None when empty."""
        if now is None:
            now = time.perf_counter()
        self.prune(now)
        if not self._samples:
            return None
        ordered = sorted(v for _, v in self._samples)
        n = len(ordered)
        return ordered[min(n - 1, int(q * n))]


class _SLOState:
    __slots__ = (
        "spec", "window", "breached", "breach_streak", "ok_streak",
        "last_margin",
    )

    def __init__(self, spec: SLOSpec, max_samples: int):
        self.spec = spec
        self.window = RollingWindow(spec.window_s, max_samples)
        self.breached = False
        self.breach_streak = 0
        self.ok_streak = 0
        self.last_margin = spec.threshold  # pre-eval: full headroom


class SLOMonitor:
    """Evaluate a set of :class:`SLOSpec` over rolling sample windows.

    Single-writer (the scheduler's worker thread observes and evaluates);
    readers see state through the registry.  Breach/margin metrics are
    pre-created at construction so an idle-but-monitored server reports
    zeros — the full-set-or-absent contract check_metrics_schema's
    ``--serving-report`` mode enforces.

    ``warmup_samples`` drops the first K observations per metric key:
    cold-start samples (first-dispatch XLA compiles land in the first
    requests' TTFT) would otherwise pin a short window's p99 for the
    whole window and breach any steady-state threshold.
    """

    def __init__(
        self,
        specs: Sequence[Union[SLOSpec, str]],
        registry: Optional[reglib.MetricsRegistry] = None,
        *,
        eval_interval_s: float = 0.25,
        breach_after: int = 3,
        recover_after: int = 3,
        warmup_samples: int = 0,
        max_samples: int = DEFAULT_MAX_SAMPLES,
    ):
        if breach_after < 1 or recover_after < 1:
            raise ValueError("breach_after / recover_after must be >= 1")
        self.registry = registry if registry is not None else reglib.get_registry()
        self.eval_interval_s = float(eval_interval_s)
        self.breach_after = int(breach_after)
        self.recover_after = int(recover_after)
        self.warmup_samples = int(warmup_samples)
        self._states: List[_SLOState] = []
        self._by_key: Dict[str, List[_SLOState]] = {}
        self._warmup_left: Dict[str, int] = {}
        self._last_eval = float("-inf")
        seen: set = set()
        for spec in specs:
            if isinstance(spec, str):
                spec = parse_slo_spec(spec)
            if spec.name in seen:
                raise ValueError(f"duplicate SLO name: {spec.name!r}")
            seen.add(spec.name)
            state = _SLOState(spec, max_samples)
            self._states.append(state)
            self._by_key.setdefault(spec.key, []).append(state)
            self._warmup_left.setdefault(spec.key, self.warmup_samples)
            # Pre-create the full metric set (zeros until something happens).
            self.registry.counter(f"{reglib.SERVE_SLO_BREACH}/{spec.name}")
            self.registry.gauge(f"{reglib.SERVE_SLO_MARGIN}/{spec.name}").set(
                spec.threshold
            )

    @property
    def specs(self) -> Tuple[SLOSpec, ...]:
        return tuple(s.spec for s in self._states)

    @property
    def keys(self) -> Tuple[str, ...]:
        """Metric keys some spec watches (callers can skip observe() for
        anything else)."""
        return tuple(self._by_key)

    def observe(self, key: str, value: float, t: Optional[float] = None) -> None:
        """Feed one sample of ``key`` (no-op for unwatched keys)."""
        states = self._by_key.get(key)
        if not states:
            return
        left = self._warmup_left[key]
        if left > 0:
            self._warmup_left[key] = left - 1
            return
        if t is None:
            t = time.perf_counter()
        for state in states:
            state.window.observe(value, t)

    def evaluate(
        self, now: Optional[float] = None, *, force: bool = False
    ) -> List[dict]:
        """Rate-limited evaluation pass; returns state *transitions*.

        Each transition dict: ``{"slo", "event" ("breach"|"recovery"),
        "observed", "threshold", "percentile"}``.  An empty window counts
        as in-SLO (idle traffic mid-breach ages the breach out).
        """
        if now is None:
            now = time.perf_counter()
        if not force and now - self._last_eval < self.eval_interval_s:
            return []
        self._last_eval = now
        transitions: List[dict] = []
        trace = self.registry.trace
        for state in self._states:
            spec = state.spec
            observed = state.window.percentile(spec.percentile, now)
            margin = (
                spec.threshold if observed is None else spec.threshold - observed
            )
            state.last_margin = margin
            self.registry.gauge(f"{reglib.SERVE_SLO_MARGIN}/{spec.name}").set(margin)
            breaching = observed is not None and observed > spec.threshold
            if breaching:
                state.breach_streak += 1
                state.ok_streak = 0
            else:
                state.ok_streak += 1
                state.breach_streak = 0
            args = {
                "slo": spec.name,
                "key": spec.key,
                "percentile": spec.percentile,
                "observed": observed,
                "threshold": spec.threshold,
                "window_s": spec.window_s,
            }
            if not state.breached and state.breach_streak >= self.breach_after:
                state.breached = True
                self.registry.counter(f"{reglib.SERVE_SLO_BREACH}/{spec.name}").inc()
                trace.instant(BREACH_INSTANT, dict(args))
                transitions.append({"event": "breach", **args})
            elif state.breached and state.ok_streak >= self.recover_after:
                state.breached = False
                trace.instant(RECOVERY_INSTANT, dict(args))
                transitions.append({"event": "recovery", **args})
        return transitions

    def breached(self) -> Tuple[str, ...]:
        """Names of SLOs currently in breach state."""
        return tuple(s.spec.name for s in self._states if s.breached)

    def margins(self) -> Dict[str, float]:
        """Last evaluated margin (threshold − observed) per SLO name —
        the headroom signal admission shedding and the fleet autoscaler
        consume without re-sorting any window (negative = out of SLO,
        and how negative is how far out)."""
        return {s.spec.name: s.last_margin for s in self._states}
