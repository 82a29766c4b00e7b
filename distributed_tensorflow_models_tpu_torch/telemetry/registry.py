"""Dependency-free metrics registry: counters, gauges, timers, spans.

Design constraints, in priority order:

1. **Hot-path cost.**  ``Timer.record`` / ``Counter.inc`` / ``Gauge.set``
   sit inside the train loop and the pipeline threads; they are a handful
   of attribute writes each (< 1 µs — pinned by
   ``tests/test_telemetry.py``'s 5 µs/step guard).  Percentile sorting is
   deferred to :meth:`MetricsRegistry.snapshot`, which runs only at the
   logging cadence.
2. **No dependencies.**  Stdlib only, importable from every layer (data,
   core, harness) without cycles.
3. **Thread-tolerant.**  Metric *creation* is locked (pipeline threads and
   the train loop race on first touch); recording is lock-free.  Each
   metric has a single writer in this repo's wiring (one thread owns one
   name), and under CPython's GIL a lost update on a cross-thread counter
   costs one increment of telemetry, never a crash.

Canonical metric names are module constants so the recorder (pipeline /
train loop / checkpoint) and the reader (TelemetryHook, goodput report)
can never drift apart on spelling.
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from typing import Iterator

from distributed_tensorflow_models_tpu_torch.telemetry import trace as tracelib

# Canonical names.  Timers flatten in snapshots as
# ``<name>/{total_s,count,mean_s,p50_s,p95_s,p99_s,max_s}``.
DATA_WAIT = "train/data_wait"  # timer: loop blocked in next(batch)
DISPATCH = "train/dispatch"  # timer: step-fn call (async dispatch)
STEP_TIME = "train/step_time"  # timer: full iteration wall time
# Counter: full hook traversals.  The unfused loop walks once per step;
# the fused loop walks only steps some hook wants (Hook.wants_step), so
# walks/steps is the direct measure of the host overhead steps_per_loop
# amortises (tier-1 micro-guard asserts the ≥K-fold drop).
HOOK_WALKS = "train/hook_walks"
COMPILE = "train/compile"  # timer: one record per XLA compile event
FLOPS_PER_STEP = "train/flops_per_step"  # gauge: XLA cost-analysis FLOPs
FLOPS_TOTAL = "train/flops_total"  # counter: FLOPs retired across all steps
HOST_QUEUE_DEPTH = "pipeline/host_queue_depth"  # gauge
PRODUCER_WAIT = "pipeline/producer_wait"  # timer: producer blocked on full buffer
PREFETCH_FILL = "pipeline/prefetch_fill"  # timer: DevicePrefetcher upstream fetch
PREFETCH_DEPTH = "pipeline/prefetch_depth"  # gauge
# Worker-pool producer (HostPipeline num_workers>1).  WORKER_BUSY is a
# per-worker utilization gauge family — one gauge per worker at
# ``pipeline/worker_busy/<i>`` (fraction of wall time spent assembling
# since the pool started).  REASSEMBLY_WAIT times the ordered-release
# stage waiting for the next in-index-order batch: high with workers
# near 1.0 busy = pool too small / decode-bound; high with workers idle
# = the serial record cursor is the bottleneck.
WORKER_BUSY = "pipeline/worker_busy"  # gauge family: /<worker index>
REASSEMBLY_WAIT = "pipeline/reassembly_wait"  # timer
CKPT_SAVE = "checkpoint/save"  # timer: blocking portion (snapshot+dispatch)
CKPT_RESTORE = "checkpoint/restore"  # timer
CKPT_WAIT = "checkpoint/wait"  # timer: explicit waits (teardown/emergency)
# Durability fence for overlapped saves: time the step path spent blocked
# on a PREVIOUS async save before dispatching the next one (checkpoint.py
# ::CheckpointManager.fence).  Separate from CKPT_SAVE so tightening
# checkpoint_every_steps shows its true wall cost: save = the
# device→host snapshot + orbax dispatch (paid per save), fence = how
# often the cadence outran the background writer (ideally ~0).
CKPT_FENCE = "checkpoint/fence"  # timer
# Degraded / cross-topology resume observability (checkpoint.py): a
# sidecar fallback means this process resumed from the primary's dataset
# position (approximate resume — its own sidecar was missing or
# unreadable, or a re-split found no usable cursor); a resize restore
# means the checkpoint was written by a different process count and the
# dataset cursor was re-split onto the new fleet.  Both are silent-log
# paths without these counters; fleet_report and the metrics-schema
# coverage gate read them, and either being nonzero on a steady-state
# fleet is a red flag.
CKPT_SIDECAR_FALLBACKS = "checkpoint/sidecar_fallbacks"  # counter
CKPT_RESIZE_RESTORES = "checkpoint/resize_restores"  # counter
# Cold-start / restart-MTTR gauges (harness/startup.py + fit): wall time
# of the startup restore walk, the background AOT train-step compile
# (overlapped with the restore — only the non-overlapped remainder lands
# in train/compile), and process-entry→first-completed-step.  The
# goodput report surfaces them as its "startup" section and the
# supervisor's relaunch-to-first-step MTTR is their fleet-side reading.
STARTUP_RESTORE = "startup/restore_s"  # gauge
STARTUP_AOT_COMPILE = "startup/aot_compile_s"  # gauge
STARTUP_FIRST_STEP = "startup/time_to_first_step_s"  # gauge
# Resilience (harness/train.py + resilience/).  RESTARTS counts
# recoverable_fit restore-retrain cycles (seeded into each attempt's fresh
# registry so the final telemetry.json carries the cumulative count);
# ROLLBACKS counts nan_policy="rollback" checkpoint rewinds and
# SKIPPED_BATCHES the batches the rollback cursor-advance discarded;
# WATCHDOG_LAST_PROGRESS is the live seconds-since-last-completed-chunk
# gauge the step-progress watchdog maintains (a growing value with the
# process alive = hung collective / pipeline deadlock).
RESTARTS = "train/restarts"  # counter
ROLLBACKS = "train/rollbacks"  # counter
SKIPPED_BATCHES = "train/skipped_batches"  # counter
WATCHDOG_LAST_PROGRESS = "train/watchdog_last_progress_s"  # gauge
# Fleet health (multi-host; resilience/heartbeat.py read by the chief's
# FleetHook).  PEERS_ALIVE counts processes with a fresh heartbeat;
# STEP_LAG is max−min step among alive peers (straggler skew);
# HEARTBEAT_AGE the worst heartbeat age.  CONSENSUS_OVERRIDES counts
# checkpoint decisions where this process's local storage view disagreed
# with the chief's broadcast (nonzero = cross-host visibility skew
# observed — the de-sync chief-decides exists to absorb).
FLEET_PEERS_ALIVE = "fleet/peers_alive"  # gauge
FLEET_STEP_LAG = "fleet/step_lag"  # gauge
FLEET_HEARTBEAT_AGE = "fleet/heartbeat_age_s"  # gauge
CONSENSUS_OVERRIDES = "fleet/consensus_overrides"  # counter
# Chaos drill audit: configured-but-never-fired fault count at report
# time (resilience/chaos.py::ChaosInjector.unfired, exported by fit into
# telemetry.json) — a drill that exits 0 with this nonzero exercised
# nothing.
CHAOS_ARMED_UNFIRED = "chaos/armed_unfired"  # gauge
# Flight-recorder / tracer accounting (telemetry/trace.py, stamped by fit
# before the telemetry.json report): EVENTS = events recorded over the
# run, DROPPED = how many the bounded ring overwrote — a post-mortem
# whose interesting window outran the ring says so here (raise
# trace_ring_events).  Validated non-negative by check_metrics_schema.
TRACE_EVENTS = "trace/events"  # gauge
TRACE_DROPPED = "trace/dropped"  # gauge
# Serving (serving/: continuous-batching inference).  The two latency
# distributions every serving SLO is written against: TTFT = submit →
# first token (dominated by queueing + prefill), TPOT = inter-token gap
# after the first (dominated by the batched decode step — the number
# continuous batching trades against throughput).  PREFILL/DECODE are
# device-dispatch spans (timer + trace span via registry.span).
# QUEUE_DEPTH and SLOT_OCCUPANCY are per-iteration load samples recorded
# into timers so they get the same p50/p99 surface as the latencies.
# serving_stats_p<i>.json carries all of these; validated by
# check_metrics_schema --serving-report.
SERVE_TTFT = "serve/ttft_s"  # timer
SERVE_TPOT = "serve/tpot_s"  # timer
SERVE_PREFILL = "serve/prefill"  # timer + span
SERVE_DECODE = "serve/decode"  # timer + span
SERVE_QUEUE_DEPTH = "serve/queue_depth"  # timer (per-iteration sample)
SERVE_SLOT_OCCUPANCY = "serve/slot_occupancy"  # timer (fraction, 0-1)
SERVE_REQUESTS = "serve/requests"  # counter
SERVE_TOKENS = "serve/tokens"  # counter
# Paged KV arena + radix prefix cache.  Hits/misses count
# BLOCKS (pages), not requests: one admission sharing a 4-page system
# prompt is 4 hits.  Evictions count cache references dropped by LRU
# pressure (the block itself may outlive the eviction if an in-flight
# request still gathers it).  The gauges are per-iteration snapshots
# recorded by the scheduler: blocks_free is pool headroom (admission
# backpressure when it can't cover a request's reservation),
# blocks_resident is what the prefix cache holds matchable, and
# block_fragmentation is the fraction of block-granular capacity
# reserved by in-flight requests that holds no live token yet (high =>
# kv_page_tokens too coarse for the traffic).  hit_rate is computed by
# the server report from the two counters, not stored.
SERVE_PREFIX_CACHE_HITS = "serve/prefix_cache_hits"  # counter (blocks)
SERVE_PREFIX_CACHE_MISSES = "serve/prefix_cache_misses"  # counter (blocks)
SERVE_PREFIX_CACHE_EVICTIONS = "serve/prefix_cache_evictions"  # counter
SERVE_PREFIX_CACHE_HIT_RATE = "serve/prefix_cache_hit_rate"  # report-only
SERVE_BLOCKS_FREE = "serve/blocks_free"  # gauge
SERVE_BLOCKS_RESIDENT = "serve/blocks_resident"  # gauge
SERVE_BLOCK_FRAGMENTATION = "serve/block_fragmentation"  # gauge (0-1)
# Speculative decoding (engine spec_tokens > 0 — the keys exist
# only when speculation is on, so a spec-off registry stays byte-for-
# byte the paged arena's registry).  DRAFTED counts n-gram draft tokens fed to
# verify dispatches, ACCEPTED the ones whose target sample matched
# (acceptance can only cost throughput, never change a token — the
# verify rule is byte-equality with solo sampling).  ACCEPTANCE_RATE is
# a per-verify-dispatch sample (accepted/drafted, 0-1) recorded into a
# timer for the p50/p99 surface; TOKENS_PER_DISPATCH the mean tokens a
# verify dispatch emitted per active lane (1 = speculation paying
# nothing, spec_tokens+1 = full acceptance).  Tune spec_tokens off
# these: raise it while acceptance holds, drop it (or raise
# spec_min_match) when the rate sits near zero.
SERVE_SPEC_DRAFTED = "serve/spec_drafted"  # counter (draft tokens)
SERVE_SPEC_ACCEPTED = "serve/spec_accepted"  # counter (accepted drafts)
SERVE_SPEC_ACCEPTANCE_RATE = "serve/spec_acceptance_rate"  # timer (0-1)
SERVE_SPEC_TOKENS_PER_DISPATCH = "serve/spec_tokens_per_dispatch"  # timer
# Serving observability.  COMPLETED counts requests retired
# with a terminal finish_reason — offered (SERVE_REQUESTS) minus served
# (this) is the live backlog, and the pair is what timeseries.jsonl's
# offered-vs-served throughput timeline diffs.  SLO_BREACH / SLO_MARGIN
# are per-SLO families keyed ``serve/slo_breach/<name>`` (counter:
# breach *episodes*, hysteresis-debounced — not breaching evaluations)
# and ``serve/slo_margin/<name>`` (gauge: threshold − observed, negative
# while out of SLO).  telemetry/slo.py pre-creates both at monitor
# construction so an idle-but-monitored server reports zeros; with no
# monitor attached the keys are absent (full-set-or-absent, mirroring
# the spec_* contract — enforced by check_metrics_schema
# --serving-report).
SERVE_COMPLETED = "serve/completed"  # counter
SERVE_SLO_BREACH = "serve/slo_breach"  # counter family: /<slo name>
SERVE_SLO_MARGIN = "serve/slo_margin"  # gauge family: /<slo name>
# Disaggregated prefill/decode serving (--role-map splits the
# file-queue fleet into prefill and decode replicas).  The serve/ship*
# and serve/fleet_prefix* keys exist ONLY on a disaggregated replica
# (full-set-or-absent, mirroring the spec_* contract — a monolithic
# registry stays byte-for-byte the serving-observability registry; enforced by
# check_metrics_schema --serving-report).  SHIP is the handoff leg's
# timer + waterfall span: on a prefill replica it prices export +
# serialize + publish of one bundle, on a decode replica the full
# prefill-done → first-token-emitted gap (handoff-dir dwell + parse +
# scatter-adopt), which is exactly the queue+prefill+ship−TTFT
# attribution residue serving_report audits.  SHIP_BYTES / SHIP_PAGES
# count wire payload (prefill: shipped out; decode: adopted in).
# FLEET_PREFIX_* split the prefix-cache story across the fleet: pages a
# prefill replica adopted from the shared fleet index instead of
# re-prefilling (hits) vs matchable pages no replica had (misses) —
# block-granular like the local serve/prefix_cache_* pair.
SERVE_SHIP = "serve/ship"  # timer + span (disagg only)
SERVE_SHIP_REQUESTS = "serve/ship_requests"  # counter (disagg only)
SERVE_SHIP_BYTES = "serve/ship_bytes"  # counter (disagg only)
SERVE_SHIP_PAGES = "serve/ship_pages"  # counter (disagg only)
SERVE_FLEET_PREFIX_HITS = "serve/fleet_prefix_hits"  # counter (blocks)
SERVE_FLEET_PREFIX_MISSES = "serve/fleet_prefix_misses"  # counter
# Compiled-program-count pins, observable from stats artifacts: every
# serving report carries them (monolithic steady state (1, 1), or
# (1, 2) spec-on; a prefill replica must report (1, 0) and a decode
# replica (0, 1) — jit laziness IS the per-role pin, a role that never
# calls the other program never compiles it).
SERVE_COMPILED_PREFILL = "serve/compiled_prefill"  # gauge
SERVE_COMPILED_DECODE = "serve/compiled_decode"  # gauge
# Overload protection (serving/admission.py wired through the
# scheduler).  SUBMITTED / SHED are per-priority-class families keyed
# ``serve/submitted/<class>`` and ``serve/shed/<class>`` — submitted
# counts intake by class, shed counts requests answered with
# ``finish_reason="shed"`` (a shed is a RESPONSE, never a silent drop,
# so submitted − shed − live = streams actually served).  Both families
# are pre-created per configured class when an AdmissionPolicy is
# attached and absent otherwise (full-set-or-absent, class-name-paired
# like the slo_* families; enforced by check_metrics_schema
# --serving-report).  BACKPRESSURE is the intake gate's live state
# (0/1) and BACKPRESSURE_ENGAGED its engage-episode counter
# (transitions, not samples — a 10 s pause is one episode), created
# with the admission family.
SERVE_SUBMITTED = "serve/submitted"  # counter family: /<class>
SERVE_SHED = "serve/shed"  # counter family: /<class>
SERVE_BACKPRESSURE = "serve/backpressure"  # gauge (0/1)
SERVE_BACKPRESSURE_ENGAGED = "serve/backpressure_engaged"  # counter
# Closed-loop autoscale (launch.py::FleetAutoscaler writes
# fleet_size.json + scale_events.jsonl, each replica mirrors what it
# observes).  FLEET_SIZE is the replica-observed live fleet size;
# SCALE_UP / SCALE_DOWN count observed membership transitions.  The
# trio exists only when the server was pointed at a controller-managed
# fleet file (--fleet-file) — full-set-or-absent, mirroring the spec_*
# contract.
SERVE_FLEET_SIZE = "serve/fleet_size"  # gauge
SERVE_SCALE_UP = "serve/scale_up"  # counter
SERVE_SCALE_DOWN = "serve/scale_down"  # counter
# Continuous deployment (serving/deploy.py follows the
# trainer's checkpoints into the live engine).  The deploy family
# exists only when a CheckpointFollower is attached
# (--follow-checkpoints) and is full-set-or-absent, mirroring the
# scale trio: SWAPS counts weight versions promoted into the primary
# slot (hot-swap — zero recompiles, the compiled pins prove it),
# ROLLBACKS counts canaried candidates withdrawn on SLO breach, and
# REJECTED counts candidates the gate refused BEFORE they touched a
# live program (torn / non-finite / aval-drifted — each leaves a
# flight record + deploy_events.jsonl line).  VERSION_ACTIVE /
# VERSION_CANARY are the replica's live commitments (checkpoint step
# ids; canary −1 = none).  The per-version families are keyed
# ``serve/version/<stat>/<vid>`` — requests / tokens / shed counters
# plus ttft_s / tpot_s timers — so a canary's latency distribution is
# separable from the primary's in the same artifact; for every vid
# observed the five stats appear together (full-set-per-version,
# enforced by check_metrics_schema --serving-report).
SERVE_DEPLOY_SWAPS = "serve/deploy_swaps"  # counter
SERVE_DEPLOY_ROLLBACKS = "serve/deploy_rollbacks"  # counter
SERVE_DEPLOY_REJECTED = "serve/deploy_rejected_candidates"  # counter
SERVE_VERSION_ACTIVE = "serve/version/active"  # gauge (step id)
SERVE_VERSION_CANARY = "serve/version/canary"  # gauge (step id | -1)
SERVE_VERSION_REQUESTS = "serve/version/requests"  # counter family: /<vid>
SERVE_VERSION_TOKENS = "serve/version/tokens"  # counter family: /<vid>
SERVE_VERSION_SHED = "serve/version/shed"  # counter family: /<vid>
SERVE_VERSION_TTFT = "serve/version/ttft_s"  # timer family: /<vid>
SERVE_VERSION_TPOT = "serve/version/tpot_s"  # timer family: /<vid>
# Spec-decode acceptance split per version — present only when BOTH
# deploy and speculation are on (conditional like serve/spec_*, so it
# sits outside the five-stat per-version full set).
SERVE_VERSION_ACCEPTANCE = "serve/version/acceptance_rate"  # timer: /<vid>


class Counter:
    """Monotonic accumulator (events, seconds-of-X)."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        self.value += n


class Gauge:
    """Last-value-wins instantaneous reading."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)


class Timer:
    """Duration accumulator with count/total/max and reservoir percentiles.

    The reservoir keeps the last ``RESERVOIR`` samples (ring overwrite), so
    p50/p95 reflect *recent* behaviour — a warmup-era outlier ages out
    instead of pinning p95 forever.  ``max`` stays all-time: the single
    worst stall is exactly the thing a post-mortem wants.
    """

    RESERVOIR = 512

    __slots__ = ("count", "total", "max", "_samples", "_idx")

    def __init__(self):
        self.count = 0
        self.total = 0.0
        self.max = 0.0
        self._samples: list[float] = []
        self._idx = 0

    def record(self, seconds: float) -> None:
        self.count += 1
        self.total += seconds
        if seconds > self.max:
            self.max = seconds
        if len(self._samples) < self.RESERVOIR:
            self._samples.append(seconds)
        else:
            self._samples[self._idx] = seconds
            self._idx = (self._idx + 1) % self.RESERVOIR

    def percentiles(self, *qs: float) -> tuple[float, ...]:
        """Nearest-rank percentiles over the reservoir (0.0 when empty)."""
        if not self._samples:
            return tuple(0.0 for _ in qs)
        ordered = sorted(self._samples)
        n = len(ordered)
        return tuple(
            ordered[min(n - 1, int(q * n))] for q in qs
        )


class MetricsRegistry:
    """Create-or-get metric store with a flat-dict snapshot.

    One registry per training run (``fit`` makes its own so concurrent or
    back-to-back runs in one process never cross-contaminate); the
    process-global default from :func:`get_registry` serves standalone
    component use.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: dict[str, Counter] = {}
        self._gauges: dict[str, Gauge] = {}
        self._timers: dict[str, Timer] = {}
        # Structured event tracer (telemetry/trace.py), defaulting to the
        # shared disabled instance: components reach it as
        # ``registry.trace`` (one attribute hop — no new plumbing), and
        # ``fit`` swaps in a live per-run tracer when tracing is on.
        # ``span`` below mirrors every timed block into it, so the sites
        # the registry already times are traced for free.
        self.trace = tracelib.NULL_TRACER

    def _get(self, table: dict, name: str, cls):
        m = table.get(name)
        if m is None:
            with self._lock:
                m = table.setdefault(name, cls())
        return m

    def counter(self, name: str) -> Counter:
        return self._get(self._counters, name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(self._gauges, name, Gauge)

    def timer(self, name: str) -> Timer:
        return self._get(self._timers, name, Timer)

    @contextmanager
    def span(self, name: str) -> Iterator[None]:
        """Time a ``with`` block into ``timer(name)`` (errors included —
        a save that dies after 30 s still burned the 30 s).  When a live
        tracer is attached the block also lands in the event ring as a
        complete event of the same name — the flight recorder and the
        Chrome timeline see every site the registry times."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.timer(name).record(dt)
            if self.trace.enabled:
                self.trace.complete(name, dt, ts_mono=t0)

    def snapshot(self) -> dict[str, float]:
        """Flat ``{name: float}`` view of everything recorded so far.

        Cumulative, not interval: readers wanting rates diff two
        snapshots (TelemetryHook does).  Timer percentiles are computed
        here — the one deliberately non-cheap operation, amortized over
        the snapshot cadence, never paid per step.
        """
        out: dict[str, float] = {}
        for name, c in sorted(self._counters.items()):
            out[name] = c.value
        for name, g in sorted(self._gauges.items()):
            out[name] = g.value
        for name, t in sorted(self._timers.items()):
            p50, p95, p99 = t.percentiles(0.50, 0.95, 0.99)
            out[f"{name}/count"] = float(t.count)
            out[f"{name}/total_s"] = t.total
            out[f"{name}/mean_s"] = t.total / t.count if t.count else 0.0
            out[f"{name}/p50_s"] = p50
            out[f"{name}/p95_s"] = p95
            out[f"{name}/p99_s"] = p99
            out[f"{name}/max_s"] = t.max
        return out


_default = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    """The process-global default registry (standalone component use)."""
    return _default
