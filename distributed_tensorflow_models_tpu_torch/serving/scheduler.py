"""Admission + continuous batching: iteration-level scheduling over slots.

A copy of ``distributed_tensorflow_models_tpu/serving/scheduler.py`` over
the port's engine (host logic only: numpy, the registry, the drafter);
``Request.rng`` is the int seed ``generate(seed=)`` takes.  The pieces it
drives enter as objects the caller passes: an admission policy and
backpressure gate (:mod:`.admission`), the SLO monitor
(``telemetry/slo.py``), the checkpoint follower (:mod:`.deploy`) and, on
a prefill replica, the ship callback (``serving/server.py``), which
exports a slot's pages for a decode replica's ``submit_shipped``.

Orca's observation, applied to the slotted engine: scheduling decisions
belong at TOKEN granularity, not request granularity.  Each
:meth:`ContinuousBatchingScheduler.step`:

1. **Sheds** (admission policy attached) — before admitting, waiting
   requests past their TTFT deadline, plus — while a configured SLO is
   in breach — a bounded number of lowest-class waiters, retire
   immediately with ``finish_reason="shed"`` and an EMPTY token list.
   A shed is a *response*: the server resolves its handle and a
   file-queue replica writes it back, so clients always hear back and
   the exactly-once ledger stays balanced under overload.  The
   attached :class:`~.admission.BackpressureGate` is fed blocks-free +
   queue-depth once per iteration; while engaged
   (``intake_paused``), the server pauses *claiming* new work so the
   arena is protected BEFORE it exhausts, not after.
2. **Admits** — packs waiting prompts (FIFO by default, so TTFT is
   arrival-ordered and starvation-free; with an
   :class:`~.admission.AdmissionPolicy` attached, highest priority
   class first and FIFO *within* a class) into free slots AND free KV
   blocks (``engine.admit`` reserves the request's whole paged
   footprint up front, reusing any resident prefix), bounded by the
   ``max_prefill_tokens`` budget: prefill compute is O(uncached
   suffix), and an unbounded admission burst would stall every RUNNING
   request's next token behind it — the budget caps the per-iteration
   TPOT spike.  Budget accounting is CACHE-AWARE: a prompt whose prefix
   is resident costs only its padded uncached suffix, so prefix-cache
   hits buy real admission headroom.  The first admission of an
   iteration is always allowed (a single prompt longer than the budget
   must not starve).  The whole wave prefills through
   ``engine.prefill_batch`` — ``prefill_lanes`` prompts per dispatch of
   the one prefill program.  A request finishing AT admission (EOS
   first token, or ``max_new_tokens == 1``) frees its slot and blocks
   inside the same pass, so the next iteration's waiter takes them.
3. **Decodes** — ONE batched dispatch advances every active slot
   ``engine.decode_burst`` tokens (1 by default — classic per-token
   scheduling; >1 amortizes per-dispatch host cost over the burst at
   the price of burst-granular admission, vLLM's multi-step
   scheduling).  Tokens a lane generates past its own finish line
   (EOS or ``max_new_tokens``) inside a burst are discarded here and
   never emitted.  With speculation on (``engine.spec_tokens > 0``)
   each lane also carries its drafter's proposal and the dispatch may
   be a verify instead of a burst — the lane then returns a VARIABLE
   number of tokens (1 to ``spec_tokens + 1``); the same discard loop
   covers overrun past EOS mid-acceptance, and proposals are clipped
   to the lane's remaining ``max_new`` budget before dispatch so
   acceptance alone can never overrun it.
4. **Retires** — sequences that emitted ``eos_id`` or reached
   ``max_new_tokens`` release their slot and block references
   (``engine.release``; pages the prefix cache adopted stay resident
   for future admissions); the NEXT iteration's admission pass refills
   them mid-flight (no drain-the-batch barrier — the whole point of
   continuous batching).

Telemetry (keys in ``telemetry/registry.py``): TTFT (submit → first
token, timer), TPOT (inter-token gap after the first, timer),
queue-depth and slot-occupancy sampled once per iteration into timers
(so p50/p99 come from the same reservoir machinery as the latencies),
``serve/requests`` / ``serve/tokens`` counters, the paged-arena gauges
(``serve/blocks_free``, ``serve/blocks_resident``,
``serve/block_fragmentation``) refreshed once per iteration, plus the
engine's own ``serve/prefill`` / ``serve/decode`` device spans and
prefix-cache hit/miss/eviction counters.  With a live tracer attached
(``registry.trace.enabled``) the scheduler additionally emits the
PER-REQUEST lifecycle into the event ring — ``serve/req/queue``
(enqueue → admission wave, shed reason in args when the request was
backpressured), ``serve/req/prefill`` (prefix-cache hit length +
padded uncached suffix in args), ``serve/req/decode`` (one per decode
dispatch per lane, tokens emitted in args), ``serve/req/shed``
instants on admission backpressure, and a ``serve/req/done`` instant
at retirement — every event carrying ``rid`` so
``scripts/serving_report.py`` can rebuild a per-request waterfall
whose queue + prefill spans sum to the measured TTFT.  Emission is
plain ``Tracer.complete``/``instant`` calls (no contextmanager enters
in the dispatch loop), gated on ``trace.enabled`` so the tracing-off
hot path pays one attribute check.  An attached
:class:`~..telemetry.slo.SLOMonitor` (``slo_monitor=``) is fed TTFT /
TPOT / queue-depth samples inline and evaluated once per iteration
(rate-limited internally).  With
``decode_burst > 1`` a burst's tokens become host-visible together, so
TPOT turns bimodal (≈0 intra-burst, the full dispatch gap at burst
boundaries) — the p50/p99 spread IS the burst tradeoff; the mean stays
the true per-token rate.  All host timing is
``time.perf_counter`` (monotonic — wall-clock steps would corrupt
latency stats).
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Optional

import numpy as np

from distributed_tensorflow_models_tpu_torch.telemetry import registry as reglib

from .drafter import NO_DRAFT, NgramDrafter

# Per-request lifecycle trace event names (Tracer ring events, not
# registry metric keys — serving_report.py groups them by args["rid"]).
REQ_QUEUE = "serve/req/queue"
REQ_PREFILL = "serve/req/prefill"
REQ_SHIP = "serve/req/ship"
REQ_DECODE = "serve/req/decode"
REQ_SHED = "serve/req/shed"
REQ_DONE = "serve/req/done"


@dataclasses.dataclass
class Request:
    """One generation request.  ``rng`` is the SAME int seed a solo
    ``generate(seed=)`` call would take — required when ``temperature >
    0`` (matching ``generate()``'s contract), ignored for greedy."""

    request_id: int
    prompt: np.ndarray  # 1-D int32, non-empty
    max_new_tokens: int
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    eos_id: Optional[int] = None
    rng: Optional[int] = None  # generate()'s seed; opaque at this layer
    # Admission-control facts (ignored without an AdmissionPolicy):
    # priority names a class ("" = policy default), deadline_s is a
    # TTFT deadline relative to submit — overdue waiters are shed.
    priority: str = ""
    deadline_s: Optional[float] = None


@dataclasses.dataclass
class Completion:
    """A retired request: its generated tokens (EOS included when that
    is what stopped it) and per-request latency facts."""

    request_id: int
    tokens: list
    finish_reason: str  # "eos" | "length" | "shipped" | "shed"
    ttft_s: float
    decode_steps: int
    # Mean per-token decode latency of THIS request (0.0 when it never
    # decoded past its first token).  Lets an open-loop driver build
    # warmup-excluded latency distributions from response payloads
    # alone — the registry timers fold compile-era samples into their
    # percentiles, which a small trace cannot rank past.
    tpot_s: float = 0.0
    # Weight version the request was ADMITTED under (checkpoint step;
    # 0 = boot weights).  The engine pins the slot to it, so the token
    # stream is byte-identical to a solo generate() with that version's
    # weights regardless of swaps landing mid-flight.
    version: int = 0


class _InFlight:
    """Host-side state of one admitted request."""

    __slots__ = (
        "req", "slot", "keydata", "tokens", "pos", "t_submit", "ttft_s",
        "t_last", "drafter", "cached_len", "sheds", "shed_reason",
        "ship", "cls", "version",
    )

    def __init__(self, req, slot, keydata, t_submit):
        self.req = req
        self.slot = slot
        self.keydata = keydata  # [max_new] per-token seeds
        self.tokens: list = []
        self.pos = 0  # tokens generated so far
        self.t_submit = t_submit
        self.ttft_s = 0.0
        self.t_last = 0.0
        self.drafter = None  # set at admission when speculation is on
        self.cached_len = 0  # prefix-cache hit length, set at admission
        self.sheds = 0  # backpressure events suffered while head-of-line
        self.shed_reason = ""  # last shed reason ("no_slot" | "no_blocks")
        self.ship = None  # shipped-arrival facts dict (decode role only)
        self.cls = ""  # resolved priority class (admission policy only)
        self.version = 0  # weight version pinned at admission (deploy)


class ContinuousBatchingScheduler:
    """The host-side serving loop over one :class:`InferenceEngine`.

    Single-threaded by design: ``submit`` and ``step`` must be called
    from one thread (the server's worker).  ``step`` returns the
    requests it retired; ``run_until_idle`` drives steps until nothing
    is waiting or active (the batch-mode entry tests and the bench use).
    """

    def __init__(
        self,
        engine,
        *,
        max_prefill_tokens: Optional[int] = None,
        registry: Optional[reglib.MetricsRegistry] = None,
        drafter_factory=None,
        slo_monitor=None,
        role: str = "monolithic",
        ship=None,
        admission=None,
        backpressure=None,
        deploy=None,
    ):
        if role not in ("monolithic", "prefill", "decode"):
            raise ValueError(
                f"role must be monolithic|prefill|decode, got {role!r}"
            )
        if (ship is not None) != (role == "prefill"):
            raise ValueError(
                "ship callback is required for role='prefill' and "
                "forbidden otherwise"
            )
        # Disaggregation (see serving/shipping.py): a "prefill" scheduler
        # runs ONLY admission + the prefill program, then hands every
        # unfinished request to the ship callback
        # ``ship(inflight, first_token, t_prefill_start, t_prefill_end)``
        # — called while the slot is still allocated so the callback can
        # export its KV pages — and retires it locally with
        # ``finish_reason="shipped"``.  A "decode" scheduler takes intake
        # ONLY via :meth:`submit_shipped` (adopting wire pages through
        # ``engine.admit_shipped``) and runs ONLY the decode program.
        # Each role therefore never calls the other role's program, so
        # programs built on first use pin counts at (1, 0) / (0, 1).
        self.role = role
        self._ship = ship
        self.engine = engine
        # Optional telemetry/slo.py monitor: _emit feeds it TTFT/TPOT
        # samples, step's tail feeds queue depth and evaluates (the
        # monitor rate-limits itself).  None costs one is-None check.
        self.slo = slo_monitor
        # Speculation: when the engine was built with spec_tokens > 0,
        # every admitted request gets a drafter (default: the n-gram
        # self-drafter seeded with its prompt).  drafter_factory(req)
        # overrides construction — tests inject oracle/adversarial
        # drafters to pin the acceptance extremes.  Byte-identity of
        # the output stream never depends on the drafter (the engine's
        # verify rule owns correctness), so the factory is a pure
        # throughput knob.
        self._drafter_factory = drafter_factory
        # Default budget: half the arena's slots' worth of one chunk
        # each — enough to keep slots full under bursty arrivals without
        # ever spending more than ~half an iteration on prefill.
        self.max_prefill_tokens = (
            int(max_prefill_tokens)
            if max_prefill_tokens is not None
            else max(1, engine.max_slots // 2) * engine.prefill_chunk
        )
        if self.max_prefill_tokens < 1:
            raise ValueError(
                f"max_prefill_tokens must be >= 1, got "
                f"{self.max_prefill_tokens}"
            )
        self.registry = (
            registry if registry is not None else engine.registry
        )
        # Admission control (serving/admission.py).  The policy brings
        # priority classes + shed rules; the gate brings pre-exhaustion
        # intake pausing.  Attaching either pre-creates the WHOLE
        # admission metric family (per-class submitted/shed counters,
        # backpressure gauge + episode counter) so the
        # full-set-or-absent stats contract holds from the first
        # snapshot; without a policy the scheduler is byte-for-byte the
        # PR 18 FIFO scheduler.
        if backpressure is not None and admission is None:
            raise ValueError(
                "a BackpressureGate needs an AdmissionPolicy attached "
                "(the gate's metrics are part of the admission family)"
            )
        self.admission = admission
        self._gate = backpressure
        self._gate_episodes_seen = 0
        # Continuous deployment (serving/deploy.py CheckpointFollower):
        # admission asks it which weight version each request is routed
        # to (deterministic rid hash), _emit feeds it candidate latency
        # samples, and per-version serve/version/* metric families are
        # recorded — full-set-per-version, created at a version's first
        # sighting.  Without a follower the scheduler is byte-for-byte
        # the PR 19 scheduler and creates NONE of the version metrics.
        self.deploy = deploy
        self._version_metrics_seen: set = set()
        if admission is not None:
            for cls in admission.classes:
                self.registry.counter(f"{reglib.SERVE_SUBMITTED}/{cls}")
                self.registry.counter(f"{reglib.SERVE_SHED}/{cls}")
            self.registry.gauge(reglib.SERVE_BACKPRESSURE).set(0.0)
            self.registry.counter(reglib.SERVE_BACKPRESSURE_ENGAGED)
        # One FIFO deque per priority rank (a single rank without a
        # policy); admission drains the highest non-empty rank first.
        self._queues: list = [
            deque()
            for _ in range(len(admission.classes) if admission else 1)
        ]
        self._active: dict[int, _InFlight] = {}  # slot -> state
        # Last (rid, reason) shed instant emitted — backpressure persists
        # across iterations and the instant is only interesting on
        # transition, not once per blocked step.
        self._last_shed: Optional[tuple] = None

    # -- intake ------------------------------------------------------------

    def submit(self, req: Request) -> None:
        """Validate + enqueue (does NOT run the engine; admission happens
        in :meth:`step`).  Raises ``ValueError`` for requests that could
        never be served — rejecting at the door beats a slot wedged on
        an impossible request."""
        if self.role == "decode":
            raise ValueError(
                "a decode-role scheduler takes intake only via "
                "submit_shipped (raw prompts belong on a prefill or "
                "monolithic replica)"
            )
        prompt = np.asarray(req.prompt, np.int32).reshape(-1)
        if req.max_new_tokens < 1:
            raise ValueError(
                f"max_new_tokens must be >= 1, got {req.max_new_tokens}"
            )
        self.engine.check_fits(len(prompt), req.max_new_tokens)
        if req.temperature > 0 and req.rng is None:
            raise ValueError("temperature sampling needs an rng seed")
        req.prompt = prompt
        if req.temperature > 0:
            keydata = self.engine.request_keys(
                req.rng, req.max_new_tokens
            )
        else:
            keydata = self.engine.zero_keys(req.max_new_tokens)
        self.registry.counter(reglib.SERVE_REQUESTS).inc()
        inflight = _InFlight(req, -1, keydata, time.perf_counter())
        self._enqueue(inflight)

    def submit_shipped(
        self,
        req: Request,
        *,
        pages: dict,
        keydata,
        first_token: int,
        t_submit: float,
        queue_s: float,
        prefill_s: float,
        cached_len: int = 0,
        wire_bytes: int = 0,
        src_replica: int = -1,
    ) -> None:
        """Decode-role intake: enqueue a request whose prefill ALREADY
        ran on another replica.  ``pages`` is the shipped prompt KV
        (``{path: [n_pages, page_tokens, ...]}``), ``keydata`` the full
        shipped key schedule (row 0 was consumed by prefill — indexing
        stays identical to the monolithic path), ``first_token`` the
        prefill program's sampled token (emitted here so TTFT lands on
        the replica that streams), and ``t_submit`` the ORIGINAL submit
        stamp rebased into this process's ``perf_counter`` frame
        (:func:`~.shipping.mono_of_wall`) with the prefill replica's
        measured ``queue_s``/``prefill_s`` legs — so this replica's
        waterfall carries queue + prefill + ship spans summing exactly
        to the TTFT it records."""
        if self.role != "decode":
            raise ValueError(
                "submit_shipped is decode-role intake only"
            )
        prompt = np.asarray(req.prompt, np.int32).reshape(-1)
        if req.max_new_tokens < 1:
            raise ValueError(
                f"max_new_tokens must be >= 1, got {req.max_new_tokens}"
            )
        self.engine.check_fits(len(prompt), req.max_new_tokens)
        req.prompt = prompt
        keydata = np.asarray(keydata)
        if keydata.shape[0] != req.max_new_tokens:
            raise ValueError(
                f"shipped keydata covers {keydata.shape[0]} tokens, "
                f"request wants {req.max_new_tokens}"
            )
        inflight = _InFlight(req, -1, keydata, float(t_submit))
        inflight.cached_len = int(cached_len)
        inflight.ship = {
            "pages": pages,
            "first_token": int(first_token),
            "queue_s": float(queue_s),
            "prefill_s": float(prefill_s),
            "bytes": int(wire_bytes),
            "src": int(src_replica),
        }
        self.registry.counter(reglib.SERVE_REQUESTS).inc()
        self._enqueue(inflight)

    def _enqueue(self, inflight) -> None:
        """File into the priority rank its class maps to (rank 0 — the
        only queue — without a policy), counting intake by class."""
        rank = 0
        if self.admission is not None:
            cls = self.admission.resolve(inflight.req.priority)
            inflight.cls = cls
            rank = self.admission.rank(cls)
            self.registry.counter(
                f"{reglib.SERVE_SUBMITTED}/{cls}"
            ).inc()
        self._queues[rank].append(inflight)

    # -- introspection -----------------------------------------------------

    @property
    def waiting_count(self) -> int:
        return sum(len(q) for q in self._queues)

    @property
    def active_count(self) -> int:
        return len(self._active)

    @property
    def has_work(self) -> bool:
        return bool(self._active or any(self._queues))

    @property
    def intake_paused(self) -> bool:
        """True while the backpressure gate is engaged — the server's
        signal to stop claiming new work before the arena exhausts."""
        return self._gate is not None and self._gate.engaged

    # -- the iteration -----------------------------------------------------

    def _version_metrics(self, vid: int) -> None:
        """Create a version's FULL metric set at first sighting —
        full-set-per-version: every vid that appears in an artifact
        carries all five stats (check_metrics_schema enforces)."""
        if vid in self._version_metrics_seen:
            return
        self._version_metrics_seen.add(vid)
        self.registry.counter(f"{reglib.SERVE_VERSION_REQUESTS}/{vid}")
        self.registry.counter(f"{reglib.SERVE_VERSION_TOKENS}/{vid}")
        self.registry.counter(f"{reglib.SERVE_VERSION_SHED}/{vid}")
        self.registry.timer(f"{reglib.SERVE_VERSION_TTFT}/{vid}")
        self.registry.timer(f"{reglib.SERVE_VERSION_TPOT}/{vid}")

    def _emit(self, inflight, token: int, now: float) -> bool:
        """Record one generated token; True when the request is done."""
        inflight.tokens.append(token)
        inflight.pos += 1
        if inflight.drafter is not None:
            inflight.drafter.append(token)
        self.registry.counter(reglib.SERVE_TOKENS).inc()
        deploy = self.deploy
        if deploy is not None:
            self._version_metrics(inflight.version)
            self.registry.counter(
                f"{reglib.SERVE_VERSION_TOKENS}/{inflight.version}"
            ).inc()
        if inflight.pos == 1:
            inflight.ttft_s = now - inflight.t_submit
            self.registry.timer(reglib.SERVE_TTFT).record(
                inflight.ttft_s
            )
            if self.slo is not None:
                self.slo.observe(reglib.SERVE_TTFT, inflight.ttft_s, now)
            if deploy is not None:
                self.registry.timer(
                    f"{reglib.SERVE_VERSION_TTFT}/{inflight.version}"
                ).record(inflight.ttft_s)
                deploy.observe_sample(
                    inflight.version, reglib.SERVE_TTFT,
                    inflight.ttft_s, now,
                )
        else:
            tpot = now - inflight.t_last
            self.registry.timer(reglib.SERVE_TPOT).record(tpot)
            if self.slo is not None:
                self.slo.observe(reglib.SERVE_TPOT, tpot, now)
            if deploy is not None:
                self.registry.timer(
                    f"{reglib.SERVE_VERSION_TPOT}/{inflight.version}"
                ).record(tpot)
                deploy.observe_sample(
                    inflight.version, reglib.SERVE_TPOT, tpot, now
                )
        inflight.t_last = now
        req = inflight.req
        return (
            req.eos_id is not None and token == req.eos_id
        ) or inflight.pos >= req.max_new_tokens

    def _retire(self, inflight, done: list) -> None:
        self.engine.release(inflight.slot)
        reason = (
            "eos"
            if (
                inflight.req.eos_id is not None
                and inflight.tokens
                and inflight.tokens[-1] == inflight.req.eos_id
            )
            else "length"
        )
        self.registry.counter(reglib.SERVE_COMPLETED).inc()
        trace = self.registry.trace
        if trace.enabled:
            args = {
                "rid": inflight.req.request_id,
                "reason": reason,
                "tokens": inflight.pos,
                "ttft_s": inflight.ttft_s,
            }
            if self.deploy is not None:
                args["v"] = inflight.version
            trace.instant(REQ_DONE, args)
        decode_steps = max(0, inflight.pos - 1)
        done.append(
            Completion(
                request_id=inflight.req.request_id,
                tokens=list(inflight.tokens),
                finish_reason=reason,
                ttft_s=inflight.ttft_s,
                decode_steps=decode_steps,
                tpot_s=(
                    (inflight.t_last - inflight.t_submit - inflight.ttft_s)
                    / decode_steps
                    if decode_steps > 0 else 0.0
                ),
                version=inflight.version,
            )
        )

    def _shed(self, inflight, why: str, now: float, done: list) -> None:
        """Retire a WAITING request unserved: empty token list,
        ``finish_reason="shed"``.  It never held a slot or blocks, so
        there is nothing to release — but it still produces a
        completion (the server resolves its handle / writes its
        response) and still counts as completed: shed + served =
        answered, which is what the exactly-once ledger balances."""
        cls = inflight.cls
        if cls:
            self.registry.counter(f"{reglib.SERVE_SHED}/{cls}").inc()
        if self.deploy is not None:
            # The version the request WOULD have run under (the routing
            # is pure, so shed attribution replays like admission).
            vid = self.deploy.route(str(inflight.req.request_id))
            inflight.version = vid
            self._version_metrics(vid)
            self.registry.counter(
                f"{reglib.SERVE_VERSION_SHED}/{vid}"
            ).inc()
        self.registry.counter(reglib.SERVE_COMPLETED).inc()
        trace = self.registry.trace
        if trace.enabled:
            trace.instant(REQ_SHED, {
                "rid": inflight.req.request_id,
                "reason": why,
                "cls": cls,
                "waited_s": round(now - inflight.t_submit, 6),
            })
            trace.instant(REQ_DONE, {
                "rid": inflight.req.request_id,
                "reason": "shed",
                "tokens": 0,
                "ttft_s": 0.0,
            })
        done.append(
            Completion(
                request_id=inflight.req.request_id,
                tokens=[],
                finish_reason="shed",
                ttft_s=0.0,
                decode_steps=0,
                version=inflight.version,
            )
        )

    def _shed_pass(self, done: list) -> None:
        """Pre-admission shedding (admission policy attached).

        Deadline sheds are unconditional and unbounded — a waiter past
        its TTFT deadline is dead weight in every class.  SLO sheds
        fire only while a policy-configured SLO name is in breach
        state (hysteresis-debounced by the monitor), take the LOWEST
        class first (oldest first within a class), and are bounded per
        iteration by the policy's quota so one breached evaluation
        can't mass-evict the queue."""
        now = time.perf_counter()
        for rank, queue in enumerate(self._queues):
            if not queue:
                continue
            survivors: deque = deque()
            for f in queue:
                if self.admission.overdue(
                    f.t_submit, f.req.deadline_s, now
                ):
                    self._shed(f, "deadline", now, done)
                else:
                    survivors.append(f)
            self._queues[rank] = survivors
        quota = (
            self.admission.shed_quota(self.slo.breached())
            if self.slo is not None
            else 0
        )
        rank = 0
        while quota > 0 and rank < len(self._queues):
            queue = self._queues[rank]
            if queue:
                self._shed(queue.popleft(), "slo", now, done)
                quota -= 1
            else:
                rank += 1

    def _ship_out(self, inflight, first_token, t_wave: float,
                  now: float, done: list) -> None:
        """Prefill role: hand an unfinished request to the ship
        callback (slot still allocated — the callback exports its KV
        pages), then retire it locally as ``finish_reason="shipped"``.
        The first token travels in the bundle and is EMITTED on the
        decode replica, so TTFT/TPOT/token counters land where the
        stream is served; here we record only the lifecycle instant."""
        try:
            self._ship(inflight, first_token, t_wave, now)
        finally:
            self.engine.release(inflight.slot)
        trace = self.registry.trace
        if trace.enabled:
            trace.instant(REQ_DONE, {
                "rid": inflight.req.request_id,
                "reason": "shipped",
                "tokens": 1,
                "ttft_s": 0.0,
            })
        done.append(
            Completion(
                request_id=inflight.req.request_id,
                tokens=[int(first_token)],
                finish_reason="shipped",
                ttft_s=0.0,
                decode_steps=0,
            )
        )

    def step(self) -> list:
        """One scheduling iteration; returns retired :class:`Completion`s
        (possibly empty).  No-op when idle."""
        done: list = []
        # 0. shed pass: deadline-overdue waiters and (while a
        # configured SLO is breached) lowest-class waiters answer
        # "shed" BEFORE admission spends arena capacity on them.
        if self.admission is not None:
            self._shed_pass(done)
        # 1. admission: pack a wave of waiters into free slots + free
        # blocks under the cache-aware budget (cost = padded UNCACHED
        # suffix — resident prefixes are free), then prefill the whole
        # wave batched.  Waves drain the highest-priority rank first
        # (rank order is class order; FIFO inside a rank).
        # engine.admit returning None is backpressure (slots or blocks
        # exhausted); retirement below frees both.
        spent = 0
        wave = []
        adopted = []  # decode role: shipped requests admitted this pass
        while True:
            queue = None
            for q in reversed(self._queues):  # highest rank first
                if q:
                    queue = q
                    break
            if queue is None:
                break
            head = queue[0]
            req = head.req
            if head.ship is not None:
                # Shipped intake: the prompt's KV arrives on the wire,
                # so admission costs no prefill compute and no budget —
                # slots/blocks backpressure alone bounds the pass.
                admitted = self.engine.admit_shipped(
                    req.request_id, len(req.prompt),
                    req.max_new_tokens, head.ship["pages"],
                )
            else:
                cost = self.engine.peek_prefill_cost(req.prompt)
                if wave and spent + cost > self.max_prefill_tokens:
                    break
                # Deploy routing at admission time: deterministic rid
                # hash picks primary vs canary; the engine pins the
                # slot so the choice survives any later swap.
                version = (
                    self.deploy.route(str(req.request_id))
                    if self.deploy is not None else None
                )
                admitted = self.engine.admit(
                    req.request_id, req.prompt, req.max_new_tokens,
                    version=version,
                )
            if admitted is None:
                # Backpressure: note the shed on the blocked head-of-line
                # waiter (its queue span will carry the reason) and emit
                # a transition-deduped instant — once per (rid, reason),
                # not once per blocked iteration.
                reason = (
                    "no_slot"
                    if self.engine.slots.free_count < 1
                    else "no_blocks"
                )
                head.sheds += 1
                head.shed_reason = reason
                shed_key = (req.request_id, reason)
                if shed_key != self._last_shed:
                    self._last_shed = shed_key
                    trace = self.registry.trace
                    if trace.enabled:
                        trace.instant(REQ_SHED, {
                            "rid": req.request_id,
                            "reason": reason,
                            "waiting": self.waiting_count,
                        })
                break
            inflight = queue.popleft()
            if inflight.ship is not None:
                inflight.slot = admitted
                inflight.version = self.engine.slot_version(admitted)
                if self.deploy is not None:
                    self._version_metrics(inflight.version)
                    self.registry.counter(
                        f"{reglib.SERVE_VERSION_REQUESTS}/"
                        f"{inflight.version}"
                    ).inc()
                adopted.append(inflight)
                continue
            slot, cached_len = admitted
            inflight.slot = slot
            inflight.cached_len = cached_len
            inflight.version = self.engine.slot_version(slot)
            if self.deploy is not None:
                self._version_metrics(inflight.version)
                self.registry.counter(
                    f"{reglib.SERVE_VERSION_REQUESTS}/"
                    f"{inflight.version}"
                ).inc()
            if self.engine.spec_tokens and self.role != "prefill":
                if self._drafter_factory is not None:
                    inflight.drafter = self._drafter_factory(req)
                else:
                    inflight.drafter = NgramDrafter(
                        req.prompt,
                        spec_tokens=self.engine.spec_tokens,
                        ngram_order=self.engine.spec_ngram_order,
                        min_match=self.engine.spec_min_match,
                    )
            spent += self.engine.padded_suffix(
                len(req.prompt), cached_len
            )
            wave.append(inflight)
        if wave:
            # Waterfall bookkeeping: the queue span ends and the prefill
            # span begins at the SAME t_wave instant, and _emit below
            # measures TTFT at the same `now` that ends the prefill
            # span — so queue + prefill sums to the measured TTFT
            # exactly (decode contributes nothing before token 1).
            trace = self.registry.trace
            t_wave = time.perf_counter()
            if trace.enabled:
                for f in wave:
                    args = {"rid": f.req.request_id}
                    if f.sheds:
                        args["sheds"] = f.sheds
                        args["shed_reason"] = f.shed_reason
                    trace.complete(
                        REQ_QUEUE, t_wave - f.t_submit,
                        ts_mono=f.t_submit, args=args,
                    )
            firsts = self.engine.prefill_batch([
                (f.slot, f.req.prompt, f.keydata[0],
                 f.req.temperature, f.req.top_k, f.req.top_p)
                for f in wave
            ])
            now = time.perf_counter()
            if trace.enabled:
                for f in wave:
                    trace.complete(
                        REQ_PREFILL, now - t_wave, ts_mono=t_wave,
                        args={
                            "rid": f.req.request_id,
                            "prompt": len(f.req.prompt),
                            "cached": f.cached_len,
                            "suffix": self.engine.padded_suffix(
                                len(f.req.prompt), f.cached_len
                            ),
                        },
                    )
            for inflight in wave:
                first = firsts[inflight.slot]
                if self.role == "prefill":
                    req = inflight.req
                    finished = (
                        req.eos_id is not None and first == req.eos_id
                    ) or req.max_new_tokens == 1
                    if finished:
                        # Done AT prefill — nothing to ship; this
                        # replica answers, exactly like monolithic.
                        self._emit(inflight, first, now)
                        self._retire(inflight, done)
                    else:
                        self._ship_out(inflight, first, t_wave, now,
                                       done)
                elif self._emit(inflight, first, now):
                    self._retire(inflight, done)  # frees slot + blocks
                else:
                    self._active[inflight.slot] = inflight
        if adopted:
            # Shipped requests adopted this pass (decode role).  Emit
            # the travelled queue/prefill legs plus the ship leg cut at
            # this instant, then the first token: its TTFT lands at
            # now - t_submit == queue_s + prefill_s + ship_s exactly
            # (all three spans and the timer read the same stamps), so
            # attribution still sums to TTFT with the wire in between.
            now = time.perf_counter()
            trace = self.registry.trace
            for f in adopted:
                s = f.ship
                t_ship = f.t_submit + s["queue_s"] + s["prefill_s"]
                ship_s = now - t_ship
                self.registry.timer(reglib.SERVE_SHIP).record(ship_s)
                if trace.enabled:
                    args = {"rid": f.req.request_id}
                    if f.sheds:
                        args["sheds"] = f.sheds
                        args["shed_reason"] = f.shed_reason
                    trace.complete(
                        REQ_QUEUE, s["queue_s"], ts_mono=f.t_submit,
                        args=args,
                    )
                    trace.complete(
                        REQ_PREFILL, s["prefill_s"],
                        ts_mono=f.t_submit + s["queue_s"],
                        args={
                            "rid": f.req.request_id,
                            "prompt": len(f.req.prompt),
                            "cached": f.cached_len,
                            "suffix": self.engine.padded_suffix(
                                len(f.req.prompt), f.cached_len
                            ),
                        },
                    )
                    trace.complete(
                        REQ_SHIP, ship_s, ts_mono=t_ship,
                        args={
                            "rid": f.req.request_id,
                            "bytes": s["bytes"],
                            "src": s["src"],
                        },
                    )
                if self.engine.spec_tokens:
                    if self._drafter_factory is not None:
                        f.drafter = self._drafter_factory(f.req)
                    else:
                        f.drafter = NgramDrafter(
                            f.req.prompt,
                            spec_tokens=self.engine.spec_tokens,
                            ngram_order=self.engine.spec_ngram_order,
                            min_match=self.engine.spec_min_match,
                        )
                if self._emit(f, s["first_token"], now):
                    self._retire(f, done)
                else:
                    self._active[f.slot] = f
        # 2. one batched decode dispatch (decode_burst tokens) for every
        # active slot.  A lane with fewer tokens left than the burst
        # passes only its remaining key rows; it finishes mid-burst and
        # the loop below discards the overrun.
        if self._active:
            burst = self.engine.decode_burst
            spec = self.engine.spec_tokens
            # A verify dispatch samples spec + 1 positions per lane; a
            # burst dispatch samples decode_burst.  The engine slices
            # the rows it needs for whichever dispatch it routes to.
            width = max(burst, spec + 1) if spec else burst
            lanes = {}
            for slot, inflight in self._active.items():
                req = inflight.req
                lane = (
                    inflight.tokens[-1],
                    inflight.keydata[
                        inflight.pos: inflight.pos + width
                    ],
                    req.temperature, req.top_k, req.top_p,
                )
                if spec:
                    draft = inflight.drafter.propose()
                    # Cap in-flight drafted tokens against the lane's
                    # remaining max_new budget: full acceptance emits
                    # accepted + 1 tokens, so at most rem - 1 drafts may
                    # stand — the rest become NO_DRAFT and can't be
                    # accepted (overrun past EOS is still possible and
                    # is discarded below, same as a burst overrun).
                    rem = req.max_new_tokens - inflight.pos
                    if rem - 1 < spec:
                        draft[max(0, rem - 1):] = NO_DRAFT
                    lane = lane + (draft,)
                lanes[slot] = lane
            t_decode = time.perf_counter()
            next_tokens = self.engine.decode_step(lanes)
            now = time.perf_counter()
            trace = self.registry.trace
            if trace.enabled:
                # One complete per lane per dispatch (plain complete()
                # calls — no contextmanager in the dispatch loop).  All
                # lanes share the dispatch wall time; "n" is what this
                # lane got out of it.
                for slot, inflight in self._active.items():
                    trace.complete(
                        REQ_DECODE, now - t_decode, ts_mono=t_decode,
                        args={
                            "rid": inflight.req.request_id,
                            "n": len(next_tokens[slot]),
                        },
                    )
            # 3. retire finished sequences (their slots are refillable
            # from the very next admission pass).
            for slot in list(self._active):
                inflight = self._active[slot]
                for token in next_tokens[slot]:
                    if self._emit(inflight, token, now):
                        del self._active[slot]
                        self._retire(inflight, done)
                        break
        # Iteration-sampled load gauges, recorded as timer distributions
        # so the server's p50/p99 surface covers them too.
        depth = float(self.waiting_count)
        self.registry.timer(reglib.SERVE_QUEUE_DEPTH).record(depth)
        self.registry.timer(reglib.SERVE_SLOT_OCCUPANCY).record(
            self.engine.slots.occupancy
        )
        if self.slo is not None:
            self.slo.observe(reglib.SERVE_QUEUE_DEPTH, depth)
            self.slo.evaluate()  # rate-limited internally
        self.registry.gauge(reglib.SERVE_BLOCKS_FREE).set(
            float(self.engine.blocks_free)
        )
        self.registry.gauge(reglib.SERVE_BLOCKS_RESIDENT).set(
            float(self.engine.blocks_resident)
        )
        self.registry.gauge(reglib.SERVE_BLOCK_FRAGMENTATION).set(
            self.engine.fragmentation()
        )
        if self.admission is not None:
            engaged = False
            if self._gate is not None:
                engaged = self._gate.update(
                    blocks_free=int(self.engine.blocks_free),
                    queue_depth=int(depth),
                )
                # Episodes are transitions counted by the gate; mirror
                # the delta into the counter (inc-only contract).
                new = self._gate.episodes - self._gate_episodes_seen
                if new > 0:
                    self.registry.counter(
                        reglib.SERVE_BACKPRESSURE_ENGAGED
                    ).inc(new)
                    self._gate_episodes_seen = self._gate.episodes
            self.registry.gauge(reglib.SERVE_BACKPRESSURE).set(
                1.0 if engaged else 0.0
            )
        return done

    def run_until_idle(self, max_steps: Optional[int] = None) -> list:
        """Drive :meth:`step` until no work remains (or ``max_steps``);
        returns every completion, submission-agnostic order."""
        done: list = []
        steps = 0
        while self.has_work:
            if max_steps is not None and steps >= max_steps:
                break
            done.extend(self.step())
            steps += 1
        return done
