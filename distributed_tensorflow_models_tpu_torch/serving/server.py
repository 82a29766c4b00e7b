"""Serving front half: request queue, worker thread, drain-on-SIGTERM.

PyTorch counterpart of ``distributed_tensorflow_models_tpu/serving/
server.py``: the front half is the JAX package's, copied; the worker half
runs the port's engine (``serving/engine.py``) on the card unless the
engine factory asks for the CPU.

This module is the torch-free zone's serving member (with ``launch.py``
and the heartbeat/backoff modules): importable on a supervisor host
with no accelerator stack, because every torch touch lives behind the
worker thread's function-level imports.  The split mirrors the rest of
the repo — stdlib front half (queueing, signals, artifacts), device
work behind one boundary.

:class:`LMServer` owns ONE worker thread that builds the engine (via
the injected factory — the caller decides model/params/slots), runs the
:class:`~.scheduler.ContinuousBatchingScheduler`, and resolves
:class:`ServeHandle`\\ s.  ``submit`` is thread-safe and non-blocking;
callers block on ``handle.result(timeout)``.

**Drain semantics** (the part a preemptible fleet cares about):
``drain()``, ``stop()``, or a SIGTERM observed through the injected
``resilience/preemption.py`` listener all flip the server into
draining: new ``submit`` calls are rejected with :class:`ServerDraining`,
everything already accepted keeps decoding until it retires, then the
worker exits — bounded by ``drain_grace_s``, after which still-unfinished
handles fail with ``TimeoutError`` instead of wedging the host past its
kill window.  On the way out the worker dumps a flight record
(``flight_recorder_p<i>.json``, reason ``serve_drain`` /
``serve_drain_timeout``) and a ``serving_stats_p<i>.json`` report with
TTFT/TPOT/queue-depth/slot-occupancy p50/p99 —
``scripts/check_metrics_schema.py --serving-report`` validates the
latter, ``--flight-recorder`` the former.

**Observability add-ons**, both torch-free and both optional:
``slo_specs`` attaches a :class:`~..telemetry.slo.SLOMonitor` the
scheduler feeds TTFT/TPOT/queue-depth samples and evaluates once per
iteration (breach counters + margin gauges + trace instants land in
this server's registry and flight record); ``timeseries_interval_s > 0``
attaches a :class:`~..telemetry.timeseries.TimeseriesWriter` appending
periodic registry snapshots + offered/served counts to
``timeseries_p<i>.jsonl`` under ``workdir`` (final row at drain).
``scripts/serving_report.py`` merges all of it — per-request
waterfalls, SLO verdicts, throughput timeline — across replicas.

**Overload controls**, attached per replica and still torch-free: an
:class:`~.admission.AdmissionPolicy` gives requests
priority classes plus deadline- and SLO-driven shedding (a shed
request still resolves, ``finish_reason="shed"`` — clients always
hear back, never a silent drop), a
:class:`~.admission.BackpressureGate` pauses intake before the KV
arena exhausts (file-queue replicas stop *claiming* while engaged, so
the backlog stays visible to peers and the autoscaler instead of
hoarded here), and ``fleet_file`` mirrors the autoscale controller's
fleet-membership transitions into this replica's own registry
(``serve/fleet_size`` gauge + scale counters) so
``--serving-report`` audits scale events from replica artifacts.

**Sampling seeds.**  A sampled request takes either an explicit
``rng`` (the int seed ``generate(seed=)`` takes) or a ``seed``, from
which the worker derives the request's own seed with
:func:`request_seed` — the port's counterpart of the JAX package's
``fold_in(key(seed), request_id)``: its served stream equals
``generate(seed=request_seed(seed, request_id))``.

Run as ``python -m distributed_tensorflow_models_tpu_torch.serving.server``
the module becomes one file-queue replica of a serving fleet (the JAX
package's ``scripts/serve_drill.py`` protocol): it claims request files
from a shared directory by atomic rename (two replicas can never both
serve one request), answers into ``resp/``, and drains cleanly when
SIGTERM'd mid-traffic.  Its engine runs on the card unless ``--device
cpu`` is given.
"""

from __future__ import annotations

import argparse
import hashlib
import itertools
import json
import logging
import os
import queue
import signal
import threading
import time
from typing import Optional

from distributed_tensorflow_models_tpu_torch.resilience.preemption import (
    PreemptionListener,
)
from distributed_tensorflow_models_tpu_torch.serving import admission as admlib
from distributed_tensorflow_models_tpu_torch.serving import deploy as deploylib
from distributed_tensorflow_models_tpu_torch.serving import shipping as shiplib
from distributed_tensorflow_models_tpu_torch.telemetry import registry as reglib
from distributed_tensorflow_models_tpu_torch.telemetry import slo as slolib
from distributed_tensorflow_models_tpu_torch.telemetry import timeseries as tslib
from distributed_tensorflow_models_tpu_torch.telemetry import trace as tracelib

log = logging.getLogger("dtm")

STATS_BASENAME = "serving_stats_p{index}.json"
TIMESERIES_BASENAME = "timeseries_p{index}.jsonl"


def request_seed(seed: int, request_id: int) -> int:
    """The sampling seed of request ``request_id`` under base ``seed``:
    the first 8 bytes of ``sha256(b"dtm-request-seed:<seed>:<request_id>")``
    read little-endian, masked to 62 bits (``key_schedule``'s own seed
    range).  Deterministic across processes and runs, so two replicas (a
    prefill and a decode one, or a monolithic one) serve the same stream
    for the same request id; the served stream equals
    ``generate(seed=request_seed(seed, request_id))``."""
    digest = hashlib.sha256(
        f"dtm-request-seed:{int(seed)}:{int(request_id)}".encode()
    ).digest()
    return int.from_bytes(digest[:8], "little") & ((1 << 62) - 1)


def serving_stats_path(workdir: str, process_index: int) -> str:
    """The per-process serving stats artifact path."""
    return os.path.join(
        workdir, STATS_BASENAME.format(index=process_index)
    )


def timeseries_path(workdir: str, process_index: int) -> str:
    """The per-process metric time-series artifact path."""
    return os.path.join(
        workdir, TIMESERIES_BASENAME.format(index=process_index)
    )


class ServerDraining(RuntimeError):
    """Raised by ``submit`` once the server is draining or stopped."""


class ServeHandle:
    """One request's future.  ``result(timeout)`` blocks for the
    :class:`~.scheduler.Completion`; failures (validation, drain
    timeout, engine death) re-raise here, on the caller's thread."""

    def __init__(self, request_id: int):
        self.request_id = request_id
        self._event = threading.Event()
        self._result = None
        self._error: Optional[BaseException] = None

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: Optional[float] = None):
        if not self._event.wait(timeout):
            raise TimeoutError(
                f"request {self.request_id} not finished in {timeout}s"
            )
        if self._error is not None:
            raise self._error
        return self._result

    # worker-side
    def _resolve(self, completion) -> None:
        self._result = completion
        self._event.set()

    def _fail(self, err: BaseException) -> None:
        self._error = err
        self._event.set()


class FleetSizeWatcher:
    """Mirror the autoscale controller's ``fleet_size.json`` into one
    replica's registry.

    The controller (``launch.FleetAutoscaler``) is the only writer of
    the file (atomic rename); each replica started with ``--fleet-file``
    polls it from its claim loop and records the membership transitions
    it OBSERVES — ``serve/fleet_size`` gauge plus ``serve/scale_up`` /
    ``serve/scale_down`` counters.  Keeping the counters replica-side
    (not only in the controller's ``scale_events.jsonl``) puts the
    scale family into ``serving_stats_p<i>.json``, where
    ``check_metrics_schema --serving-report`` enforces it
    full-set-or-absent like the other gated families."""

    __slots__ = ("path", "registry", "_last")

    def __init__(self, path: str, registry: reglib.MetricsRegistry):
        self.path = path
        self.registry = registry
        self._last: Optional[int] = None
        # Pre-create the trio so even a replica that never sees a
        # transition reports zeros, not absences.
        registry.gauge(reglib.SERVE_FLEET_SIZE)
        registry.counter(reglib.SERVE_SCALE_UP)
        registry.counter(reglib.SERVE_SCALE_DOWN)

    def poll(self) -> Optional[int]:
        """Read the file; record any size transition.  A missing or
        torn file is "no news" (the controller writes tmp+rename, so
        torn reads only happen before its first decision)."""
        try:
            with open(self.path) as f:
                size = int(json.load(f)["size"])
        except (OSError, ValueError, KeyError):
            return self._last
        if size != self._last:
            self.registry.gauge(reglib.SERVE_FLEET_SIZE).set(float(size))
            if self._last is not None:
                if size > self._last:
                    self.registry.counter(reglib.SERVE_SCALE_UP).inc(
                        size - self._last
                    )
                else:
                    self.registry.counter(reglib.SERVE_SCALE_DOWN).inc(
                        self._last - size
                    )
            self._last = size
        return size


class LMServer:
    """Request queue + one serving worker thread over one engine.

    ``engine_factory`` is called ON the worker thread (first torch touch
    happens there, keeping this module importable torch-free) and must
    return an :class:`~.engine.InferenceEngine` (which runs on the card
    unless it was built with ``device="cpu"``, and raises where no card
    is found).  Pass a ``listener``
    (installed from the main thread) to get drain-on-SIGTERM; without
    one, only ``drain()``/``stop()`` end the run.
    """

    def __init__(
        self,
        engine_factory,
        *,
        max_prefill_tokens: Optional[int] = None,
        drain_grace_s: float = 30.0,
        registry: Optional[reglib.MetricsRegistry] = None,
        listener: Optional[PreemptionListener] = None,
        workdir: Optional[str] = None,
        process_index: Optional[int] = None,
        poll_s: float = 0.02,
        trace_ring_events: int = tracelib.DEFAULT_RING_EVENTS,
        slo_specs=None,
        slo_warmup_samples: int = 0,
        slo_breach_after: int = 3,
        timeseries_interval_s: float = 0.0,
        timeseries_max_rows: int = tslib.DEFAULT_MAX_ROWS,
        role: str = "monolithic",
        handoff_dir: Optional[str] = None,
        ship_chunk_bytes: int = 1 << 20,
        admission: Optional[admlib.AdmissionPolicy] = None,
        backpressure: Optional[admlib.BackpressureGate] = None,
        fleet_file: Optional[str] = None,
        follow_checkpoints: Optional[str] = None,
        follow_poll_s: float = 0.25,
        follow_process_count: int = 1,
        canary_fraction: float = 0.25,
        canary_warmup: int = 8,
        promote_after: int = 6,
        rollback_after: int = 2,
        deploy_seed: int = 0,
        deploy_slo_specs=None,
    ):
        # Disaggregated serving (serving/shipping.py): a "prefill"
        # server runs admission + the prefill program and publishes
        # each unfinished request's KV pages as a handoff bundle; a
        # "decode" server takes intake via :meth:`submit_shipped`,
        # adopts the pages, and streams the tokens.
        if role not in ("monolithic", "prefill", "decode"):
            raise ValueError(
                f"role must be monolithic|prefill|decode, got {role!r}"
            )
        if role == "prefill" and not handoff_dir:
            raise ValueError("role='prefill' needs a handoff_dir")
        self.role = role
        self.handoff_dir = handoff_dir
        self.ship_chunk_bytes = int(ship_chunk_bytes)
        self._engine = None  # set by the worker; stats() reads pins
        self._fsck_errors: Optional[list] = None  # set at drain
        self._engine_factory = engine_factory
        self._max_prefill_tokens = max_prefill_tokens
        self.drain_grace_s = float(drain_grace_s)
        self.registry = (
            registry if registry is not None else reglib.MetricsRegistry()
        )
        if role != "monolithic":
            # Pre-create the disagg metric family so even an idle
            # prefill/decode replica reports the FULL serve/ship_* +
            # fleet split set (zeros, not absences) — the
            # full-set-when-disagg / absent-when-monolithic schema
            # contract, mirroring serve/spec_*.
            for name in (
                reglib.SERVE_SHIP_REQUESTS, reglib.SERVE_SHIP_BYTES,
                reglib.SERVE_SHIP_PAGES,
                reglib.SERVE_FLEET_PREFIX_HITS,
                reglib.SERVE_FLEET_PREFIX_MISSES,
            ):
                self.registry.counter(name)
            self.registry.timer(reglib.SERVE_SHIP)
        self._listener = listener
        self.workdir = workdir
        self.process_index = (
            int(process_index)
            if process_index is not None
            else int(os.environ.get("DTM_PROCESS_ID", "0"))
        )
        self._poll_s = float(poll_s)
        # A live tracer (unless the caller attached their own): the
        # registry's spans then mirror serve/prefill + serve/decode into
        # the ring, so the drain's flight record shows the serving
        # timeline, not an empty event list.
        if self.registry.trace is tracelib.NULL_TRACER:
            self.registry.trace = tracelib.Tracer(
                trace_ring_events, process_index=self.process_index
            )
        # SLO monitor + time-series writer: built here (torch-free, and
        # the pre-created breach/margin metrics must exist before the
        # first stats() call), driven by the worker thread.
        self._slo: Optional[slolib.SLOMonitor] = None
        if slo_specs:
            self._slo = slolib.SLOMonitor(
                list(slo_specs), self.registry,
                warmup_samples=slo_warmup_samples,
                breach_after=slo_breach_after,
            )
        self._ts_writer: Optional[tslib.TimeseriesWriter] = None
        if self.workdir and timeseries_interval_s > 0:
            os.makedirs(self.workdir, exist_ok=True)
            self._ts_writer = tslib.TimeseriesWriter(
                timeseries_path(self.workdir, self.process_index),
                self.registry,
                interval_s=timeseries_interval_s,
                max_rows=timeseries_max_rows,
            )
        # Overload controls.  Validated here, on the caller's
        # thread — the scheduler would reject the combination too, but
        # only after the worker built an engine.
        if backpressure is not None and admission is None:
            raise ValueError(
                "backpressure gating needs an admission policy"
            )
        self.admission = admission
        self.backpressure = backpressure
        # Worker mirrors the scheduler's backpressure gate into this
        # event each loop pass; the claim loop reads it cross-thread.
        self._paused = threading.Event()
        self._fleet_watch = (
            FleetSizeWatcher(fleet_file, self.registry)
            if fleet_file else None
        )
        # Continuous deployment: when follow_checkpoints
        # names a trainer checkpoint dir, the worker attaches a
        # :class:`~.deploy.CheckpointFollower` once the engine exists.
        # Candidates are gated (fsck + finite + signature) BEFORE any
        # weight touches the engine, and swaps land between scheduler
        # steps on the single worker thread — a burst boundary by
        # construction, never mid-dispatch.
        self._follow_checkpoints = follow_checkpoints
        self._follow_poll_s = float(follow_poll_s)
        self._follow_process_count = int(follow_process_count)
        self._canary_fraction = float(canary_fraction)
        self._canary_warmup = int(canary_warmup)
        self._promote_after = int(promote_after)
        self._rollback_after = int(rollback_after)
        self._deploy_seed = int(deploy_seed)
        self._deploy_slo_specs = list(deploy_slo_specs or [])
        self._follower: Optional[deploylib.CheckpointFollower] = None
        self._queue: queue.Queue = queue.Queue()
        self._ids = itertools.count()
        self._draining = threading.Event()
        self._fatal: Optional[BaseException] = None
        self._thread: Optional[threading.Thread] = None

    # -- lifecycle ---------------------------------------------------------

    @property
    def draining(self) -> bool:
        return self._draining.is_set() or (
            self._listener is not None and self._listener.preempted
        )

    @property
    def intake_paused(self) -> bool:
        """True while the scheduler's backpressure gate is engaged.
        File-queue replicas check this before claiming: a paused
        replica leaves requests on the shared queue for peers (or a
        recruited replica) instead of hoarding work its arena can't
        admit.  Event-mediated: the worker thread mirrors the gate
        after every scheduler pass."""
        return self._paused.is_set()

    def poll_fleet(self) -> Optional[int]:
        """Mirror the controller's fleet_size.json into this registry
        (no-op without ``fleet_file``); returns the last seen size."""
        if self._fleet_watch is None:
            return None
        return self._fleet_watch.poll()

    def start(self) -> None:
        if self._thread is not None:
            raise RuntimeError("server already started")
        self._thread = threading.Thread(
            target=self._run, name="serve-worker", daemon=True
        )
        self._thread.start()

    def drain(self, timeout: Optional[float] = None) -> None:
        """Stop admitting, serve out the backlog, join the worker."""
        self._draining.set()
        if self._thread is not None:
            # Grace + engine-build slack: the drain deadline only starts
            # ticking once the worker observes it.
            self._thread.join(
                timeout if timeout is not None
                else self.drain_grace_s + 60.0
            )
            if self._thread.is_alive():
                raise TimeoutError("serve worker did not drain in time")
            self._thread = None
        if self._fatal is not None:
            raise self._fatal

    def stop(self) -> None:
        self.drain()

    # -- intake ------------------------------------------------------------

    def submit(
        self,
        prompt,
        max_new_tokens: int,
        *,
        temperature: float = 0.0,
        top_k: int = 0,
        top_p: float = 1.0,
        eos_id: Optional[int] = None,
        seed: Optional[int] = None,
        rng=None,
        request_id: Optional[int] = None,
        priority: str = "",
        deadline_s: Optional[float] = None,
    ) -> ServeHandle:
        """Enqueue one request; returns its :class:`ServeHandle`.

        Sampling requests take either an explicit ``rng`` (the int seed
        a solo ``generate(seed=)`` takes) or a ``seed``, from which the
        worker derives the request's own seed
        :func:`request_seed(seed, request_id) <request_seed>`.

        ``priority`` names an admission class ("" = the policy's
        default; ignored without a policy) and ``deadline_s`` bounds
        queue wait — a request still waiting that long past submit is
        shed with ``finish_reason="shed"`` instead of served late.
        """
        if self.role == "decode":
            raise ValueError(
                "a decode-role server takes intake only via "
                "submit_shipped (raw prompts belong on a prefill or "
                "monolithic replica)"
            )
        if self.draining:
            raise ServerDraining("server is draining; not accepting work")
        if self._thread is None:
            raise RuntimeError("server not started")
        rid = int(request_id) if request_id is not None else next(self._ids)
        handle = ServeHandle(rid)
        self._queue.put(
            (
                handle,
                {
                    "prompt": [int(t) for t in prompt],
                    "max_new_tokens": int(max_new_tokens),
                    "temperature": float(temperature),
                    "top_k": int(top_k),
                    "top_p": float(top_p),
                    "eos_id": eos_id,
                    "seed": seed,
                    "rng": rng,
                    "priority": str(priority),
                    "deadline_s": (
                        float(deadline_s) if deadline_s is not None
                        else None
                    ),
                },
            )
        )
        return handle

    def submit_shipped(self, meta: dict, leaves: dict) -> ServeHandle:
        """Decode-role intake: enqueue one claimed handoff bundle
        (already unpacked — ``meta``/``leaves`` straight from
        :func:`~.shipping.claim_bundle`).  The worker rebases the
        travelled stamps into this process's clock and adopts the KV
        pages through ``engine.admit_shipped``; the handle resolves
        with the full token stream, first token included."""
        if self.role != "decode":
            raise ValueError(
                "submit_shipped is decode-role intake only"
            )
        if self.draining:
            raise ServerDraining("server is draining; not accepting work")
        if self._thread is None:
            raise RuntimeError("server not started")
        handle = ServeHandle(int(meta["request_id"]))
        self._queue.put((handle, {"shipped": (dict(meta), leaves)}))
        return handle

    # -- reporting ---------------------------------------------------------

    def stats(self) -> dict:
        """Serving report: the registry snapshot (every timer flattens
        with p50/p95/p99 — the p99 surface SLOs key on comes straight
        from ``snapshot()``).  Touches each serving key first so the
        report ALWAYS carries the full set — an idle server reports
        zeros, not absences (the ``--serving-report`` schema contract).
        serve/spec_* and serve/slo_* stay full-set-or-absent: they are
        created by the spec-on engine / the attached SLO monitor, never
        here."""
        for name in (
            reglib.SERVE_REQUESTS, reglib.SERVE_TOKENS,
            reglib.SERVE_COMPLETED,
            reglib.SERVE_PREFIX_CACHE_HITS,
            reglib.SERVE_PREFIX_CACHE_MISSES,
            reglib.SERVE_PREFIX_CACHE_EVICTIONS,
        ):
            self.registry.counter(name)
        for name in (
            reglib.SERVE_BLOCKS_FREE, reglib.SERVE_BLOCKS_RESIDENT,
            reglib.SERVE_BLOCK_FRAGMENTATION,
        ):
            self.registry.gauge(name)
        for name in (
            reglib.SERVE_TTFT, reglib.SERVE_TPOT, reglib.SERVE_PREFILL,
            reglib.SERVE_DECODE, reglib.SERVE_QUEUE_DEPTH,
            reglib.SERVE_SLOT_OCCUPANCY,
        ):
            self.registry.timer(name)
        # Compiled-program pins, on EVERY report regardless of role:
        # a monolithic replica shows (1, N), a prefill replica must
        # show (1, 0) and a decode replica (0, 1) — the drill asserts
        # the role split added no compiled programs.
        engine = self._engine
        counts = engine.compile_counts() if engine is not None else (0, 0)
        self.registry.gauge(reglib.SERVE_COMPILED_PREFILL).set(
            float(counts[0])
        )
        self.registry.gauge(reglib.SERVE_COMPILED_DECODE).set(
            float(counts[1])
        )
        snap = self.registry.snapshot()
        # Cache effectiveness, computed (not stored): block-granular
        # hit fraction of all matchable pages seen; 0.0 when cold/off.
        hits = self.registry.counter(reglib.SERVE_PREFIX_CACHE_HITS).value
        misses = self.registry.counter(
            reglib.SERVE_PREFIX_CACHE_MISSES
        ).value
        snap[reglib.SERVE_PREFIX_CACHE_HIT_RATE] = (
            hits / (hits + misses) if hits + misses > 0 else 0.0
        )
        out = {
            "version": 1,
            "process_index": self.process_index,
            "role": self.role,
            "draining": self.draining,
            "metrics": snap,
        }
        if self._fsck_errors is not None:
            # Arena audit at drain (both ends of every ship ran it):
            # refcount/eviction correctness under concurrent shipping.
            out["fsck_errors"] = self._fsck_errors
        return out

    def write_stats(self, path: str) -> None:
        tmp = f"{path}.{os.getpid()}.tmp"
        with open(tmp, "w") as f:
            json.dump(self.stats(), f)
        os.replace(tmp, path)

    # -- worker ------------------------------------------------------------

    def _fail_queue(self, err: BaseException) -> None:
        while True:
            try:
                handle, _ = self._queue.get_nowait()
            except queue.Empty:
                return
            handle._fail(err)

    def _admit(self, sched, pending, handle, spec) -> None:
        try:
            from distributed_tensorflow_models_tpu_torch.serving.scheduler import (
                Request,
            )

            if "shipped" in spec:
                # A claimed handoff bundle: no rng rebuild (the seed
                # schedule travelled as wire data, int64 seeds as uint32
                # halves), stamps rebased from the prefill replica's wall
                # clock into this process's monotonic frame HERE — the
                # scheduler stays inside dtm-lint's determinism scope,
                # this module does not.
                meta, leaves = spec["shipped"]
                pages = dict(leaves)
                keydata = shiplib.seeds_from_wire(pages.pop("__keydata__"))
                self.registry.counter(reglib.SERVE_SHIP_REQUESTS).inc()
                self.registry.counter(reglib.SERVE_SHIP_BYTES).inc(
                    int(meta.get("wire_bytes", 0))
                )
                if pages:
                    self.registry.counter(reglib.SERVE_SHIP_PAGES).inc(
                        next(iter(pages.values())).shape[0]
                    )
                sched.submit_shipped(
                    Request(
                        request_id=int(meta["request_id"]),
                        prompt=meta["prompt"],
                        max_new_tokens=int(meta["max_new_tokens"]),
                        temperature=float(meta["temperature"]),
                        top_k=int(meta["top_k"]),
                        top_p=float(meta["top_p"]),
                        eos_id=meta["eos_id"],
                    ),
                    pages=pages,
                    keydata=keydata,
                    first_token=int(meta["first_token"]),
                    t_submit=shiplib.mono_of_wall(
                        float(meta["t_submit_wall"])
                    ),
                    queue_s=float(meta["queue_s"]),
                    prefill_s=float(meta["prefill_s"]),
                    cached_len=int(meta.get("cached_len", 0)),
                    wire_bytes=int(meta.get("wire_bytes", 0)),
                    src_replica=int(meta.get("src_replica", -1)),
                )
                pending[handle.request_id] = handle
                return

            rng = spec["rng"]
            if rng is None and spec["temperature"] > 0:
                seed = spec["seed"] if spec["seed"] is not None else 0
                rng = request_seed(seed, handle.request_id)
            sched.submit(
                Request(
                    request_id=handle.request_id,
                    prompt=spec["prompt"],
                    max_new_tokens=spec["max_new_tokens"],
                    temperature=spec["temperature"],
                    top_k=spec["top_k"],
                    top_p=spec["top_p"],
                    eos_id=spec["eos_id"],
                    rng=rng,
                    priority=spec["priority"],
                    deadline_s=spec["deadline_s"],
                )
            )
            pending[handle.request_id] = handle
        except Exception as e:  # noqa: BLE001 — a bad request fails ITS
            handle._fail(e)  # handle, never the serving loop

    def _pull(self, sched, pending) -> None:
        while True:
            try:
                handle, spec = self._queue.get_nowait()
            except queue.Empty:
                return
            self._admit(sched, pending, handle, spec)

    def _make_ship_callback(self, engine):
        """The prefill scheduler's ship hook: export the slot's prompt
        KV, pack it with everything decode needs (sampling knobs, key
        schedule, first token, travel-safe wall stamps), and publish it
        into the handoff directory.  Runs on the worker thread while
        the slot is still allocated."""

        def ship_out(inflight, first_token, t_wave, now):
            t0 = time.perf_counter()
            req = inflight.req
            plen, pages = engine.export_slot(inflight.slot)
            meta = {
                "kind": "request",
                "request_id": int(req.request_id),
                "prompt": [int(t) for t in req.prompt],
                "max_new_tokens": int(req.max_new_tokens),
                "temperature": float(req.temperature),
                "top_k": int(req.top_k),
                "top_p": float(req.top_p),
                "eos_id": (
                    int(req.eos_id) if req.eos_id is not None else None
                ),
                "first_token": int(first_token),
                "prompt_len": int(plen),
                "cached_len": int(inflight.cached_len),
                "queue_s": t_wave - inflight.t_submit,
                "prefill_s": now - t_wave,
                "t_submit_wall": shiplib.wall_of_mono(inflight.t_submit),
                "src_replica": self.process_index,
            }
            leaves = dict(pages)
            leaves["__keydata__"] = shiplib.seeds_to_wire(inflight.keydata)
            data = shiplib.pack_bundle(meta, leaves)
            shiplib.publish_bundle(
                self.handoff_dir, req.request_id, data,
                chunk_bytes=self.ship_chunk_bytes,
            )
            n_pages = (
                next(iter(pages.values())).shape[0] if pages else 0
            )
            self.registry.timer(reglib.SERVE_SHIP).record(
                time.perf_counter() - t0
            )
            self.registry.counter(reglib.SERVE_SHIP_REQUESTS).inc()
            self.registry.counter(reglib.SERVE_SHIP_BYTES).inc(len(data))
            self.registry.counter(reglib.SERVE_SHIP_PAGES).inc(n_pages)

        return ship_out

    def _run(self) -> None:
        try:
            engine = self._engine_factory()
            # Adopt the engine into this server's registry unless the
            # factory attached its own — otherwise the prefill/decode
            # spans would land in the process-global default and the
            # drain artifacts would miss them.
            if engine.registry is reglib.get_registry():
                engine.registry = self.registry
                # The ctor pre-created any speculation metrics in the
                # registry we just swapped out; re-create them here so
                # an idle spec-on server still reports the full
                # serve/spec_* set (and a spec-off one reports none).
                engine._ensure_spec_metrics()
            from distributed_tensorflow_models_tpu_torch.serving.scheduler import (
                ContinuousBatchingScheduler,
            )

            self._engine = engine
            follower = None
            if self._follow_checkpoints:
                follower = deploylib.CheckpointFollower(
                    self._follow_checkpoints,
                    engine,
                    workdir=self.workdir or ".",
                    process_index=self.process_index,
                    registry=self.registry,
                    process_count=self._follow_process_count,
                    canary_fraction=self._canary_fraction,
                    seed=self._deploy_seed,
                    canary_warmup=self._canary_warmup,
                    promote_after=self._promote_after,
                    rollback_after=self._rollback_after,
                    slo_specs=self._deploy_slo_specs,
                    poll_interval_s=self._follow_poll_s,
                )
                self._follower = follower
            sched = ContinuousBatchingScheduler(
                engine,
                max_prefill_tokens=self._max_prefill_tokens,
                registry=self.registry,
                slo_monitor=self._slo,
                role=self.role,
                ship=(
                    self._make_ship_callback(engine)
                    if self.role == "prefill" else None
                ),
                admission=self.admission,
                backpressure=self.backpressure,
                deploy=follower,
            )
        except BaseException as e:  # noqa: BLE001 — surface via drain()
            self._fatal = e
            self._draining.set()
            self._fail_queue(e)
            log.exception("serve worker failed to build its engine")
            return
        pending: dict = {}
        deadline = None
        timed_out = False
        while True:
            draining = self.draining
            if draining and deadline is None:
                deadline = time.perf_counter() + self.drain_grace_s
                self.registry.trace.instant(
                    "serve/drain",
                    {
                        "pending": len(pending),
                        "queued": self._queue.qsize(),
                        "waiting": sched.waiting_count,
                        "active": sched.active_count,
                    },
                )
                log.warning(
                    "serving drain: %d in flight, %d queued, grace %.1fs",
                    len(pending) + sched.waiting_count
                    + self._queue.qsize(),
                    self._queue.qsize(),
                    self.drain_grace_s,
                )
            self._pull(sched, pending)
            if sched.intake_paused:
                self._paused.set()
            else:
                self._paused.clear()
            if self._ts_writer is not None:
                self._ts_writer.maybe_write()  # rate-limited internally
            if follower is not None and not draining:
                # Between sched.step() calls = a burst boundary: no
                # dispatch is in flight, so a swap can never tear a
                # request's weights.  Clock reads stay HERE — deploy.py
                # sits inside dtm-lint's determinism scope and only
                # ever receives timestamps.
                follower.poll(time.perf_counter(), time.time())
            if sched.has_work:
                for comp in sched.step():
                    handle = pending.pop(comp.request_id, None)
                    if handle is not None:
                        handle._resolve(comp)
                if (
                    draining
                    and time.perf_counter() > deadline
                    and sched.has_work
                ):
                    timed_out = True
                    break
            elif draining and self._queue.empty():
                break
            else:
                try:
                    handle, spec = self._queue.get(timeout=self._poll_s)
                except queue.Empty:
                    continue
                self._admit(sched, pending, handle, spec)
        if timed_out:
            err = TimeoutError(
                f"serve drain exceeded {self.drain_grace_s}s grace"
            )
            for handle in pending.values():
                handle._fail(err)
            self._fail_queue(err)
        try:
            # Arena audit on the way out: every refcount/eviction
            # invariant must hold on BOTH ends of every ship — the
            # stats artifact carries the verdict for the drill.
            self._fsck_errors = engine.fsck()
        except Exception:  # noqa: BLE001 — forensics must not crash drain
            log.exception("arena fsck failed at drain")
            self._fsck_errors = ["fsck raised; see log"]
        self._finalize(
            "serve_drain_timeout" if timed_out else "serve_drain"
        )

    def _finalize(self, reason: str) -> None:
        if not self.workdir:
            return
        try:
            os.makedirs(self.workdir, exist_ok=True)
            if self._ts_writer is not None:
                self._ts_writer.write_row()  # final point at drain
            self.write_stats(
                serving_stats_path(self.workdir, self.process_index)
            )
            self.registry.trace.dump_flight_record(
                tracelib.flight_record_path(
                    self.workdir, self.process_index
                ),
                reason,
                registry=self.registry,
            )
        except OSError:  # forensics must not turn a drain into a crash
            log.exception("serving artifacts not written")


# --------------------------------------------------------------------------
# File-queue replica mode
# --------------------------------------------------------------------------
#
# Protocol, all under --queue-dir: the parent writes req-<id>.json files
# plus a DONE sentinel; each replica claims a request by atomically
# renaming it into claimed/ (suffixed .p<replica> — the rename either
# fully succeeds or another replica already owns it, so exactly one
# serves it), answers into resp/req-<id>.json (tmp + rename, torn-read
# safe), and exits when DONE is present, nothing is left to claim, and
# its own in-flight work is resolved.  A SIGTERM'd replica stops
# claiming, drains what it owns, writes those responses, and exits 0 —
# no response is missing or duplicated.


DRILL_MODEL = dict(vocab_size=64, num_layers=2, num_heads=2, d_model=32,
                   d_ff=64, dropout_rate=0.0)


def drill_model(max_len: int = 64, seed: int = 0):
    """The replica's model: the JAX drill's ``transformer_lm`` widths
    (vocabulary 64, 2 layers, 2 heads, d_model 32, d_ff 64), f32, plain
    attention, initialised on the CPU from a generator seeded ``seed`` (0
    for every replica, so all hold the same weights; the serve drill's
    deploy arm seeds its candidates by step)."""
    import torch

    from distributed_tensorflow_models_tpu_torch.models import get_model

    return get_model(
        "transformer_lm", **DRILL_MODEL, max_len=max_len,
        dtype=torch.float32, attn_impl="reference",
        generator=torch.Generator().manual_seed(seed),
    )


def _drill_engine_factory(args, role: str = "monolithic"):
    """Tiny deterministic LM (:func:`drill_model` — replicas identical) on
    ``args.device`` (the card unless ``--device cpu``)."""

    def build():
        import math

        from distributed_tensorflow_models_tpu_torch.serving.engine import (
            InferenceEngine,
        )

        max_len = getattr(args, "max_len", 64)
        model = drill_model(max_len)
        fleet = None
        if getattr(args, "fleet_cache_dir", None) and role == "prefill":
            # Same page-size resolution the engine ctor applies — the
            # index's chain digests are page-granular, so every prefill
            # replica must agree on the page size.
            page = args.kv_page_tokens or math.gcd(
                max_len, args.prefill_chunk
            )
            fleet = shiplib.FleetPrefixIndex(
                args.fleet_cache_dir, page,
                max_entries=args.fleet_cache_entries,
            )
        engine = InferenceEngine(
            model, device=getattr(args, "device", "cuda"),
            max_slots=args.max_slots,
            prefill_chunk=args.prefill_chunk,
            decode_burst=args.decode_burst,
            prefill_lanes=args.prefill_lanes,
            kv_page_tokens=args.kv_page_tokens,
            kv_pool_blocks=args.kv_pool_blocks,
            prefix_cache=args.prefix_cache == "on",
            prefix_cache_blocks=args.prefix_cache_blocks,
            spec_tokens=args.spec_tokens,
            spec_ngram_order=args.spec_ngram_order,
            spec_min_match=args.spec_min_match,
            fleet_cache=fleet,
        )
        stall_ms = getattr(args, "stall_prefill_ms", 0.0)
        if stall_ms:
            # SLO-drill fault injection: throttle every prefill wave.
            # The sleep lands inside the scheduler's per-request prefill
            # span, so the stall shows up attributed (waterfalls still
            # sum to TTFT) and provably trips a TTFT SLO breach.
            real_prefill = engine.prefill_batch

            def throttled_prefill(items):
                time.sleep(stall_ms / 1000.0)
                return real_prefill(items)

            engine.prefill_batch = throttled_prefill
        stall_version = getattr(args, "stall_version", None)
        stall_version_ms = getattr(args, "stall_canary_ms", 0.0)
        if stall_version is not None and stall_version_ms:
            # Deploy-drill fault injection: stall only the waves that
            # carry the named weight version.  While that version
            # canaries, its routed fraction's TTFT regresses and the
            # per-version SLO monitor breaches; primary traffic keeps
            # its latency, proving the rollback verdict is attributed
            # to the candidate, not the fleet.
            vic = int(stall_version)
            real_prefill = engine.prefill_batch

            def version_stalled_prefill(items):
                if any(
                    engine.slot_version(item[0]) == vic
                    for item in items
                ):
                    time.sleep(stall_version_ms / 1000.0)
                return real_prefill(items)

            engine.prefill_batch = version_stalled_prefill
        return engine

    return build


def _claim_one(queue_dir: str, claimed_dir: str, replica: int):
    """Claim the oldest unclaimed request file, or None.  The atomic
    rename is the exactly-once guarantee: losing the race to a peer is
    a skip, never an error."""
    for name in sorted(os.listdir(queue_dir)):
        if not (name.startswith("req-") and name.endswith(".json")):
            continue
        src = os.path.join(queue_dir, name)
        dst = os.path.join(claimed_dir, f"{name}.p{replica}")
        try:
            os.rename(src, dst)
        except OSError:
            continue  # peer won the race
        with open(dst) as f:
            return name, json.load(f)
    return None


def _unclaim(queue_dir: str, claimed_dir: str, name: str, replica: int):
    try:
        os.rename(
            os.path.join(claimed_dir, f"{name}.p{replica}"),
            os.path.join(queue_dir, name),
        )
    except OSError:  # pragma: no cover — duplicate drains are benign
        log.exception("unclaim of %s failed", name)


def _write_response(resp_dir: str, rid: int, payload: dict) -> None:
    path = os.path.join(resp_dir, f"req-{rid}.json")
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "w") as f:
        json.dump(payload, f)
    os.replace(tmp, path)


def _replica_main(args) -> int:
    replica = int(os.environ.get("DTM_PROCESS_ID", "0"))
    role_map = [
        r.strip() for r in args.role_map.split(",") if r.strip()
    ] if args.role_map else []
    for r in role_map:
        if r not in ("monolithic", "prefill", "decode"):
            raise SystemExit(f"bad --role-map entry {r!r}")
    role = role_map[replica] if replica < len(role_map) else "monolithic"
    n_prefill = role_map.count("prefill")
    if args.fleet_cache_dir and "prefill" not in role_map:
        raise SystemExit(
            "--fleet-cache-dir needs a disaggregated --role-map with "
            "at least one prefill replica"
        )
    handoff_dir = args.handoff_dir or os.path.join(
        args.queue_dir, "handoff"
    )
    claimed_dir = os.path.join(args.queue_dir, "claimed")
    resp_dir = os.path.join(args.queue_dir, "resp")
    os.makedirs(claimed_dir, exist_ok=True)
    os.makedirs(resp_dir, exist_ok=True)
    admission = None
    if args.priority_classes:
        admission = admlib.AdmissionPolicy(
            tuple(
                c.strip() for c in args.priority_classes.split(",")
                if c.strip()
            ),
            default=args.default_class or None,
            shed_on_slo=tuple(args.shed_on_slo),
            max_shed_per_step=args.max_shed_per_step,
        )
    gate = None
    if (
        args.backpressure_engage_blocks is not None
        or args.backpressure_engage_queue is not None
    ):
        if admission is None:
            raise SystemExit(
                "backpressure flags need --priority-classes (the gate "
                "rides on the admission-enabled scheduler)"
            )
        gate = admlib.BackpressureGate(
            engage_blocks_free=args.backpressure_engage_blocks,
            release_blocks_free=args.backpressure_release_blocks,
            engage_queue_depth=args.backpressure_engage_queue,
            release_queue_depth=args.backpressure_release_queue,
        )
    listener = PreemptionListener(signals=(signal.SIGTERM,))
    listener.install()
    server = LMServer(
        _drill_engine_factory(args, role),
        max_prefill_tokens=args.max_prefill_tokens,
        drain_grace_s=args.drain_grace_s,
        listener=listener,
        workdir=args.workdir,
        process_index=replica,
        trace_ring_events=args.trace_ring_events,
        slo_specs=args.slo,
        slo_warmup_samples=args.slo_warmup,
        slo_breach_after=args.slo_breach_after,
        timeseries_interval_s=args.timeseries_interval_s,
        role=role,
        handoff_dir=handoff_dir if role == "prefill" else None,
        ship_chunk_bytes=args.ship_chunk_bytes,
        admission=admission,
        backpressure=gate,
        fleet_file=args.fleet_file,
        follow_checkpoints=args.follow_checkpoints,
        follow_poll_s=args.follow_poll_s,
        follow_process_count=args.follow_process_count,
        canary_fraction=args.canary_fraction,
        canary_warmup=args.canary_warmup,
        promote_after=args.promote_after,
        rollback_after=args.rollback_after,
        deploy_seed=args.deploy_seed,
        deploy_slo_specs=args.deploy_slo or args.slo,
    )
    server.start()
    outstanding: dict = {}  # request_id -> (handle, request name)
    responded = 0
    handled = 0  # responded + shipped — the drill victim's trigger
    sigterm_sent = False
    deadline = time.perf_counter() + args.timeout

    def resolve_finished(block: bool) -> int:
        nonlocal responded, handled
        n = 0
        for rid in list(outstanding):
            handle, name = outstanding[rid]
            if not block and not handle.done():
                continue
            try:
                comp = handle.result(
                    timeout=args.drain_grace_s + 60.0 if block else None
                )
            except Exception as e:  # noqa: BLE001 — drill asserts on the
                log.error("request %d failed: %s", rid, e)  # missing resp
                del outstanding[rid]
                continue
            if comp.finish_reason == "shipped":
                # The handoff bundle IS the answer: a decode replica
                # claims it and writes the response.  Writing one here
                # too would be the duplicate the drill hunts for.
                del outstanding[rid]
                handled += 1
                n += 1
                continue
            _write_response(
                resp_dir, rid,
                {
                    "request_id": rid,
                    "tokens": comp.tokens,
                    "finish_reason": comp.finish_reason,
                    "ttft_s": comp.ttft_s,
                    "tpot_s": comp.tpot_s,
                    "replica": replica,
                    # The weight version this request was pinned to at
                    # admission — the deploy drill replays each
                    # surviving stream against a solo generate() with
                    # exactly this checkpoint's params.
                    "version": getattr(comp, "version", 0),
                },
            )
            del outstanding[rid]
            responded += 1
            handled += 1
            n += 1
        return n

    exit_reason = "deadline"
    while time.perf_counter() < deadline:
        if listener.preempted:
            exit_reason = "preempted"
            break
        server.poll_fleet()  # no-op without --fleet-file
        # Claim backpressure: never hold more than two arenas' worth of
        # unresolved work.  Claim-ahead would hoard requests a peer
        # replica could be serving — and everything hoarded becomes
        # drain debt when this replica is SIGTERM'd.  The scheduler's
        # arena/queue gate pauses claiming the same way: while engaged,
        # requests stay on the shared queue where peers (and the
        # autoscaler's backlog signal) can still see them.
        can_claim = (
            len(outstanding) < 2 * args.max_slots
            and not server.intake_paused
        )
        if role == "decode":
            # A decode replica's intake is the handoff directory: claim
            # a bundle by atomic rename (exactly-once across peers),
            # adopt its pages, stream the tokens.
            got = (
                shiplib.claim_bundle(handoff_dir, replica)
                if can_claim else None
            )
            if got is not None:
                name, meta, leaves = got
                try:
                    meta["wire_bytes"] = os.path.getsize(os.path.join(
                        handoff_dir, shiplib.CLAIMED_DIR,
                        f"{name}.p{replica}",
                    ))
                except OSError:
                    meta["wire_bytes"] = 0
                try:
                    handle = server.submit_shipped(meta, leaves)
                    outstanding[meta["request_id"]] = (handle, name)
                except ServerDraining:
                    # SIGTERM won the race between claim and adopt:
                    # hand the bundle back for a surviving decoder.
                    shiplib.unclaim_bundle(handoff_dir, name, replica)
                    exit_reason = "drain_race"
                    break
        else:
            got = (
                _claim_one(args.queue_dir, claimed_dir, replica)
                if can_claim else None
            )
            if got is not None:
                name, spec = got
                try:
                    handle = server.submit(
                        spec["prompt"], spec["max_new_tokens"],
                        temperature=spec.get("temperature", 0.0),
                        top_k=spec.get("top_k", 0),
                        top_p=spec.get("top_p", 1.0),
                        eos_id=spec.get("eos_id"),
                        seed=spec.get("seed"),
                        request_id=spec["request_id"],
                        priority=spec.get("priority", ""),
                        deadline_s=spec.get("deadline_s"),
                    )
                    outstanding[spec["request_id"]] = (handle, name)
                except ServerDraining:
                    # SIGTERM won the race between claim and submit: hand
                    # the request back for the surviving replica.
                    _unclaim(args.queue_dir, claimed_dir, name, replica)
                    exit_reason = "drain_race"
                    break
        resolve_finished(block=False)
        if (
            args.self_sigterm_after
            and replica == args.sigterm_replica
            and handled >= args.self_sigterm_after
            and not sigterm_sent
        ):
            sigterm_sent = True
            log.warning(
                "replica %d self-delivering SIGTERM after %d handled "
                "(drill victim)", replica, handled,
            )
            os.kill(os.getpid(), signal.SIGTERM)
        if got is None:
            done = os.path.exists(os.path.join(args.queue_dir, "DONE"))
            if role == "decode":
                # "handoff dir empty" only means "no bundles EVER
                # again" once every prefill replica marked done.
                done = done and shiplib.prefill_done_count(
                    handoff_dir
                ) >= n_prefill
            if done and not outstanding and can_claim:
                # Only exit on a GENUINE empty claim attempt.  When
                # backpressure suppressed this iteration's claim, a
                # completion burst may just have emptied `outstanding`
                # — loop once more so the freed capacity re-checks the
                # queue, else both replicas can strand its tail.
                exit_reason = "queue_drained"
                break
            listener.wait(args.poll_s)
    # Drain: everything this replica claimed must be answered (or
    # shipped) before it exits — the drill's no-dropped-responses
    # assertion.  A prefill replica marks its no-more-bundles sentinel
    # on EVERY exit path, else decode replicas could wait forever.
    try:
        resolve_finished(block=True)
        server.drain()
    finally:
        if role == "prefill":
            shiplib.mark_prefill_done(handoff_dir, replica)
    listener.uninstall()
    log.info(
        "replica %d (%s) exiting (%s): %d responses, %d handled",
        replica, role, exit_reason, responded, handled,
    )
    _report_r1_launches(args.workdir, replica, role, args.device)
    return 0


def r1_launches_path(workdir: str, process_index: int) -> str:
    return os.path.join(workdir, f"r1_launches_p{process_index}.json")


def _report_r1_launches(workdir: str, replica: int, role: str,
                        device: str) -> None:
    """R1's launches in this replica by form (its wrapper's counters:
    launches on the card, replays of a captured program included; 0 where
    the CPU ran the plain version), printed on one line and written to
    :func:`r1_launches_path` for the fleet's drill."""
    from distributed_tensorflow_models_tpu_torch.ops import rowwise

    line = json.dumps({
        "replica": replica, "role": role, "device": device,
        "r1_launches": {form: getattr(rowwise.row_matmul,
                                      f"{form}_launches")
                        for form in ("wgmma", "simt")},
    })
    print(line, flush=True)
    path = r1_launches_path(workdir, replica)
    with open(f"{path}.tmp", "w") as f:
        f.write(line + "\n")
    os.replace(f"{path}.tmp", path)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="file-queue serving replica"
    )
    p.add_argument("--queue-dir", required=True)
    p.add_argument("--workdir", required=True)
    p.add_argument(
        "--device", default="cuda",
        help="the engine's device: the card (default; raises where no "
        "CUDA device is found) or 'cpu'",
    )
    p.add_argument("--max-slots", type=int, default=4)
    p.add_argument("--prefill-chunk", type=int, default=8)
    p.add_argument(
        "--decode-burst", type=int, default=1,
        help="decode tokens per device dispatch (multi-step "
        "scheduling); 1 = per-token admission, larger bursts trade "
        "admission latency for dispatch amortization",
    )
    p.add_argument(
        "--prefill-lanes", type=int, default=1,
        help="requests prefilled per dispatch of the one prefill "
        "program (batched prefill lanes); 1 = serial prefill",
    )
    p.add_argument(
        "--kv-page-tokens", type=int, default=None,
        help="KV block size in tokens; must divide max_len (default: "
        "gcd(max_len, prefill_chunk))",
    )
    p.add_argument(
        "--kv-pool-blocks", type=int, default=None,
        help="total pool blocks incl. sentinel (default: one max_len "
        "reservation per slot + sentinel)",
    )
    p.add_argument(
        "--prefix-cache", choices=("on", "off"), default="on",
        help="radix prefix cache: reuse resident prompt pages across "
        "requests without re-prefill",
    )
    p.add_argument(
        "--prefix-cache-blocks", type=int, default=None,
        help="bound on cache-resident blocks (default: unbounded; "
        "eviction is LRU either way)",
    )
    p.add_argument(
        "--spec-tokens", type=int, default=0,
        help="speculative decoding: draft tokens verified per dispatch "
        "(0 = off; on costs one extra compiled decode instance)",
    )
    p.add_argument(
        "--spec-ngram-order", type=int, default=3,
        help="longest suffix n-gram the self-drafter matches",
    )
    p.add_argument(
        "--spec-min-match", type=int, default=1,
        help="shortest suffix match worth proposing a draft for",
    )
    p.add_argument(
        "--role-map", default="",
        help="comma list of replica roles indexed by DTM_PROCESS_ID, "
        "e.g. 'prefill,decode' (empty = every replica monolithic); "
        "prefill replicas ship finished prompts' KV pages through the "
        "handoff dir, decode replicas adopt them and stream tokens",
    )
    p.add_argument(
        "--handoff-dir", default=None,
        help="KV handoff bundle directory (default: "
        "<queue-dir>/handoff)",
    )
    p.add_argument(
        "--fleet-cache-dir", default=None,
        help="fleet-wide prefix index directory: prefill replicas "
        "advertise resident prompt pages here so any replica's hit "
        "serves the whole fleet (default: off; needs a disaggregated "
        "--role-map)",
    )
    p.add_argument(
        "--fleet-cache-entries", type=int, default=None,
        help="bound on fleet index entries, evicted mtime-LRU "
        "(default: unbounded)",
    )
    p.add_argument(
        "--ship-chunk-bytes", type=int, default=1 << 20,
        help="bundle write syscall granularity — payload streams out "
        "in chunks of this many bytes",
    )
    p.add_argument(
        "--max-len", type=int, default=64,
        help="drill model context length (must hold prompt + max_new)",
    )
    p.add_argument("--max-prefill-tokens", type=int, default=None)
    p.add_argument("--drain-grace-s", type=float, default=30.0)
    p.add_argument(
        "--slo", action="append", default=[],
        help="SLO spec '[name=]key:pQQ<threshold@WINDOWs' (repeatable), "
        "e.g. serve/ttft_s:p99<0.25@30s — see telemetry/slo.py",
    )
    p.add_argument(
        "--slo-warmup", type=int, default=0,
        help="per-key observations dropped before SLO windows fill "
        "(cold-start compile spikes would pin a short window's p99)",
    )
    p.add_argument(
        "--slo-breach-after", type=int, default=3,
        help="consecutive failing evaluations before a breach fires "
        "(hysteresis; the drill sets 1 so a single stalled wave trips)",
    )
    p.add_argument(
        "--timeseries-interval-s", type=float, default=0.0,
        help="append a registry snapshot row to timeseries_p<i>.jsonl "
        "every N seconds (0 = off)",
    )
    p.add_argument(
        "--trace-ring-events", type=int,
        default=tracelib.DEFAULT_RING_EVENTS,
        help="request-trace ring capacity; per-request lifecycle spans "
        "cost ~3 + tokens/decode_burst events per request, size the "
        "ring to cover the window a post-mortem needs",
    )
    p.add_argument(
        "--priority-classes", default="",
        help="comma list of admission classes ordered lowest→highest "
        "priority, e.g. 'batch,standard,interactive' (empty = "
        "admission off: plain FIFO, no shedding)",
    )
    p.add_argument(
        "--default-class", default="",
        help="class assumed for requests that name none (default: the "
        "middle of --priority-classes)",
    )
    p.add_argument(
        "--shed-on-slo", action="append", default=[],
        help="SLO name (repeatable) whose breach authorizes shedding "
        "the lowest-priority queued requests; must match an --slo name",
    )
    p.add_argument(
        "--max-shed-per-step", type=int, default=1,
        help="SLO-shed quota per scheduler step — paces load-shedding "
        "so one breached window can't empty the queue",
    )
    p.add_argument(
        "--backpressure-engage-blocks", type=int, default=None,
        help="pause intake when arena blocks_free <= this (pair with "
        "--backpressure-release-blocks; needs --priority-classes)",
    )
    p.add_argument(
        "--backpressure-release-blocks", type=int, default=None,
        help="resume intake only once blocks_free > this (must exceed "
        "the engage threshold — the hysteresis band)",
    )
    p.add_argument(
        "--backpressure-engage-queue", type=int, default=None,
        help="pause intake when scheduler queue depth >= this (pair "
        "with --backpressure-release-queue)",
    )
    p.add_argument(
        "--backpressure-release-queue", type=int, default=None,
        help="resume intake only once queue depth < this (must be "
        "below the engage threshold)",
    )
    p.add_argument(
        "--fleet-file", default=None,
        help="autoscale controller's fleet_size.json: poll it and "
        "mirror membership transitions into this replica's "
        "serve/fleet_size + serve/scale_up|down metrics",
    )
    p.add_argument(
        "--stall-prefill-ms", type=float, default=0.0,
        help="fault injection: sleep this long before every prefill "
        "wave (an SLO drill uses it to force a TTFT breach)",
    )
    p.add_argument(
        "--follow-checkpoints", default=None,
        help="trainer checkpoint directory to follow for continuous "
        "deployment: newly fleet-valid steps are gated (fsck + finite "
        "+ signature match), canaried on a deterministic traffic fraction, "
        "and promoted or rolled back on SLO verdicts — all without a "
        "restart or recompile",
    )
    p.add_argument(
        "--follow-poll-s", type=float, default=0.25,
        help="checkpoint-follower scan/evaluate cadence",
    )
    p.add_argument(
        "--follow-process-count", type=int, default=1,
        help="trainer process count the fleet-valid sidecar check "
        "expects (1 = single-process trainer, no sidecars)",
    )
    p.add_argument(
        "--canary-fraction", type=float, default=0.25,
        help="deterministic (seeded, rid-hashed) traffic fraction "
        "routed to a canarying candidate version",
    )
    p.add_argument(
        "--canary-warmup", type=int, default=8,
        help="canary-routed samples observed before SLO verdicts "
        "count toward promotion (breach evidence accrues even during "
        "warmup — a bad candidate never hides behind it)",
    )
    p.add_argument(
        "--promote-after", type=int, default=6,
        help="consecutive clean canary evaluations before promotion",
    )
    p.add_argument(
        "--rollback-after", type=int, default=2,
        help="consecutive breached canary evaluations before rollback",
    )
    p.add_argument(
        "--deploy-seed", type=int, default=0,
        help="seed for the rid-hash canary router (replicas sharing a "
        "seed make identical routing decisions)",
    )
    p.add_argument(
        "--deploy-slo", action="append", default=[],
        help="SLO spec (repeatable, same grammar as --slo) evaluated "
        "against the CANARY version's own samples (default: reuse "
        "--slo specs)",
    )
    p.add_argument(
        "--stall-version", type=int, default=None,
        help="fault injection: stall prefill waves carrying this "
        "weight version (pair with --stall-canary-ms; a deploy drill "
        "uses it to force an SLO-breach rollback)",
    )
    p.add_argument(
        "--stall-canary-ms", type=float, default=0.0,
        help="how long each stalled --stall-version wave sleeps",
    )
    p.add_argument(
        "--self-sigterm-after", type=int, default=0,
        help="after N responses, deliver SIGTERM to self (drill victim)",
    )
    p.add_argument(
        "--sigterm-replica", type=int, default=-1,
        help="which replica index self-SIGTERMs (default: none)",
    )
    p.add_argument("--poll-s", type=float, default=0.05)
    p.add_argument(
        "--timeout", type=float, default=300.0,
        help="hard wall bound on the claim loop",
    )
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    return _replica_main(args)


if __name__ == "__main__":
    raise SystemExit(main())
