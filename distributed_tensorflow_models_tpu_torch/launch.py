"""Multi-process launcher: a localhost fleet, its supervision and restarts.

PyTorch counterpart of ``distributed_tensorflow_models_tpu/launch.py``.
Every process runs the same program; the only per-process facts are
``(coordinator_address, num_processes, process_id)``, carried in the
``DTM_*`` environment variables.  This module provides:

- :func:`initialize_from_env` — process-side bootstrap: starts the fleet
  heartbeat (``resilience/heartbeat.py``) and joins this process to the
  others' ``torch.distributed`` group (``core/mesh.py::
  initialize_multihost``);
- :func:`launch_local` — spawn an N-process cluster on localhost, child
  *i* on ``cuda:i`` (``LOCAL_RANK=i``), as a *supervisor*: children
  heartbeat, and a dead or stalled child tears the fleet down in seconds
  (SIGTERM → grace → SIGKILL) instead of leaving survivors hung in
  collectives;
- :func:`supervise_local` — the fleet restart loop (relaunch +
  checkpoint auto-resume, deterministic-jitter backoff, elastic resize);
- a CLI: ``python -m distributed_tensorflow_models_tpu_torch.launch``.

- :class:`FleetAutoscaler` — the closed-loop serving scale controller
  (``launch_local(scale_controller=...)``): tails the replicas' own
  telemetry artifacts, feeds a pure hysteresis policy, and recruits or
  drains replicas mid-stream with the exactly-once file-queue protocol
  guaranteeing no response is dropped or duplicated.

A preempted training process exits with :data:`RESUMABLE_EXIT_CODE`.
This module imports torch only inside :func:`initialize_from_env`'s join,
so a supervisor (and the autoscaler) never loads it.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import signal
import subprocess
import sys
from typing import Mapping, Optional, Sequence

log = logging.getLogger("dtm")

ENV_COORDINATOR = "DTM_COORDINATOR_ADDRESS"
ENV_NUM_PROCESSES = "DTM_NUM_PROCESSES"
ENV_PROCESS_ID = "DTM_PROCESS_ID"
# Read by the JAX package (fake CPU devices per process); the port runs one
# device per process and ignores it.
ENV_CPU_DEVICES = "DTM_CPU_DEVICES_PER_PROCESS"
# The local device index torch's launchers set; the port's
# initialize_from_env puts the process on cuda:{LOCAL_RANK}.
ENV_LOCAL_RANK = "LOCAL_RANK"

DEFAULT_PORT = 9671

# How long a SIGTERM'd fleet gets to drain (emergency checkpoints) before
# the supervisor SIGKILLs the stragglers.  A process hung in a dead
# peer's collective never reaches its chunk-boundary preemption poll — the
# KILL is what actually ends it; a healthy process exits resumable well
# inside the default.
DEFAULT_TERM_GRACE_S = 15.0
_MONITOR_POLL_S = 0.2

# Exit code a preempted-but-checkpointed training process uses (BSD
# EX_TEMPFAIL), the JAX package's: the run wrote an emergency checkpoint
# on SIGTERM and rerunning the same command resumes it, so a launcher
# tells "rerun me" from a failure.
RESUMABLE_EXIT_CODE = 75


def aggregate_exit_codes(codes) -> int:
    """Cluster exit code: a real failure always wins over "preempted"
    (one resumable child must not relabel another child's crash as
    resumable), preempted wins over success, all-zero is success."""
    failures = [c for c in codes if c not in (0, RESUMABLE_EXIT_CODE)]
    if failures:
        return max(failures)
    if RESUMABLE_EXIT_CODE in codes:
        return RESUMABLE_EXIT_CODE
    return 0


def initialize_from_env(device=None) -> bool:
    """Start the heartbeat and join the process group the ``DTM_*``
    variables describe.

    The fleet heartbeat (``DTM_HEARTBEAT_DIR``, set by the supervising
    launcher) starts first, before torch is imported and the group
    joined, so the supervisor sees a first beat within about a second of
    spawn and a child that dies while joining is still attributable; a
    no-op without the variable.

    Returns False, and joins nothing, when the environment carries no
    cluster facts (a single process: the common case).  Otherwise joins
    the group of ``DTM_NUM_PROCESSES`` processes as ``DTM_PROCESS_ID``
    through the store at ``DTM_COORDINATOR_ADDRESS`` (``host:port``) and
    returns True.  ``device`` is this process's device: by default
    ``cuda:{LOCAL_RANK or 0}`` over NCCL; ``"cpu"`` joins over gloo."""
    coord = os.environ.get(ENV_COORDINATOR)
    nproc = os.environ.get(ENV_NUM_PROCESSES)
    pid = os.environ.get(ENV_PROCESS_ID)

    from distributed_tensorflow_models_tpu_torch.resilience import heartbeat

    heartbeat.start_from_env(int(pid) if pid else 0)

    if not (coord and nproc and pid):
        return False

    from distributed_tensorflow_models_tpu_torch.core.mesh import (
        initialize_multihost,
    )

    initialize_multihost(coord, int(nproc), int(pid), device=device)
    return True


def _terminate_fleet(
    procs: Sequence[subprocess.Popen],
    codes: dict[int, int],
    grace_s: float,
) -> None:
    """SIGTERM every still-running child (→ their preemption-grace
    emergency checkpoints, where reachable), wait up to ``grace_s``,
    SIGKILL the stragglers (a process hung in a dead peer's collective
    never reaches its chunk-boundary poll).  Fills ``codes``."""
    import time

    for i, p in enumerate(procs):
        if i not in codes and p.poll() is None:
            try:
                p.terminate()
            except OSError:  # already reaped
                pass
    deadline = time.monotonic() + grace_s
    while time.monotonic() < deadline:
        if all(
            i in codes or p.poll() is not None for i, p in enumerate(procs)
        ):
            break
        time.sleep(_MONITOR_POLL_S)
    for i, p in enumerate(procs):
        if i in codes:
            continue
        if p.poll() is None:
            sys.stderr.write(
                f"--- fleet: process {i} did not exit within the "
                f"{grace_s:.0f}s grace period; killing it ---\n"
            )
            p.kill()
            p.wait()
        codes[i] = p.returncode


class FleetAutoscaler:
    """Closed-loop scale controller for ``launch_local`` serving fleets.

    The serving replicas publish their load as artifacts (that is the
    whole observability design): ``timeseries_p<i>.jsonl`` rows carry
    each replica's cumulative ``offered``/``served`` counters plus the
    instantaneous gauges (``serve/blocks_free``, ``serve/slo_margin/*``),
    and the shared file queue holds whatever no replica has claimed
    yet.  This controller tails both from the *supervisor* process —
    no RPC into the replicas — folds them into one backlog figure::

        backlog = unclaimed queue files
                + Σ offered_i − Σ served_i     (claimed but unfinished)

    and feeds it to an :class:`~.serving.admission.AutoscalePolicy`
    (pure hysteresis: consecutive-observation streaks + cooldown, so a
    single spike cannot flap the fleet).  ``launch_local`` invokes
    :meth:`decide` from its monitor loop and performs the mechanics
    (spawn / SIGTERM-drain); the policy object only ever says +1/-1/0.

    Every decision leaves a full forensic trail in ``workdir``:

    - ``scale_events.jsonl`` — one line per decision with the
      triggering signal values (``serving_report.py`` renders the
      timeline against throughput),
    - ``flight_autoscale_<k>.json`` — a flight-recorder dump whose
      ring holds every evaluation instant leading up to decision k,
    - ``fleet_size.json`` (atomic rename) — the commitment replicas
      started with ``--fleet-file`` mirror into their own registries
      (``serve/fleet_size`` + ``serve/scale_up|down``).

    torch-free and wall-clock-stamping by design: like
    ``telemetry/timeseries.py`` this file is deliberately OUTSIDE
    dtm-lint's determinism scope — event logs need wall time; the
    *decisions* come from the pure policy, which is inside it.
    """

    def __init__(
        self,
        workdir: str,
        *,
        policy=None,
        queue_dir: Optional[str] = None,
        poll_interval_s: float = 0.5,
        fleet_file: Optional[str] = None,
        ring_events: int = 512,
    ):
        from distributed_tensorflow_models_tpu_torch.serving import (
            admission as admlib,
        )
        from distributed_tensorflow_models_tpu_torch.telemetry import (
            registry as reglib,
        )
        from distributed_tensorflow_models_tpu_torch.telemetry import (
            trace as tracelib,
        )

        self.workdir = workdir
        self.queue_dir = queue_dir
        self.policy = (
            policy if policy is not None else admlib.AutoscalePolicy()
        )
        self.poll_interval_s = float(poll_interval_s)
        self.fleet_file = fleet_file or os.path.join(
            workdir, "fleet_size.json"
        )
        self.events_path = os.path.join(workdir, "scale_events.jsonl")
        self.events = 0
        self._last_poll = float("-inf")
        self._size_written: Optional[int] = None
        # Controller-side registry + tracer: the flight record dumped at
        # each decision carries the evaluation instants that led to it.
        self._registry = reglib.MetricsRegistry()
        self._registry.trace = tracelib.Tracer(ring_events)

    # -- signal collection -------------------------------------------------

    @staticmethod
    def _tail_row(path: str) -> Optional[dict]:
        """Last parseable row of one replica's timeseries file."""
        try:
            with open(path, "rb") as f:
                lines = f.read().splitlines()
        except OSError:
            return None
        for raw in reversed(lines):
            try:
                row = json.loads(raw)
            except ValueError:
                continue  # torn tail line: take the previous row
            if isinstance(row, dict):
                return row
        return None

    def signals(self, live: Sequence[int]) -> dict:
        """Fold the fleet's artifacts into the autoscale inputs."""
        offered = served = 0.0
        blocks_free = None
        margins: dict = {}
        per_replica: dict = {}
        for i in live:
            row = self._tail_row(
                os.path.join(self.workdir, f"timeseries_p{i}.jsonl")
            )
            if row is None:
                continue
            offered += float(row.get("offered", 0.0))
            served += float(row.get("served", 0.0))
            bf = row.get("serve/blocks_free")
            if bf is not None:
                blocks_free = (
                    bf if blocks_free is None else min(blocks_free, bf)
                )
            for key, val in row.items():
                if key.startswith("serve/slo_margin/"):
                    name = key.rsplit("/", 1)[-1]
                    margins[name] = min(
                        margins.get(name, float("inf")), float(val)
                    )
            per_replica[i] = {
                "offered": row.get("offered", 0.0),
                "served": row.get("served", 0.0),
                "blocks_free": bf,
            }
        unclaimed = 0
        if self.queue_dir is not None:
            try:
                unclaimed = sum(
                    1
                    for name in os.listdir(self.queue_dir)
                    if name.startswith("req-") and name.endswith(".json")
                )
            except OSError:
                unclaimed = 0
        return {
            "backlog": unclaimed + max(0.0, offered - served),
            "unclaimed": unclaimed,
            "offered": offered,
            "served": served,
            "blocks_free": blocks_free,
            "slo_margins": margins,
            "slo_breached": sorted(
                n for n, m in margins.items() if m < 0.0
            ),
            "per_replica": per_replica,
        }

    # -- commitment --------------------------------------------------------

    def _write_fleet_file(self, size: int) -> None:
        import time

        if size == self._size_written:
            return
        tmp = f"{self.fleet_file}.{os.getpid()}.tmp"
        with open(tmp, "w") as f:
            json.dump({"size": int(size), "ts_wall": time.time()}, f)
        os.replace(tmp, self.fleet_file)
        self._size_written = size

    def decide(self, live: Sequence[int]) -> int:
        """One monitor-loop tick: returns +1 (recruit a replica), -1
        (drain one), or 0.  Rate-limited to ``poll_interval_s``; the
        caller owns the process mechanics and victim choice."""
        import time

        now = time.perf_counter()
        if self._size_written is None:
            # Initial commitment only: afterwards the fleet file tracks
            # DECISIONS, never observed liveness — a draining victim is
            # still live for a few ticks, and mirroring that back would
            # flap the file (and the replicas' scale counters) without
            # any scale event having happened.
            self._write_fleet_file(len(live))
        if now - self._last_poll < self.poll_interval_s or not live:
            return 0
        self._last_poll = now
        sig = self.signals(live)
        delta = self.policy.observe(
            replicas=len(live),
            backlog=sig["backlog"],
            slo_breached=bool(sig["slo_breached"]),
        )
        self._registry.trace.instant(
            "autoscale/evaluate",
            {
                "replicas": len(live),
                "backlog": sig["backlog"],
                "unclaimed": sig["unclaimed"],
                "blocks_free": sig["blocks_free"],
                "slo_breached": sig["slo_breached"],
                "delta": delta,
            },
        )
        if delta == 0:
            return 0
        event = "scale_up" if delta > 0 else "scale_down"
        record = {
            "ts_wall": time.time(),
            "event": event,
            "from_size": len(live),
            "to_size": len(live) + delta,
            "live": sorted(int(i) for i in live),
            **{k: v for k, v in sig.items() if k != "per_replica"},
            "per_replica": sig["per_replica"],
        }
        with open(self.events_path, "a") as f:
            f.write(json.dumps(record) + "\n")
        self._registry.trace.instant(f"autoscale/{event}", dict(record))
        self._registry.trace.dump_flight_record(
            os.path.join(
                self.workdir, f"flight_autoscale_{self.events}.json"
            ),
            f"autoscale_{event}",
            registry=self._registry,
        )
        self.events += 1
        self._write_fleet_file(len(live) + delta)
        sys.stderr.write(
            f"--- fleet: autoscale {event} {len(live)} -> "
            f"{len(live) + delta} (backlog {sig['backlog']:.0f}, "
            f"unclaimed {sig['unclaimed']}, slo_breached "
            f"{sig['slo_breached']}) ---\n"
        )
        return delta


def launch_local(
    num_processes: int,
    argv: Sequence[str],
    *,
    port: int = DEFAULT_PORT,
    cpu_devices_per_process: int | None = None,
    extra_env: Mapping[str, str] | None = None,
    timeout: float | None = None,
    heartbeat_timeout: float | None = None,
    term_grace_s: float = DEFAULT_TERM_GRACE_S,
    startup_stats: Optional[dict] = None,
    scale_controller: Optional[FleetAutoscaler] = None,
) -> list[int]:
    """Spawn ``num_processes`` copies of ``argv`` as a localhost cluster.

    Each child gets the ``DTM_*`` cluster facts and ``LOCAL_RANK=i`` in
    its environment (so the port's :func:`initialize_from_env` puts
    process *i* on ``cuda:i``); process 0's stdout/stderr pass through,
    the rest stream into temp files and are replayed only on failure.
    Files, not pipes: a sequentially-drained pipe back-pressures a chatty
    child into blocking mid-step, which stalls the whole cluster at its
    next collective.  ``timeout`` bounds the *total* wall time of the
    cluster, not each child.  Returns the exit codes.

    **Supervision.**  The launcher polls the fleet instead of waiting on
    children in order: the moment any child dies with a real failure
    (exit not 0/75 — e.g. a ``kill -9``), the survivors are SIGTERM'd
    promptly and SIGKILL'd after ``term_grace_s``.  Each child also gets
    a heartbeat directory (``DTM_HEARTBEAT_DIR``;
    ``resilience/heartbeat.py`` — started by ``initialize_from_env``,
    stepped by ``fit``, and read back by the chief's ``fleet/*``
    gauges); with ``heartbeat_timeout`` set, a child whose heartbeat
    goes stale that long (wedged, not dead) triggers the same fleet
    teardown, attributed to its process index.  Only pass
    ``heartbeat_timeout`` for commands that actually heartbeat — i.e.
    anything calling ``initialize_from_env`` — and size it over the
    slowest expected gap (the writer thread beats through the torch
    import, kernel builds and the capture on its own).

    **Startup MTTR.**  Pass ``startup_stats`` (a dict, filled in place
    per process index) to stamp the relaunch-to-first-step milestones
    off the heartbeat files: ``first_beat_s`` (spawn → first heartbeat,
    i.e. process up), ``loop_entry_s`` (spawn → step ≥ 0, i.e. restore +
    setup done, entering the train loop) and ``first_step_s`` (spawn →
    first observed step *advance* past the entry step).  Readings are at
    heartbeat-interval resolution; ``first_step_s`` may be absent when
    chunks outrun the heartbeat cadence.

    **Closed-loop autoscale** (serving fleets).  Pass a
    :class:`FleetAutoscaler` as ``scale_controller`` and the monitor
    polls it each round: +1 spawns one more child at a FRESH process
    index (same command/env recipe — file-queue replicas join the
    shared queue and start claiming immediately), -1 SIGTERMs the
    highest-index live child, whose drain path answers everything it
    already claimed and exits 0 — the monitor treats that like any
    benign exit, the fleet keeps running, and the exactly-once queue
    protocol guarantees no response is dropped or duplicated across
    the membership change.  The returned code list covers every child
    ever spawned, not just the initial ``num_processes``.

    ``cpu_devices_per_process`` (the JAX package's fake CPU devices) has
    no meaning here and raises.
    """
    import shutil
    import tempfile
    import time

    from distributed_tensorflow_models_tpu_torch.resilience import heartbeat

    if cpu_devices_per_process is not None:
        raise ValueError(
            "cpu_devices_per_process has no meaning in the port: each "
            "process runs one device (cuda:LOCAL_RANK, or the CPU when the "
            "command asks for it, e.g. --device cpu)")
    procs: list[subprocess.Popen] = []
    logs: list = []
    hb_dir = tempfile.mkdtemp(prefix="dtm-heartbeat-")
    t0_wall = time.time()

    def _spawn(i: int) -> None:
        """Spawn child i (initial fleet member or autoscale recruit —
        a recruit gets a fresh, never-reused process index so its
        artifacts and queue claims can't collide with history)."""
        env = dict(os.environ)
        env[ENV_COORDINATOR] = f"127.0.0.1:{port}"
        env[ENV_NUM_PROCESSES] = str(max(num_processes, i + 1))
        env[ENV_PROCESS_ID] = str(i)
        env[ENV_LOCAL_RANK] = str(i)
        env[heartbeat.ENV_HEARTBEAT_DIR] = hb_dir
        if extra_env:
            env.update(extra_env)
        log_file = None
        if i != 0:
            log_file = tempfile.TemporaryFile(
                mode="w+", prefix=f"dtm-launch-{i}-"
            )
        logs.append(log_file)
        procs.append(
            subprocess.Popen(
                list(argv),
                env=env,
                stdout=None if i == 0 else log_file,
                stderr=None if i == 0 else subprocess.STDOUT,
            )
        )

    def _stamp_startup() -> None:
        """Relaunch-to-first-step milestones from the heartbeat files
        (see the docstring); called once per poll round.  Times come from
        each beat's own write timestamp (payload ``time``), not this
        reader's clock, so a milestone observed only by a later poll is
        still stamped when it was written."""
        for i, view in enumerate(heartbeat.read_fleet(hb_dir, len(procs))):
            if view is None:
                continue
            at = round(float(view.get("time", 0.0)) - t0_wall, 3)
            st = startup_stats.setdefault(i, {})
            st.setdefault("first_beat_s", at)
            step = int(view.get("step", -1))
            if step >= 0 and "loop_entry_s" not in st:
                st["loop_entry_s"] = at
                st["_entry_step"] = step
            if (
                "loop_entry_s" in st
                and "first_step_s" not in st
                and step > st["_entry_step"]
            ):
                st["first_step_s"] = at

    try:
        for i in range(num_processes):
            _spawn(i)
        deadline = None if timeout is None else time.monotonic() + timeout
        codes: dict[int, int] = {}
        failure: Optional[tuple[int, str]] = None
        while len(codes) < len(procs):
            if deadline is not None and time.monotonic() > deadline:
                raise subprocess.TimeoutExpired(argv, timeout)
            if startup_stats is not None:
                _stamp_startup()
            for i, p in enumerate(procs):
                if i in codes:
                    continue
                rc = p.poll()
                if rc is None:
                    continue
                codes[i] = rc
                if rc not in (0, RESUMABLE_EXIT_CODE) and failure is None:
                    try:
                        why = f"died on {signal.Signals(-rc).name}"
                    except ValueError:
                        why = f"exited {rc}"
                    failure = (i, why)
            if failure is not None:
                break
            if heartbeat_timeout is not None and len(codes) < len(procs):
                views = heartbeat.read_fleet(hb_dir, len(procs))
                for i in range(len(procs)):
                    if i in codes:
                        continue
                    view = views[i]
                    age = (
                        view["age_s"]
                        if view is not None
                        else time.time() - t0_wall
                    )
                    if age > heartbeat_timeout:
                        # Step + phase from the heartbeat payload: the
                        # stall is attributed ("frozen at step 40 in
                        # phase save") without traces.
                        failure = (
                            i,
                            f"heartbeat stale for {age:.1f}s "
                            f"(> {heartbeat_timeout:.1f}s; last step "
                            f"{'?' if view is None else view.get('step')}, "
                            "phase "
                            f"{'?' if view is None else view.get('phase', '?')})",
                        )
                        break
            if failure is not None:
                break
            if scale_controller is not None:
                live = [
                    i for i, p in enumerate(procs)
                    if i not in codes and p.poll() is None
                ]
                delta = scale_controller.decide(live)
                if delta > 0:
                    # Recruit: fresh max index, same command — the new
                    # replica joins the shared queue mid-stream.
                    _spawn(len(procs))
                elif delta < 0 and len(live) > 1:
                    # Drain the newest live replica: SIGTERM stops its
                    # claiming, it answers what it owns, exits 0.
                    victim = max(live)
                    sys.stderr.write(
                        f"--- fleet: autoscale draining process "
                        f"{victim} (SIGTERM; it answers its claimed "
                        "work, then exits) ---\n"
                    )
                    try:
                        procs[victim].terminate()
                    except OSError:  # exited between poll and signal
                        pass
            time.sleep(_MONITOR_POLL_S)
        if failure is not None:
            i, why = failure
            sys.stderr.write(
                f"--- fleet: process {i} {why}; terminating the rest of "
                "the fleet (survivors take the emergency-checkpoint "
                "grace path where reachable) ---\n"
            )
            # A stalled (still-running) culprit gets the same
            # SIGTERM-then-SIGKILL as its peers.
            _terminate_fleet(procs, codes, term_grace_s)
        if startup_stats is not None:
            # One last read: the final beats (written right up to child
            # exit) may carry the first step advance the poll missed.
            _stamp_startup()
            for st in startup_stats.values():
                st.pop("_entry_step", None)
        code_list = [codes[i] for i in range(len(procs))]
        for i, rc in enumerate(code_list):
            if rc == RESUMABLE_EXIT_CODE:
                # Preemption grace, not a failure: the child checkpointed
                # and asked to be rerun — don't dump its log as a crash.
                sys.stderr.write(
                    f"--- process {i} preempted (exit {rc}): "
                    "resumable — rerun the same command ---\n"
                )
            elif rc != 0 and i != 0:
                logs[i].seek(0)
                sys.stderr.write(
                    f"--- process {i} (exit {rc}) ---\n"
                    f"{logs[i].read()}\n"
                )
        return code_list
    except BaseException:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        raise
    finally:
        for log_file in logs:
            if log_file is not None:
                log_file.close()
        shutil.rmtree(hb_dir, ignore_errors=True)


def supervise_local(
    num_processes: int,
    argv: Sequence[str],
    *,
    max_restarts: int = 2,
    backoff_base_s: float = 1.0,
    backoff_max_s: float = 60.0,
    seed: int = 0,
    port: int = DEFAULT_PORT,
    resize_to: int | None = None,
    auto_resize: bool = False,
    follow_checkpoints: str | None = None,
    **launch_kwargs,
) -> int:
    """``launch_local`` under the fleet restart loop: a fleet torn down
    for a real failure (one process killed/stalled) is relaunched — same
    command, so every child auto-resumes from the latest checkpoint —
    up to ``max_restarts`` times, spaced by the deterministic-jitter
    backoff ``recoverable_fit`` uses for in-process restarts
    (``resilience/backoff.py``).  Per-process failure attribution goes to
    stderr each round.  Returns the final aggregate exit code; an
    all-preempted fleet (aggregate 75) returns immediately — the fleet
    was *told* to die, and the rerun belongs to whoever told it.

    Each relaunch bumps the coordinator port by one: the dead chief's
    listener can linger in TIME_WAIT, and a bind failure would burn a
    whole restart on launcher misfortune.

    Every round stamps the fleet's startup MTTR (spawn → loop entry →
    first step, from the heartbeat files — ``launch_local``'s
    ``startup_stats``) to stderr; the precise per-process numbers are the
    ``startup`` section of each run's ``telemetry.json``.

    Elastic resize: ``resize_to=M`` relaunches every restart at M
    processes instead of N — the children's cross-topology restore
    (``harness/checkpoint.py``) re-splits the dataset cursor, so a fleet
    that lost (or gained) capacity keeps training instead of
    crash-looping at a process count it can no longer field.
    ``auto_resize=True`` shrinks the fleet by the number of distinct
    failed processes on each relaunch (floor 1).  The children must still
    satisfy the batch contract (global batch divisible by the new process
    count) — pick M accordingly.

    These two resize paths are *reactive* (a failure already happened).
    For serving fleets there is a third, *proactive* path: pass a
    :class:`FleetAutoscaler` through ``launch_kwargs`` as
    ``scale_controller`` and each launch scales WITHIN the run from
    scheduler telemetry — no failure, no relaunch, no dropped work.
    The controller object is reused across relaunches, so its
    hysteresis state and scale-event numbering survive a restart.

    ``follow_checkpoints=<dir>`` appends ``--follow-checkpoints <dir>`` to
    every child's argv: serving replicas (``serving/server.py``, including
    ones the autoscaler recruits mid-run, which clone the same argv) then
    follow the trainer's checkpoint directory, gating, canarying and
    promoting new weights live.  The flag rides the argv so a fleet
    restart keeps following too (the port's training CLI does not take
    it)."""
    import time

    from distributed_tensorflow_models_tpu_torch.resilience import backoff

    if resize_to is not None and resize_to < 1:
        raise ValueError(f"resize_to must be >= 1, got {resize_to}")
    if follow_checkpoints:
        argv = list(argv) + ["--follow-checkpoints", follow_checkpoints]
    attempt = 0
    cur_procs = num_processes
    while True:
        stats: dict = {}
        codes = launch_local(
            cur_procs, argv, port=port + attempt,
            startup_stats=stats, **launch_kwargs
        )
        if stats:
            worst = max(
                (
                    st.get("first_step_s") or st.get("loop_entry_s") or 0.0
                    for st in stats.values()
                ),
                default=0.0,
            )
            sys.stderr.write(
                f"--- fleet startup MTTR ("
                f"{'relaunch' if attempt else 'launch'} {attempt}): "
                f"slowest spawn→first-step {worst:.1f}s; per process "
                + " ".join(f"p{i}={stats[i]}" for i in sorted(stats))
                + " ---\n"
            )
        agg = aggregate_exit_codes(codes)
        if agg in (0, RESUMABLE_EXIT_CODE):
            return agg
        failed = {
            i: c
            for i, c in enumerate(codes)
            if c not in (0, RESUMABLE_EXIT_CODE)
        }
        attempt += 1
        if attempt > max_restarts:
            sys.stderr.write(
                f"--- fleet: giving up after {max_restarts} restart(s); "
                f"failed processes {failed} ---\n"
            )
            return agg
        delay = backoff.restart_backoff(
            attempt, base_s=backoff_base_s, max_s=backoff_max_s, seed=seed
        )
        next_procs = cur_procs
        if resize_to is not None:
            next_procs = resize_to
        elif auto_resize:
            # Treat each distinct failed process as capacity that is not
            # coming back; the resized fleet resumes cross-topology.
            next_procs = max(1, cur_procs - len(failed))
        if next_procs != cur_procs:
            sys.stderr.write(
                f"--- fleet: RESIZING {cur_procs} -> {next_procs} "
                "process(es) on relaunch; children resume across the "
                "topology change (dataset cursor re-split to the "
                "fleet-minimum position) ---\n"
            )
            cur_procs = next_procs
        sys.stderr.write(
            f"--- fleet: process(es) {sorted(failed)} failed "
            f"(exit codes {failed}); relaunching the whole fleet in "
            f"{delay:.2f}s (restart {attempt}/{max_restarts}, "
            f"coordinator port {port + attempt}, {cur_procs} "
            "process(es)) ---\n"
        )
        time.sleep(delay)


def main(argv: Sequence[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m distributed_tensorflow_models_tpu_torch.launch",
        description=(
            "Launch a command as an N-process torch.distributed cluster. "
            "Localhost mode spawns all processes (process i on cuda:i); "
            "multi-host mode (--process-id given) configures this process "
            "only — run the same command on every host with its own "
            "--process-id."
        ),
    )
    parser.add_argument("--num-processes", type=int, required=True)
    parser.add_argument(
        "--coordinator",
        default=f"127.0.0.1:{DEFAULT_PORT}",
        help="host:port of process 0's rendezvous store",
    )
    parser.add_argument(
        "--process-id",
        type=int,
        default=None,
        help="multi-host mode: this host's process index; omit for "
        "localhost mode (spawns all processes here)",
    )
    parser.add_argument(
        "--max-restarts",
        type=int,
        default=0,
        help="localhost mode: relaunch the whole fleet (auto-resuming "
        "from checkpoints) up to N times after a real failure — the "
        "fleet-level recoverable_fit (0 = launch once)",
    )
    parser.add_argument(
        "--resize-to",
        type=int,
        default=None,
        help="localhost mode, with --max-restarts: relaunch at this "
        "process count after a failure (elastic resize; children "
        "resume across the topology change from the latest checkpoint)",
    )
    parser.add_argument(
        "--auto-resize",
        action="store_true",
        help="localhost mode, with --max-restarts: shrink the fleet by "
        "the number of failed processes on each relaunch (floor 1)",
    )
    parser.add_argument(
        "--autoscale-workdir",
        default=None,
        help="localhost mode: enable the closed-loop serving "
        "autoscaler — tail timeseries_p<i>.jsonl under this workdir "
        "for backlog/SLO signals and scale the fleet within the run "
        "(writes scale_events.jsonl, flight_autoscale_<k>.json and "
        "fleet_size.json there)",
    )
    parser.add_argument(
        "--autoscale-queue-dir",
        default=None,
        help="with --autoscale-workdir: also count unclaimed req-*.json "
        "files in this file-queue directory as backlog",
    )
    parser.add_argument(
        "--autoscale-min", type=int, default=1,
        help="autoscaler floor on live replicas (default 1)",
    )
    parser.add_argument(
        "--autoscale-max", type=int, default=4,
        help="autoscaler ceiling on live replicas (default 4)",
    )
    parser.add_argument(
        "--autoscale-up-backlog", type=float, default=4.0,
        help="scale up when backlog per replica exceeds this",
    )
    parser.add_argument(
        "--autoscale-down-backlog", type=float, default=1.0,
        help="scale down when backlog per replica stays under this",
    )
    parser.add_argument(
        "--autoscale-interval", type=float, default=0.5,
        help="seconds between autoscaler evaluations",
    )
    parser.add_argument(
        "--follow-checkpoints",
        default=None,
        help="localhost mode: append '--follow-checkpoints DIR' to "
        "every child's argv — serving replicas then live-adopt the "
        "trainer's newly fleet-valid checkpoints (gate, canary, "
        "SLO-verdict promote/rollback) with no restart or recompile",
    )
    parser.add_argument(
        "--heartbeat-timeout",
        type=float,
        default=None,
        help="localhost mode: tear the fleet down when any child's "
        "heartbeat goes stale this many seconds (stalled-process "
        "detection; only for commands that initialize_from_env)",
    )
    parser.add_argument(
        "--term-grace",
        type=float,
        default=DEFAULT_TERM_GRACE_S,
        help="seconds a SIGTERM'd fleet gets to write emergency "
        f"checkpoints before SIGKILL (default {DEFAULT_TERM_GRACE_S:g})",
    )
    parser.add_argument("command", nargs=argparse.REMAINDER)
    args = parser.parse_args(argv)

    command = args.command
    if command and command[0] == "--":
        command = command[1:]
    if not command:
        parser.error("no command given (append: -- python your_script.py)")

    host, sep, port_str = args.coordinator.rpartition(":")
    if not sep or not port_str.isdigit():
        parser.error(
            f"--coordinator must be host:port, got {args.coordinator!r}"
        )

    if args.process_id is None:
        if host not in ("127.0.0.1", "localhost"):
            parser.error(
                "localhost mode spawns every process here; a non-local "
                f"--coordinator host ({host!r}) requires --process-id "
                "(run once per host)"
            )
        controller = None
        if args.autoscale_workdir:
            from distributed_tensorflow_models_tpu_torch.serving import (
                admission as admlib,
            )

            controller = FleetAutoscaler(
                args.autoscale_workdir,
                policy=admlib.AutoscalePolicy(
                    min_replicas=args.autoscale_min,
                    max_replicas=args.autoscale_max,
                    up_backlog=args.autoscale_up_backlog,
                    down_backlog=args.autoscale_down_backlog,
                ),
                queue_dir=args.autoscale_queue_dir,
                poll_interval_s=args.autoscale_interval,
            )
        elif args.autoscale_queue_dir:
            parser.error(
                "--autoscale-queue-dir needs --autoscale-workdir"
            )
        if args.max_restarts > 0:
            return supervise_local(
                args.num_processes,
                command,
                max_restarts=args.max_restarts,
                port=int(port_str),
                resize_to=args.resize_to,
                auto_resize=args.auto_resize,
                follow_checkpoints=args.follow_checkpoints,
                heartbeat_timeout=args.heartbeat_timeout,
                term_grace_s=args.term_grace,
                scale_controller=controller,
            )
        if args.resize_to is not None or args.auto_resize:
            parser.error(
                "--resize-to/--auto-resize only apply to the restart "
                "loop; add --max-restarts N"
            )
        if args.follow_checkpoints:
            command = list(command) + [
                "--follow-checkpoints", args.follow_checkpoints,
            ]
        codes = launch_local(
            args.num_processes,
            command,
            port=int(port_str),
            heartbeat_timeout=args.heartbeat_timeout,
            term_grace_s=args.term_grace,
            scale_controller=controller,
        )
        return aggregate_exit_codes(codes)

    env = os.environ
    env[ENV_COORDINATOR] = args.coordinator
    env[ENV_NUM_PROCESSES] = str(args.num_processes)
    env[ENV_PROCESS_ID] = str(args.process_id)
    os.execvp(command[0], command)


if __name__ == "__main__":
    sys.exit(main())
