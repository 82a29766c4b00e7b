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

A preempted training process exits with :data:`RESUMABLE_EXIT_CODE`.
The serving fleet's closed-loop autoscaler (the JAX package's
``FleetAutoscaler`` and ``launch_local(scale_controller=...)``) belongs
to the serving stack, which the port does not have yet: asking for it
raises.  This module imports torch only inside
:func:`initialize_from_env`'s join, so a supervisor never loads it.
"""

from __future__ import annotations

import argparse
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


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} not ported: the closed-loop serving autoscaler belongs to "
        "the serving stack (ROADMAP §1 item 7)")


class FleetAutoscaler:
    """The JAX package's closed-loop serving scale controller: not ported
    until the serving stack is (constructing one raises)."""

    def __init__(self, *args, **kwargs):
        raise _not_ported("FleetAutoscaler")


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
    scale_controller=None,
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

    ``cpu_devices_per_process`` (the JAX package's fake CPU devices) has
    no meaning here and raises; ``scale_controller`` (serving autoscale)
    is not ported and raises.
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
    if scale_controller is not None:
        raise _not_ported("launch_local(scale_controller=...)")
    procs: list[subprocess.Popen] = []
    logs: list = []
    hb_dir = tempfile.mkdtemp(prefix="dtm-heartbeat-")
    t0_wall = time.time()

    def _spawn(i: int) -> None:
        env = dict(os.environ)
        env[ENV_COORDINATOR] = f"127.0.0.1:{port}"
        env[ENV_NUM_PROCESSES] = str(num_processes)
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

    ``follow_checkpoints=<dir>`` appends ``--follow-checkpoints <dir>`` to
    every child's argv (for commands that take it; the port's training
    CLI does not)."""
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
        if args.max_restarts > 0:
            return supervise_local(
                args.num_processes,
                command,
                max_restarts=args.max_restarts,
                port=int(port_str),
                resize_to=args.resize_to,
                auto_resize=args.auto_resize,
                heartbeat_timeout=args.heartbeat_timeout,
                term_grace_s=args.term_grace,
            )
        if args.resize_to is not None or args.auto_resize:
            parser.error(
                "--resize-to/--auto-resize only apply to the restart "
                "loop; add --max-restarts N"
            )
        codes = launch_local(
            args.num_processes,
            command,
            port=int(port_str),
            heartbeat_timeout=args.heartbeat_timeout,
            term_grace_s=args.term_grace,
        )
        return aggregate_exit_codes(codes)

    env = os.environ
    env[ENV_COORDINATOR] = args.coordinator
    env[ENV_NUM_PROCESSES] = str(args.num_processes)
    env[ENV_PROCESS_ID] = str(args.process_id)
    os.execvp(command[0], command)


if __name__ == "__main__":
    sys.exit(main())
