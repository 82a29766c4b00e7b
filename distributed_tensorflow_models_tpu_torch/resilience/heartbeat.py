"""Fleet heartbeats: fast dead/stalled-peer detection for multi-process runs.

The port's copy of ``distributed_tensorflow_models_tpu/resilience/
heartbeat.py`` (stdlib only), the same files and the same summaries; the
port's writer also beats once more when it stops, and the process-wide
one stops at a clean exit, so the supervisor reads a finished process's
last step.

A killed or wedged process does not announce itself — its peers discover
it by blocking in the next collective until some transport timeout fires
(minutes), and an outer supervisor discovers nothing at all.  The
heartbeat layer makes both detections prompt and cheap:

- every process runs a :class:`HeartbeatWriter` — a daemon thread
  atomically rewriting ``<dir>/p<i>.json``
  (``{"pid", "time", "step", "phase"}``) every ``interval_s``; the train
  loop feeds it the current step via :func:`beat` at chunk boundaries
  and its lifecycle phase (``init``/``restore``/``compile``/``train``/
  ``save``) via :func:`set_phase`, so the file distinguishes "process
  alive but step frozen" (hung collective) from "process gone" (file
  goes stale entirely) — and a stale-heartbeat teardown can say *what*
  the process was doing when it froze without opening any trace;
- the supervisor (``launch.launch_local``) and the chief's in-run
  ``FleetHook`` read the directory back via :func:`read_fleet` /
  :func:`fleet_summary` — peers alive, heartbeat ages, per-process step
  positions and the slowest-process step lag (``fleet/*`` gauges).

The transport is deliberately plain files on the shared filesystem
(atomic rename per write): no sockets, no collective, readable by a
process that has never imported torch — which is exactly what the
supervisor is.  The ``DTM_HEARTBEAT_DIR`` env var carries the directory
from launcher to children; ``launch.initialize_from_env`` calls
:func:`start_from_env` before the process group is joined, so a child's
first heartbeat lands within ~one interval of spawn.
"""

from __future__ import annotations

import atexit
import json
import logging
import os
import threading
import time
from typing import Optional

log = logging.getLogger("dtm")

ENV_HEARTBEAT_DIR = "DTM_HEARTBEAT_DIR"

DEFAULT_INTERVAL_S = 1.0


def _path(directory: str, process_index: int) -> str:
    return os.path.join(directory, f"p{process_index}.json")


class HeartbeatWriter:
    """One per process: a daemon thread writing the heartbeat file.

    ``beat(step)`` is the train loop's chunk-boundary touch — a couple
    of attribute writes, never I/O on the hot path; the thread persists
    the latest step at its own cadence.  Writes are atomic
    (tmp + rename) so a reader never parses a torn file.
    """

    def __init__(
        self,
        directory: str,
        process_index: int,
        interval_s: float = DEFAULT_INTERVAL_S,
    ):
        self.directory = directory
        self.process_index = process_index
        self._interval = max(0.05, float(interval_s))
        self._step = -1  # -1 = process up, training not yet looping
        self._phase = "init"  # restore | compile | train | save | ...
        # Guards _step/_phase: beat()/set_phase() run on the train loop
        # while the writer thread snapshots both — without the lock a
        # set_phase between the two reads can pair step N with the
        # previous phase (and str/int attribute writes, though atomic in
        # CPython, carry no cross-thread visibility contract).
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def beat(self, step: int) -> None:
        with self._lock:
            self._step = int(step)

    def set_phase(self, phase: str) -> str:
        """Record the lifecycle phase (an uncontended lock + attribute
        write — hot-path safe); returns the previous phase so a scoped
        setter (the save path) can restore it."""
        with self._lock:
            prev, self._phase = self._phase, str(phase)
        return prev

    @property
    def phase(self) -> str:
        with self._lock:
            return self._phase

    def _write(self) -> None:
        with self._lock:
            step, phase = self._step, self._phase
        payload = {
            "pid": os.getpid(),
            "time": time.time(),
            "step": step,
            "phase": phase,
        }
        path = _path(self.directory, self.process_index)
        tmp = f"{path}.tmp"
        try:
            with open(tmp, "w") as f:
                json.dump(payload, f)
            os.replace(tmp, path)
        except OSError:  # heartbeat must never kill the worker
            log.exception("heartbeat write failed at %s", path)

    def _run(self) -> None:
        while not self._stop.wait(self._interval):
            self._write()

    def start(self) -> "HeartbeatWriter":
        if self._thread is not None:
            return self
        os.makedirs(self.directory, exist_ok=True)
        self._write()  # first beat lands before the thread's first tick
        self._thread = threading.Thread(
            target=self._run, name=f"heartbeat-p{self.process_index}",
            daemon=True,
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        """Stop the thread; a writer that was running writes one last
        beat, so a process that exits cleanly leaves its final step on
        file (the thread's cadence alone can miss a last short chunk)."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2 * self._interval + 1.0)
            self._thread = None
            self._write()


# Process-wide writer (started once by launch.initialize_from_env; the
# train loop reaches it through beat()/active_writer()).
_writer: Optional[HeartbeatWriter] = None
_writer_lock = threading.Lock()


def start_from_env(process_index: int = 0) -> Optional[HeartbeatWriter]:
    """Start the process heartbeat when ``DTM_HEARTBEAT_DIR`` is set
    (idempotent).  Returns the writer, or None when heartbeats are off.
    """
    global _writer
    directory = os.environ.get(ENV_HEARTBEAT_DIR)
    if not directory:
        return None
    with _writer_lock:
        if _writer is None:
            _writer = HeartbeatWriter(directory, process_index).start()
            # The port's addition: the last beat at a clean exit.
            atexit.register(_writer.stop)
        return _writer


def active_writer() -> Optional[HeartbeatWriter]:
    return _writer


def beat(step: int) -> None:
    """Chunk-boundary touch; no-op when heartbeats are off."""
    w = _writer
    if w is not None:
        w.beat(step)


def set_phase(phase: str) -> str:
    """Lifecycle-phase touch; returns the previous phase ("" when
    heartbeats are off, making restore-previous a harmless no-op)."""
    w = _writer
    if w is None:
        return ""
    return w.set_phase(phase)


def read_fleet(
    directory: str, num_processes: int, now: Optional[float] = None
) -> list[Optional[dict]]:
    """Per-process heartbeat views (index == process index): ``None``
    when the file does not exist / does not parse, else the payload plus
    ``age_s``.  Unreadable == never-started or torn mid-write — both
    read as "no heartbeat", which is what the staleness math wants."""
    now = time.time() if now is None else now
    out: list[Optional[dict]] = []
    for i in range(num_processes):
        try:
            with open(_path(directory, i)) as f:
                payload = json.load(f)
            payload["age_s"] = max(0.0, now - float(payload.get("time", 0.0)))
            out.append(payload)
        except (OSError, ValueError):
            out.append(None)
    return out


def fleet_summary(
    directory: str,
    num_processes: int,
    *,
    stale_after_s: float,
    now: Optional[float] = None,
    views: Optional[list] = None,
) -> dict:
    """The ``fleet/*`` gauge values: ``peers_alive`` (fresh heartbeat
    within ``stale_after_s``), ``heartbeat_age_s`` (worst age among
    processes that have ever beaten; missing files excluded — staleness
    of a never-started peer is the supervisor's launch-grace call, not
    a gauge), and ``step_lag`` (max − min step among alive peers that
    have entered the train loop).  Pass precomputed ``views`` (one
    :func:`read_fleet` snapshot) when the caller also inspects the
    per-peer details — one consistent snapshot, one round of I/O."""
    if views is None:
        views = read_fleet(directory, num_processes, now=now)
    ages = [v["age_s"] for v in views if v is not None]
    alive_steps = [
        int(v.get("step", -1))
        for v in views
        if v is not None and v["age_s"] <= stale_after_s
    ]
    looping = [s for s in alive_steps if s >= 0]
    return {
        "peers_alive": len(alive_steps),
        "heartbeat_age_s": max(ages) if ages else 0.0,
        "step_lag": (max(looping) - min(looping)) if looping else 0,
    }
