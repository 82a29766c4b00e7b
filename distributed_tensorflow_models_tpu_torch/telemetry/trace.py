"""Structured event tracing: the fleet flight recorder's engine.

The registry answers *how much* wall time each category cost; it cannot
answer *what happened, in what order, on which host* — the question every
chaos drill and real incident post-mortem starts with.  This module adds
that layer without a new dependency or a new hot-path budget:

- :class:`Tracer` — a bounded ring buffer of structured events
  (``ts_wall``, ``ts_mono``, ``tid``, ``name``, ``ph``, ``dur_s``,
  ``args``).  Appends are lock-free (an ``itertools.count`` index — a
  single ``next()`` is atomic under the GIL — plus one list-slot store),
  a couple of clock reads and one tuple allocation each: ~1 µs, inside
  the same <5 µs/step budget the registry's hot path is pinned to
  (``tests/test_telemetry.py``).  The ring overwrites oldest-first, so
  memory is bounded and the buffer always holds the *last* N events —
  exactly what a post-mortem wants.
- **Flight recorder** (:meth:`Tracer.flight_record` /
  :meth:`Tracer.dump_flight_record`) — a JSON dump of the ring plus a
  registry snapshot, written by ``fit`` on every abnormal exit (NaN
  rollback, preemption notice, crash-path teardown, chaos kill) to
  ``<workdir>/flight_recorder_p<i>.json``.  Schema validated by
  ``scripts/check_metrics_schema.py --flight-recorder``.
- **Chrome-trace export** (:meth:`Tracer.to_chrome` /
  :meth:`Tracer.dump_chrome`) — the standard ``traceEvents`` JSON
  Perfetto/chrome://tracing load directly; ``scripts/fleet_report.py``
  merges the per-process files into one fleet timeline.
- :class:`FlightWatcher` — the piece that makes forensics survive the
  *ungraceful* deaths.  A Python-level signal handler only runs between
  main-thread bytecodes, so a host wedged in a dead peer's collective
  (the exact shape of the kill drill's survivor) never reaches its
  graceful dump before the supervisor's SIGKILL.  The C-level handler,
  however, still writes the signal number to the ``signal.set_wakeup_fd``
  pipe at *arrival* — this daemon thread selects on that pipe and
  answers with an immediate flight-record dump, main thread wedged or
  not.

Two kinds of event:

- **instant** (``ph == "i"``) — a point decision: a chaos fire, a
  consensus override, a rollback, a preemption notice.
- **complete** (``ph == "X"``) — a span with a duration: a checkpoint
  save/fence, a data-wait, a compile, an AOT overlap.

``ts_wall`` (``time.time``) is what cross-host merging aligns on;
``ts_mono`` (``time.perf_counter``) is what durations and per-thread
ordering are computed from (monotonic per thread by construction — the
schema lint checks it).

Stdlib only, importable from every layer, like the registry.
"""

from __future__ import annotations

import itertools
import json
import logging
import os
import select
import signal
import threading
import time
from contextlib import contextmanager
from typing import Any, Iterator, Optional

log = logging.getLogger("dtm")

PH_COMPLETE = "X"
PH_INSTANT = "i"

# Default ring size (ExperimentConfig.trace_ring_events).  ~10 events per
# step on a chatty unfused run -> the last several hundred steps; one
# event tuple is ~200 bytes, so the default ring holds under 1 MB.
DEFAULT_RING_EVENTS = 4096

FLIGHT_RECORD_VERSION = 1


def flight_record_path(workdir: str, process_index: int) -> str:
    """The per-process flight-recorder artifact path (one file per
    process; later dumps replace earlier ones — the ring inside already
    spans the whole incident)."""
    return os.path.join(workdir, f"flight_recorder_p{process_index}.json")


def chrome_trace_path(workdir: str, process_index: int) -> str:
    """The per-process Chrome-trace export path (``trace_export`` knob)."""
    return os.path.join(workdir, f"trace_p{process_index}.json")


class Tracer:
    """Bounded ring of structured events; see the module docstring.

    ``capacity <= 0`` (or ``enabled=False``) builds a disabled tracer:
    every record method returns after one attribute check, so callers
    never need their own gating.  One tracer per training run, attached
    to the run's :class:`~.registry.MetricsRegistry` (``registry.trace``)
    so every component already holding the registry can trace without a
    new parameter.
    """

    def __init__(
        self,
        capacity: int = DEFAULT_RING_EVENTS,
        *,
        process_index: int = 0,
        enabled: bool = True,
    ):
        self.capacity = max(1, int(capacity))
        self.enabled = bool(enabled) and int(capacity) > 0
        self.process_index = int(process_index)
        self._buf: list[Optional[tuple]] = [None] * self.capacity
        self._count = itertools.count()
        # Highest index handed out + 1 — the emitted-event count.  The
        # read-modify-write below can lose an update under a thread
        # race (costing one unit of *accounting*, never an event); the
        # authoritative ring is indexed by the atomic counter.
        self._n = 0

    # -- recording ---------------------------------------------------------

    def _emit(self, ev: tuple) -> None:
        i = next(self._count)
        self._buf[i % self.capacity] = ev
        if i >= self._n:
            self._n = i + 1

    def instant(self, name: str, args: Optional[dict] = None) -> None:
        """A point event (decision, fire, notice) at *now*."""
        if not self.enabled:
            return
        self._emit(
            (
                time.time(),
                time.perf_counter(),
                threading.get_ident(),
                name,
                PH_INSTANT,
                None,
                args,
            )
        )

    def complete(
        self,
        name: str,
        dur_s: float,
        *,
        ts_mono: Optional[float] = None,
        ts_wall: Optional[float] = None,
        args: Optional[dict] = None,
    ) -> None:
        """A span that already finished: ``dur_s`` long, *starting* at
        ``ts_mono``/``ts_wall`` (both default to now − dur, so callers
        that timed a block with ``perf_counter`` need pass nothing)."""
        if not self.enabled:
            return
        if ts_mono is None:
            ts_mono = time.perf_counter() - dur_s
        if ts_wall is None:
            ts_wall = time.time() - dur_s
        self._emit(
            (
                ts_wall,
                ts_mono,
                threading.get_ident(),
                name,
                PH_COMPLETE,
                float(dur_s),
                args,
            )
        )

    @contextmanager
    def span(self, name: str, args: Optional[dict] = None) -> Iterator[None]:
        """Trace a ``with`` block as one complete event (errors included,
        like the registry's span — a save that died at 30 s burned 30 s)."""
        if not self.enabled:
            yield
            return
        t_wall, t_mono = time.time(), time.perf_counter()
        try:
            yield
        finally:
            self.complete(
                name,
                time.perf_counter() - t_mono,
                ts_mono=t_mono,
                ts_wall=t_wall,
                args=args,
            )

    # -- accounting --------------------------------------------------------

    @property
    def emitted(self) -> int:
        """Events recorded over the tracer's lifetime (ring included)."""
        return self._n

    @property
    def dropped(self) -> int:
        """Events overwritten by the ring (emitted − retained)."""
        return max(0, self._n - self.capacity)

    # -- reading -----------------------------------------------------------

    def events(self) -> list[dict]:
        """Chronological (by ``ts_mono``) snapshot of the retained ring as
        dicts — the flight recorder's and the exports' common form."""
        raw = [e for e in list(self._buf) if e is not None]
        raw.sort(key=lambda e: e[1])
        out = []
        for ts_wall, ts_mono, tid, name, ph, dur_s, args in raw:
            d: dict = {
                "ts_wall": ts_wall,
                "ts_mono": ts_mono,
                "tid": tid,
                "name": name,
                "ph": ph,
            }
            if ph == PH_COMPLETE:
                d["dur_s"] = dur_s
            if args:
                d["args"] = args
            out.append(d)
        return out

    # -- exports -----------------------------------------------------------

    def to_chrome(self) -> dict:
        """Chrome-trace (Perfetto-loadable) JSON: ``ts`` in wall-clock
        microseconds (absolute — ``fleet_report.py`` rebases the merged
        timeline), ``pid`` = the *process index* so the fleet merge lays
        hosts out as separate process tracks."""
        events = []
        pid = self.process_index
        for e in self.events():
            out = {
                "name": e["name"],
                "ph": e["ph"],
                "ts": e["ts_wall"] * 1e6,
                "pid": pid,
                "tid": e["tid"],
            }
            if e["ph"] == PH_COMPLETE:
                out["dur"] = e["dur_s"] * 1e6
            else:
                out["s"] = "t"  # instant scope: thread
            if "args" in e:
                out["args"] = e["args"]
            events.append(out)
        events.append(
            {
                "name": "process_name",
                "ph": "M",
                "pid": pid,
                "args": {"name": f"p{pid}"},
            }
        )
        return {
            "traceEvents": events,
            "displayTimeUnit": "ms",
            "otherData": {
                "process_index": pid,
                "os_pid": os.getpid(),
                "emitted": self.emitted,
                "dropped": self.dropped,
                "exported_at": time.time(),
            },
        }

    def dump_chrome(self, path: str) -> None:
        _atomic_json(path, self.to_chrome())

    def flight_record(
        self,
        reason: str,
        registry=None,
        extra: Optional[dict] = None,
    ) -> dict:
        """The flight-recorder payload: the retained ring, the registry
        snapshot (best-effort — a dump racing metric creation must not
        fail the dump), and the incident's identity facts."""
        snap: dict = {}
        if registry is not None:
            try:
                snap = registry.snapshot()
            except Exception:  # noqa: BLE001 — forensics must not crash
                log.exception("flight record registry snapshot failed")
        record = {
            "version": FLIGHT_RECORD_VERSION,
            "reason": reason,
            "ts_wall": time.time(),
            "pid": os.getpid(),
            "process_index": self.process_index,
            "capacity": self.capacity,
            "emitted": self.emitted,
            "dropped": self.dropped,
            "events": self.events(),
            "registry": snap,
        }
        if extra:
            record.update(extra)
        return record

    def dump_flight_record(
        self,
        path: str,
        reason: str,
        registry=None,
        extra: Optional[dict] = None,
    ) -> None:
        _atomic_json(path, self.flight_record(reason, registry, extra))


# Distinct tmp names per write: the flight watcher THREAD and the main
# thread's graceful dump share one pid and can race on one target file,
# so the tmp must be unique per (thread, write) or the two json.dumps
# interleave into the same truncated tmp and one os.replace publishes
# garbage.
_TMP_COUNTER = itertools.count()


def _atomic_json(path: str, payload: Any) -> None:
    """tmp + rename so a reader (or a SIGKILL landing mid-dump) never
    sees a torn artifact; concurrent writers each get their own tmp and
    the last rename wins whole."""
    tmp = (
        f"{path}.{os.getpid()}.{threading.get_ident()}"
        f".{next(_TMP_COUNTER)}.tmp"
    )
    with open(tmp, "w") as f:
        json.dump(payload, f)
    os.replace(tmp, path)


# A shared disabled tracer — the registry's default ``trace`` attribute,
# so components can call ``registry.trace.instant(...)`` unconditionally.
# Safe to share: disabled tracers never mutate their (1-slot) ring.
NULL_TRACER = Tracer(capacity=1, enabled=False)


class FlightWatcher:
    """Dump the flight record at *signal arrival*, even when the main
    thread is wedged (module docstring).

    ``install()`` (main thread only — a CPython ``set_wakeup_fd``
    restriction, same as the preemption listener's) routes every signal
    delivery's number into a private pipe and starts a daemon thread
    selecting on it; each SIGTERM/SIGINT byte triggers ``dump(reason)``
    with ``reason = "signal_<N>"``.  ``stop()`` restores the previous
    wakeup fd, wakes the thread with a sentinel byte, and joins it —
    callers must stop the watcher on every exit path (the thread-leak
    guard in ``tests/test_harness.py`` enforces it for ``fit``).

    The graceful exit path usually dumps *again* afterwards with a
    richer reason ("preempted", "crash"); both writes are atomic and the
    later, fuller record wins — the watcher's value is the host that
    never reaches a graceful path at all (SIGKILL after the grace
    window, blocked in a dead peer's collective).
    """

    _STOP_BYTE = b"\x00"  # no signal is numbered 0

    def __init__(self, dump, signals=(signal.SIGTERM, signal.SIGINT)):
        self._dump = dump
        self._signums = {int(s) for s in signals}
        self._rfd: Optional[int] = None
        self._wfd: Optional[int] = None
        self._old_fd: Optional[int] = None
        self._thread: Optional[threading.Thread] = None
        self._installed = False

    def install(self) -> bool:
        """Returns True when armed (main thread, pipe + wakeup fd ok)."""
        if self._installed:
            return True
        if threading.current_thread() is not threading.main_thread():
            return False
        rfd = wfd = None
        try:
            rfd, wfd = os.pipe()
            os.set_blocking(wfd, False)
            os.set_blocking(rfd, False)
            self._old_fd = signal.set_wakeup_fd(
                wfd, warn_on_full_buffer=False
            )
        except (ValueError, OSError):  # exotic interpreter / fd pressure
            log.debug("flight watcher not armed", exc_info=True)
            for fd in (rfd, wfd):
                try:
                    if fd is not None:
                        os.close(fd)
                except OSError:  # pragma: no cover
                    pass
            return False
        self._rfd, self._wfd = rfd, wfd
        self._thread = threading.Thread(
            target=self._run, name="flight-watch", daemon=True
        )
        self._thread.start()
        self._installed = True
        return True

    def _run(self) -> None:
        fired: set[int] = set()
        while True:
            try:
                ready, _, _ = select.select([self._rfd], [], [], 0.5)
                if not ready:
                    continue
                data = os.read(self._rfd, 64)
            except (OSError, ValueError):  # fd closed during teardown
                return
            if not data:
                return
            if self._STOP_BYTE in data:
                return
            for b in data:
                if b in self._signums and b not in fired:
                    fired.add(b)
                    try:
                        self._dump(f"signal_{b}")
                    except Exception:  # noqa: BLE001 — never kill the run
                        log.exception(
                            "flight-record dump on signal %d failed", b
                        )

    def stop(self) -> None:
        """Disarm + join (idempotent; call from the install thread so the
        wakeup fd restore is legal)."""
        if not self._installed:
            return
        self._installed = False
        try:
            if threading.current_thread() is threading.main_thread():
                signal.set_wakeup_fd(
                    self._old_fd if self._old_fd is not None else -1
                )
        except (ValueError, OSError):  # pragma: no cover — teardown
            pass
        try:
            os.write(self._wfd, self._STOP_BYTE)
        except OSError:  # pragma: no cover — already closed
            pass
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None
        for fd in (self._rfd, self._wfd):
            try:
                if fd is not None:
                    os.close(fd)
            except OSError:  # pragma: no cover
                pass
        self._rfd = self._wfd = None
