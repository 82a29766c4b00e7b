"""Preemption grace: turn SIGTERM into a checkpoint, not a corpse.

The port's copy of ``distributed_tensorflow_models_tpu/resilience/
preemption.py`` (stdlib only).

Managed fleets preempt with notice: the runtime delivers SIGTERM and
grants a grace period before SIGKILL.  The reference stack had nothing
for this — a preempted worker simply died and ``_RecoverableSession``
elsewhere re-trained from the last 600-second checkpoint.  The listener
here converts the notice into *zero* lost work: a flag the train loop
polls at chunk boundaries, answered with a forced emergency checkpoint
(state + dataset sidecars), clean teardown, and a ``FitResult.preempted``
marker the callers treat as resumable.

Signal semantics:

- **SIGTERM** — always graceful: every delivery (re-)sets the flag.
- **SIGINT** — graceful *once*: the first ctrl-C requests the same
  checkpoint-and-exit; a second ctrl-C restores the previous handler and
  raises ``KeyboardInterrupt`` immediately (a stuck run must still be
  killable from the keyboard).

Handlers can only be installed from the main thread (a CPython
restriction); :meth:`install` returns ``False`` elsewhere and the train
loop simply never sees a preemption — correct for worker threads, which
are not the process's signal recipient anyway.
"""

from __future__ import annotations

import logging
import signal
import threading

log = logging.getLogger("dtm")


class PreemptionListener:
    """Install/uninstall pair around a training run; ``preempted`` is the
    chunk-boundary poll.  Reentrant-safe: uninstall restores exactly the
    handlers that were active at install time."""

    def __init__(self, signals=(signal.SIGTERM, signal.SIGINT)):
        self._signals = tuple(signals)
        self._flag = threading.Event()
        self._sigint_seen = False
        self._prev: dict = {}
        self._installed = False

    @property
    def preempted(self) -> bool:
        return self._flag.is_set()

    def wait(self, timeout: float) -> bool:
        """Sleep up to ``timeout`` seconds, waking IMMEDIATELY on a
        preemption notice (returns True).  Plain ``time.sleep`` resumes
        after the handler returns (PEP 475) — a backoff sleep would
        burn the whole grace period asleep."""
        return self._flag.wait(timeout)

    def _handle(self, signum, frame):
        if signum == signal.SIGINT:
            if self._sigint_seen:
                # Second ctrl-C: hand control back (previous handler
                # restored first, so a third is the platform default)
                # and die now.
                self.uninstall()
                raise KeyboardInterrupt
            # Escalation is keyed on SIGINT deliveries specifically, NOT
            # on the flag: after a fleet SIGTERM the run is already
            # draining toward its emergency checkpoint, and an operator's
            # single reflex ctrl-C must stay harmless — not kill the save
            # mid-write.
            self._sigint_seen = True
        first = not self._flag.is_set()
        self._flag.set()
        if first:
            log.warning(
                "received %s: will write an emergency checkpoint and exit "
                "at the next chunk boundary (SIGINT %sto abort "
                "immediately)",
                signal.Signals(signum).name,
                "again " if signum == signal.SIGINT else "twice ",
            )
        elif signum == signal.SIGINT:
            log.warning(
                "ctrl-C noted; already draining toward the emergency "
                "checkpoint (SIGINT again to abort immediately)"
            )

    def install(self) -> bool:
        """Returns True when handlers were installed (main thread only)."""
        if self._installed:
            return True
        if threading.current_thread() is not threading.main_thread():
            log.debug("preemption listener skipped: not the main thread")
            return False
        try:
            for sig in self._signals:
                self._prev[sig] = signal.signal(sig, self._handle)
        except ValueError:  # non-main thread race / exotic interpreter
            self.uninstall()
            return False
        self._installed = True
        return True

    def uninstall(self) -> None:
        # Restoring handlers raises ValueError off the main thread, and a
        # watchdog/reaper thread *can* reach teardown: leave the handlers
        # in place for the main thread to restore (or the process to die
        # with) rather than half-clearing our bookkeeping.
        if threading.current_thread() is not threading.main_thread():
            log.debug("preemption uninstall skipped: not the main thread")
            return
        for sig, prev in self._prev.items():
            try:
                signal.signal(sig, prev)
            except (ValueError, TypeError):  # pragma: no cover — teardown
                pass
        self._prev.clear()
        self._installed = False
