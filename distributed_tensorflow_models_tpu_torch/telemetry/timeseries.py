"""Periodic append-only metric time-series: ``timeseries.jsonl``.

The registry snapshot is cumulative — one point, no history.  The flight
recorder has history but only for *events*.  To draw a latency-vs-load
curve (or an offered-vs-served throughput timeline) you need the third
artifact: the registry snapshot sampled on a cadence and appended to
disk.  This module writes it.

Row shape (one JSON object per line, numbers only)::

    {"ts_wall": …, "ts_mono": …, "offered": …, "served": …,
     "serve/ttft_s/p99_s": …, …rest of the registry snapshot…}

- ``ts_mono`` is ``time.perf_counter()`` — strictly non-decreasing
  within a file, the key readers should diff.  ``ts_wall`` is wall time
  for cross-process alignment only.
- ``offered`` / ``served`` are the cumulative request counters
  (``serve/requests`` / ``serve/completed``) hoisted to the top level;
  diffing consecutive rows gives the throughput timeline
  ``scripts/serving_report.py`` renders.

Durability: each row is a *single* ``write()`` to an ``O_APPEND`` fd —
atomic on POSIX for our row sizes, so a reader polling the file (or a
crash mid-run) never sees a torn line.  The file is bounded: past
``max_rows`` it is compacted in place (tmp + ``os.replace``) keeping the
most recent half, so a long-lived replica cannot fill the disk.

torch-free, stdlib-only: the supervisor tails this from outside the
serving process.  Rows are schema-checked by
``scripts/check_metrics_schema.py --timeseries``.
"""

from __future__ import annotations

import json
import os
import time
from typing import Optional

from distributed_tensorflow_models_tpu_torch.telemetry import registry as reglib

DEFAULT_INTERVAL_S = 5.0
DEFAULT_MAX_ROWS = 10_000


class TimeseriesWriter:
    """Rate-limited registry-snapshot appender (single-writer).

    Pull-driven: the owning loop calls :meth:`maybe_write` every
    iteration and the writer decides (``interval_s``) whether a row is
    due; :meth:`write_row` forces one (final row at drain).
    """

    def __init__(
        self,
        path: str,
        registry: Optional[reglib.MetricsRegistry] = None,
        *,
        interval_s: float = DEFAULT_INTERVAL_S,
        max_rows: int = DEFAULT_MAX_ROWS,
    ):
        if interval_s <= 0.0:
            raise ValueError(f"interval_s must be positive: {interval_s}")
        if max_rows < 2:
            raise ValueError(f"max_rows must be >= 2: {max_rows}")
        self.path = path
        self.registry = registry if registry is not None else reglib.get_registry()
        self.interval_s = float(interval_s)
        self.max_rows = int(max_rows)
        self._last_write = float("-inf")
        # Resuming onto an existing file (replica restart) keeps the
        # bound honest: count what's already there.
        self._rows = 0
        if os.path.exists(path):
            try:
                with open(path, "rb") as f:
                    self._rows = sum(1 for _ in f)
            except OSError:
                self._rows = 0

    def maybe_write(self, now: Optional[float] = None) -> bool:
        """Append a row if ``interval_s`` has elapsed; True if written."""
        if now is None:
            now = time.perf_counter()
        if now - self._last_write < self.interval_s:
            return False
        self.write_row(now)
        return True

    def write_row(self, now: Optional[float] = None) -> None:
        """Unconditionally append one snapshot row (atomic single write)."""
        if now is None:
            now = time.perf_counter()
        self._last_write = now
        snap = self.registry.snapshot()
        row = {
            "ts_wall": time.time(),
            "ts_mono": now,
            "offered": self.registry.counter(reglib.SERVE_REQUESTS).value,
            "served": self.registry.counter(reglib.SERVE_COMPLETED).value,
        }
        row.update(snap)
        line = json.dumps(row, sort_keys=True) + "\n"
        # O_APPEND + one write(): atomic for our row sizes; no torn lines.
        fd = os.open(self.path, os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o644)
        try:
            os.write(fd, line.encode("utf-8"))
        finally:
            os.close(fd)
        self._rows += 1
        if self._rows > self.max_rows:
            self._compact()

    def _compact(self) -> None:
        """Rewrite the file keeping the most recent ``max_rows // 2`` rows."""
        keep = self.max_rows // 2
        try:
            with open(self.path, "r", encoding="utf-8") as f:
                lines = f.readlines()
        except OSError:
            return
        tail = lines[-keep:]
        tmp = f"{self.path}.tmp.{os.getpid()}"
        with open(tmp, "w", encoding="utf-8") as f:
            f.writelines(tail)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.path)
        self._rows = len(tail)
