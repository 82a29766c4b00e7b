"""Failure-domain resilience of the port: what ``fit`` survives.

The port's counterpart of ``distributed_tensorflow_models_tpu/
resilience/`` (stdlib, the port's telemetry names and, for the consensus
wire, ``torch.distributed``):

- :mod:`preemption` — SIGTERM/SIGINT grace: a flag the train loop polls
  at chunk boundaries, answered with an emergency checkpoint and a
  resumable exit.
- :mod:`fsck` — structural validation of checkpoint steps (the restore
  walk-back skips torn ones) and the command line that reports and
  repairs them.
- :mod:`consensus` — chief-decides broadcast of every checkpoint
  decision, over a gloo group of its own; an exact no-op with one process.
- :mod:`watchdog` — step-progress watchdog: a hung collective or input
  pipeline produces a diagnosis (and optionally an abort).
- :mod:`backoff` — the deterministic-jitter restart schedule of
  ``recoverable_fit``.

Divergence rollback (``nan_policy="rollback"``) lives in
``harness/train.py::fit``.  :mod:`fsck` is imported by its users (and
run as ``python -m ...resilience.fsck``), not here.  Not ported yet:
``chaos.py`` (fault injection) and ``heartbeat.py`` (fleet heartbeat
files).  This package never imports :mod:`harness`; the harness wires it
in.
"""

from distributed_tensorflow_models_tpu_torch.resilience.backoff import (  # noqa: F401
    restart_backoff,
)
from distributed_tensorflow_models_tpu_torch.resilience.consensus import (  # noqa: F401
    Consensus,
)
from distributed_tensorflow_models_tpu_torch.resilience.preemption import (  # noqa: F401
    PreemptionListener,
)
from distributed_tensorflow_models_tpu_torch.resilience.watchdog import (  # noqa: F401
    ProgressWatchdog,
)

