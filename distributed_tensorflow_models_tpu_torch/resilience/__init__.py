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
  ``recoverable_fit`` and of the launcher's fleet restarts.
- :mod:`chaos` — deterministic fault injection (``cfg.chaos`` /
  ``--chaos``): each fault fires once, at an exact position.
- :mod:`heartbeat` — fleet heartbeat files: written by every process of
  a launched fleet, read by the launcher and the chief's ``FleetHook``.

Divergence rollback (``nan_policy="rollback"``) lives in
``harness/train.py::fit``.  :mod:`fsck`, :mod:`chaos` and
:mod:`heartbeat` are imported by their users (fsck is also run as
``python -m ...resilience.fsck``).  The four names below are resolved on
first use, so that importing a submodule (the launcher's
:mod:`heartbeat`) does not import torch.  This package never imports
:mod:`harness`; the harness wires it in.
"""

_LAZY = {
    "restart_backoff": "backoff",
    "Consensus": "consensus",
    "PreemptionListener": "preemption",
    "ProgressWatchdog": "watchdog",
}


def __getattr__(name: str):
    if name not in _LAZY:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    value = getattr(importlib.import_module(f"{__name__}.{_LAZY[name]}"),
                    name)
    globals()[name] = value
    return value
