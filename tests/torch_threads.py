"""Torch's CPU thread pools for the port's tests, sized to the run.

Imported first by every ``tests/test_torch_*.py``.  Under pytest-xdist
each of the ``PYTEST_XDIST_WORKER_COUNT`` worker processes gets an equal
share of the cores this process may run on: torch's default, a pool as
wide as the machine in every worker, oversubscribes the cores several
times over, and the port's tests ran several times slower for it.  A
serial run keeps torch's default.  Every comparison inside one process runs at one
thread count, so no bit-for-bit check is touched by the choice.
"""

from __future__ import annotations

import os

import torch


def xdist_share() -> int | None:
    """Threads per worker under xdist (at least 1); None when serial."""
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT") or 0)
    if workers <= 1:
        return None
    return max(1, len(os.sched_getaffinity(0)) // workers)


SHARE = xdist_share()
if SHARE is not None and torch.get_num_threads() > SHARE:
    torch.set_num_threads(SHARE)
    try:
        torch.set_num_interop_threads(SHARE)
    except RuntimeError:  # the inter-op pool already started
        pass
