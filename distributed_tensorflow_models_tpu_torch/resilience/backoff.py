"""Deterministic restart backoff (shared by in-process and fleet restarts).

The port's copy of ``distributed_tensorflow_models_tpu/resilience/
backoff.py`` (stdlib only), the same schedule value for value:
``harness/train.py::recoverable_fit`` spaces its in-process restarts by it.
"""

from __future__ import annotations


def restart_backoff(
    attempt: int, *, base_s: float = 1.0, max_s: float = 60.0, seed: int = 0
) -> float:
    """Delay before restart ``attempt`` (1-based): exponential backoff
    with *deterministic* jitter.

    The raw delay ``min(max_s, base_s · 2^(attempt−1))`` is scaled into
    ``[0.5, 1.0)`` of itself by a hash of ``(seed, attempt)`` — jitter
    that de-synchronizes a fleet tripped by one shared fault (no
    thundering-herd re-slamming the coordinator/storage on the same
    second) while keeping every run's timeline replayable and testable,
    matching the repo-wide determinism contract.  ``base_s <= 0``
    disables backoff entirely (tests, and callers with their own
    scheduler-level backoff)."""
    if base_s <= 0:
        return 0.0
    import hashlib

    raw = min(max_s, base_s * (2.0 ** (attempt - 1)))
    digest = hashlib.sha256(f"{seed}:{attempt}".encode()).digest()
    frac = int.from_bytes(digest[:8], "big") / 2.0**64
    return raw * (0.5 + 0.5 * frac)
