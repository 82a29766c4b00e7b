"""Dataset-cursor re-split for elastic fleet resize (N -> M processes).

A checkpoint written by an N-process fleet carries N per-process dataset
sidecars (``checkpoints/dataset_states/<step>/p<pid>.json``).  When the
fleet comes back with M != N processes, no process can simply adopt "its
own" sidecar: the sidecar set describes a different sharding of the input
stream.  This module holds the pure, jax-free math that maps the N saved
cursor positions onto the new fleet.

Conservative rule (never skip an untrained batch): every new process
resumes from the *fleet-minimum* safe position across the N saved
cursors.  Sidecars are written at the same checkpoint step, so their
positions differ by at most the pipeline's in-flight depth — one chunk —
and adopting the minimum re-reads at most that much per host.  Re-reading
a batch costs a few redundant gradients; skipping one silently biases the
run, so the trade is always taken in the re-read direction.

Cursor formats (``data/datasets.py``), ranked by a total-order position
key so "minimum" is well defined:

- ``{"epoch", "batch_idx"}``  (ArrayDataset)   -> (epoch, batch_idx)
- ``{"epoch", "pos"}``        (PTBDataset)     -> (epoch, pos)
- ``{"records", "count"}``    (TFRecord shard) -> (0, count)

The first two are *global* cursors — every process materialises its own
row block of the same global batch — so the N saved positions agree and
the minimum is exact: an N->M resume replays the identical global batch
sequence.  The TFRecord ``count`` cursor is per-shard in file-sharded
mode; the minimum there is genuinely conservative (bounded re-read).

Nothing here talks to the network.  The *decision* (which saved pid's
cursor to adopt) is deterministic given the sidecar set, but hosts may
race sidecar reads, so callers must still funnel the pick through
``resilience/consensus.py`` (chief broadcasts, followers adopt) before
acting on it — see ``harness/checkpoint.py``.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

# Sentinel returned by pick_source when no sidecar exposes a usable
# position; callers fall back to the primary's orbax-saved state.
NO_SOURCE = -1


def cursor_position(state: Any) -> Optional[Tuple[int, int]]:
    """Total-order position key for one saved dataset state, or None.

    Accepts either a raw dataset cursor dict or the sidecar payload shape
    ``{"dataset": cursor}`` written by the train harness.  Unknown
    formats return None and are ignored by the re-split (conservative:
    an unreadable position can never be chosen as the resume point).
    """
    if not isinstance(state, dict):
        return None
    if "dataset" in state and isinstance(state["dataset"], dict):
        return cursor_position(state["dataset"])
    try:
        if "batch_idx" in state:
            return (int(state["epoch"]), int(state["batch_idx"]))
        if "pos" in state:
            return (int(state["epoch"]), int(state["pos"]))
        if "count" in state:
            return (0, int(state["count"]))
    except (KeyError, TypeError, ValueError):
        return None
    return None


def pick_source(states: Dict[int, Any]) -> int:
    """Choose the saved pid whose cursor is the fleet-minimum position.

    Deterministic: ties break toward the lowest pid, so every host that
    reads the same sidecar set computes the same answer.  Returns
    NO_SOURCE (-1) when no state exposes a parseable position.
    """
    best = NO_SOURCE
    best_key: Optional[Tuple[int, int, int]] = None
    for pid in sorted(states):
        pos = cursor_position(states[pid])
        if pos is None:
            continue
        key = (pos[0], pos[1], pid)
        if best_key is None or key < best_key:
            best, best_key = pid, key
    return best


def resplit_states(
    states: Dict[int, Any], new_nproc: int
) -> Tuple[int, Dict[int, Any]]:
    """Map N saved cursor states onto an M-process fleet.

    Returns ``(source_pid, {new_pid: state})``: every new process adopts
    the fleet-minimum source cursor (global-cursor datasets make this
    exact; per-shard cursors re-read at most one chunk).  1 -> 1 is the
    identity: the single saved state is handed back unmodified, so a
    same-shape resume stays bit-identical to a non-resized one.

    Raises ValueError when no saved state has a usable position — the
    caller decides the fallback (primary's approximate position).
    """
    src = pick_source(states)
    if src == NO_SOURCE:
        raise ValueError("no saved dataset state exposes a usable cursor position")
    return src, {pid: states[src] for pid in range(new_nproc)}


def describe_positions(states: Dict[int, Any]) -> Dict[str, Any]:
    """Ledger-friendly summary: per-pid position keys plus the pick."""
    positions = {
        str(pid): (
            list(pos)
            if (pos := cursor_position(states[pid])) is not None
            else None
        )
        for pid in sorted(states)
    }
    return {"positions": positions, "source_pid": pick_source(states)}
