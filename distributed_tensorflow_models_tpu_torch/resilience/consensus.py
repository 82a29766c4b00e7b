"""Chief-decides consensus: one fleet, one view of every shared decision.

The port's copy of ``distributed_tensorflow_models_tpu/resilience/
consensus.py``.  Multi-process training shares one piece of mutable
state outside the step: the checkpoint directory.  Every *decision* about
it — skip or replace an existing step, which step the restore walk
settles on, whether any checkpoint exists at all, whether this chunk
diverged — is made by the chief (process 0) from its own view of storage
and obeyed everywhere, so storage with cross-host visibility skew cannot
send two processes down different paths.  :class:`Consensus` packages
that as two allgather-based primitives:

- :meth:`Consensus.broadcast_int` — every process contributes its local
  value, every process returns the *chief's*;
- :meth:`Consensus.allgather_int` — every process returns the full
  per-process vector (for any-host / earliest-host reductions);

plus :meth:`Consensus.any_flag` built on them.  With one process both are
**exact no-ops** — no collective, the local value straight back.

The default :class:`Backend` is ``torch.distributed`` over a **gloo group
of its own** (``dist.new_group(backend="gloo")``, made at the first
decision), carrying host int32 tensors.  A decision so never queues a
host-synchronising NCCL operation behind the replayed train step, and
never shares the communicator the captured graph's collectives use.
``backend`` is injectable, so a scripted bus can simulate a skewed
two-process fleet in one test process.

Every consensus point is a collective: callers reach it on every process
or none, in the same order, on the main thread, at a chunk boundary —
never on the checkpoint writer's thread (collectives issued from two
threads of one process deadlock).  Decisions are ints (steps, enum codes,
flags) that fit the int32 wire.
"""

from __future__ import annotations

import logging
from typing import Optional, Sequence

log = logging.getLogger("dtm")


class Backend:
    """Collective transport for :class:`Consensus` (injectable).

    ``allgather(value) -> list[int]`` returns every process's value,
    index == process index.  This default gathers int32 host tensors over
    a gloo group of its own, made over every process of the default
    process group at the first call (``new_group`` is itself collective:
    every process makes it at the same decision, which the lockstep order
    of consensus calls guarantees)."""

    def __init__(self):
        self._group = None

    def allgather(self, value: int) -> Sequence[int]:
        import torch
        import torch.distributed as dist

        if not -(2**31) <= int(value) < 2**31:
            raise ValueError(
                f"consensus value {value} does not fit the int32 wire"
            )
        if self._group is None:
            self._group = dist.new_group(backend="gloo")
        world = dist.get_world_size(self._group)
        local = torch.tensor([int(value)], dtype=torch.int32)
        out = [torch.empty_like(local) for _ in range(world)]
        dist.all_gather(out, local, group=self._group)
        return [int(t.item()) for t in out]


class Consensus:
    """Chief-decides broadcast over an allgather backend.

    ``process_index``/``process_count`` default to the live
    ``torch.distributed`` facts (0 of 1 when no process group is
    initialised); both are injectable, with ``backend``, for tests
    simulating a fleet and for ``fit`` on a mesh of one process inside a
    larger world (``meshlib.local_mesh``), which must decide alone."""

    def __init__(
        self,
        process_index: Optional[int] = None,
        process_count: Optional[int] = None,
        backend: Optional[Backend] = None,
    ):
        if process_index is None or process_count is None:
            import torch.distributed as dist

            live = dist.is_available() and dist.is_initialized()
            if process_index is None:
                process_index = dist.get_rank() if live else 0
            if process_count is None:
                process_count = dist.get_world_size() if live else 1
        self._pid = process_index
        self._nproc = process_count
        self._backend = backend

    @property
    def process_index(self) -> int:
        return self._pid

    @property
    def process_count(self) -> int:
        return self._nproc

    @property
    def is_chief(self) -> bool:
        return self._pid == 0

    @property
    def active(self) -> bool:
        """True when decisions actually cross processes.  False is the
        single-process no-op path: primitives return their inputs and
        never touch the backend."""
        return self._nproc > 1

    def allgather_int(self, value: int, *, label: str = "") -> list[int]:
        """Every process's ``value`` (index == process index).
        Single-process: ``[value]``, no collective."""
        if not self.active:
            return [int(value)]
        if self._backend is None:
            self._backend = Backend()
        return list(self._backend.allgather(int(value)))

    def broadcast_int(self, value: int, *, label: str = "") -> int:
        """The chief's ``value``, on every process.  Single-process: the
        local value back.  When the local value disagrees with the
        chief's the divergence is logged — that log line IS the
        visibility-skew detector."""
        agreed = self.allgather_int(value, label=label)[0]
        if agreed != int(value):
            log.warning(
                "consensus%s: local decision %d overridden by chief's %d "
                "(process %d; cross-host view skew)",
                f" [{label}]" if label else "", int(value), agreed, self._pid,
            )
        return agreed

    def any_flag(self, flag: bool, *, label: str = "") -> bool:
        """True iff ANY process passed True (allgather-OR).
        Single-process: ``flag`` back."""
        if not self.active:
            return bool(flag)
        return max(self.allgather_int(int(bool(flag)), label=label)) > 0
