"""Asynchronous parameter-server emulation.

PyTorch counterpart of ``distributed_tensorflow_models_tpu/parallel/async_ps.py``.
In the reference's async-PS mode each worker computes gradients against a
*stale* parameter snapshot and applies them straight into the parameter
servers' variables with no coordination; convergence degrades with
staleness.  The reference's headline experiment is the async-vs-sync A/B
on ResNet-50 (``harness/experiment.py``).  This module reproduces those
semantics deterministically, above the step's programs:

- ``num_workers`` virtual workers each hold a parameter snapshot tagged
  with the canonical step at fetch time (``version``).
- A schedule (round robin, or a seeded ``np.random.RandomState`` for
  arrival-order jitter) picks the worker of each event; the picks are the
  JAX package's exactly.
- The picked worker's gradient is taken at its snapshot, the canonical
  state (the parameter servers) applies it, and the worker fetches the new
  parameters.  ``staleness = canonical step - version`` is logged.
- ``staleness_limit`` reproduces the ConditionalAccumulator's drop of
  gradients stamped with an old step: a dropped event costs a fetch but
  applies nothing.

With one worker the trajectory is the sync train step's on the same
batches, bit for bit: both run :meth:`TrainStep.gradients` and
:func:`apply_gradients` in the same order, the event's generators seeded
by ``StepRngs.reseed(seed, event)`` as the step's by ``(seed, step)``.  BN
statistics and the carry are last-writer-wins, as PS-resident aux
variables were.  A state restored at step > 0 starts its workers at
staleness 0.

The JAX emulator leans on immutable pytrees and on a jitted grad/apply
pair; the port updates its state in place, computes with the model's own
``nn.Parameter``\\ s and replays captured CUDA graphs.  The traps that
follow from that, and what this module does about each:

1. **Snapshots must be copies.**  ``apply_gradients`` updates
   ``state.params`` in place, so a snapshot that held the canonical tensors
   (or ``.detach()`` views of them) would follow every update and show
   staleness 0.  Each worker holds buffers of its own, refreshed by
   ``copy_`` on fetch.
2. **The loss reads the model's parameters.**  The model computes with its
   own parameters, which *are* ``state.params``.  At an event of staleness
   > 0 the canonical values are put aside, the worker's snapshot is
   written into the model's parameters, the forward, the L2 and the
   gradients are all taken there, and the canonical values are written
   back before the apply.  At staleness 0 the snapshot equals the
   canonical parameters and nothing is copied.
3. **BatchNorm updates its running statistics in the forward.**  The JAX
   emulator leaves ``batch_stats`` untouched on a dropped event: here they
   are put back after it.
4. **The clip's norm under a model axis** is the whole arrays' one, taken
   by the gradient part (``train_loop.grad_norm``) and handed to the apply.
5. **Every process takes the same host decisions.**  The picks, the
   staleness and the drops are host integers computed from the seed and
   the host's step count; no device value enters them, so under a data or
   model world every process issues the same collectives.
6. (The optimizer's tables cover the run: see ``harness/experiment.py``.)
7. **A captured graph is bound to its state's addresses.**  The gradient
   and apply programs (``train_loop.GradApply``) are each captured once on
   CUDA, on the canonical state's tensors; the snapshot and the batch are
   copied into the grad graph's buffers before each replay and the host
   re-seeds the generators for the event.  :meth:`AsyncPSEmulator.warm_up`
   builds and captures both and then writes every state tensor back.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Mapping, Optional, Sequence

import numpy as np
import torch

from distributed_tensorflow_models_tpu_torch.core import train_loop
from distributed_tensorflow_models_tpu_torch.core.train_state import TrainState

Batch = Mapping[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class AsyncConfig:
    """Emulation knobs.

    ``schedule``: ``"round_robin"`` (steady staleness K-1) or ``"random"``
    (seeded arrival-order jitter; the same seed, the same trajectory).
    ``staleness_limit``: drop gradients older than this many canonical
    steps (None: never drop, the reference's plain async applies)."""

    num_workers: int = 4
    schedule: str = "round_robin"
    seed: int = 0
    staleness_limit: Optional[int] = None


@dataclasses.dataclass
class _Worker:
    params: list  # this worker's snapshot: a buffer per parameter
    version: int  # canonical step when this snapshot was fetched


class AsyncPSEmulator:
    """Event-driven async-PS trainer over a grad/apply pair of programs
    (``train_loop.GradApply``: eager on the CPU, captured CUDA graphs on
    the card unless ``capture=False``).

    The canonical :class:`TrainState` plays the parameter servers' role
    (parameters, optimizer slots, BN statistics, EMA, step); the virtual
    workers play the reference's worker processes.  Under a data or model
    world each process runs the emulator on its rows of each batch inside
    ``core/mesh.py::data_parallel``, and the gradient part averages over
    the data group as ``fit``'s step does."""

    def __init__(self, state: TrainState, loss_fn: train_loop.LossFn,
                 config: AsyncConfig = AsyncConfig(),
                 rng_names: Sequence[str] = ("dropout",), *,
                 name: str = "the model", capture: bool = True):
        if config.num_workers < 1:
            raise ValueError("need at least one virtual worker")
        if config.schedule not in ("round_robin", "random"):
            raise ValueError(f"unknown schedule {config.schedule!r}")
        self.config = config
        self.state = state
        self.staleness_log: list[int] = []
        self.dropped: int = 0
        self._event = 0
        self._sched_rng = np.random.RandomState(config.seed)
        self.programs = train_loop.GradApply(
            train_loop.TrainStep(loss_fn, rng_names), name=name,
            capture=capture)
        with torch.no_grad():
            params = self._params()
            self.workers = [
                _Worker(params=[p.detach().clone() for p in params],
                        version=int(state.step))
                for _ in range(config.num_workers)]
            # The canonical values while a stale snapshot sits in the
            # model, and the BN statistics while a dropped event's
            # forward has moved them.
            self._stash = [p.detach().clone() for p in params]
            self._stats = [b.detach().clone() for b in self._buffers()]

    def _params(self) -> list[torch.Tensor]:
        return list(self.state.params.values())

    def _buffers(self) -> list[torch.Tensor]:
        return [b for b in self.state.batch_stats.values()
                if b.is_floating_point()]

    # -- schedule ----------------------------------------------------------
    def _pick(self) -> int:
        if self.config.schedule == "round_robin":
            return self._event % self.config.num_workers
        return int(self._sched_rng.randint(self.config.num_workers))

    # -- event loop --------------------------------------------------------
    @torch.no_grad()
    def _copy(self, dst: list, src: list) -> None:
        if dst:
            torch._foreach_copy_(dst, src)

    def step(self, batch: Batch, seed: int) -> dict:
        """One async event: pick a worker, take the gradient at its
        snapshot, apply it (unless dropped), fetch.  Returns the event
        record: worker, staleness, dropped flag and the metrics of the
        worker's forward (0-d tensors on the device, copies)."""
        widx = self._pick()
        worker = self.workers[widx]
        staleness = self.state.step - worker.version
        dropped = (self.config.staleness_limit is not None
                   and staleness > self.config.staleness_limit)
        params = self._params()
        if staleness:
            self._copy(self._stash, params)
            self._copy(params, worker.params)
        if dropped:
            self._copy(self._stats, self._buffers())
        grads, aux, norm, metrics = self.programs.grads(
            self.state, batch, seed, self._event)
        metrics = {k: v.detach().clone() for k, v in metrics.items()}
        if staleness:
            self._copy(params, self._stash)
        if dropped:
            self.dropped += 1
            self._copy(self._buffers(), self._stats)
        else:
            self.state = self.programs.apply(self.state, grads, aux, norm)
        # Fetch: the worker adopts the canonical parameters (the reference
        # worker's variable read at the top of its next step).
        self._copy(worker.params, self._params())
        worker.version = self.state.step
        self.staleness_log.append(staleness)
        self._event += 1
        return {"worker": widx, "staleness": staleness, "dropped": dropped,
                "metrics": metrics}

    def run(self, batches: Iterable[Batch], seed: int) -> list[dict]:
        """Replay a batch stream through the event loop."""
        return [self.step(b, seed) for b in batches]

    def warm_up(self, batch: Batch, seed: int) -> None:
        """Run the next event's gradient and apply programs once (on CUDA:
        their eager runs and captures) and write every state tensor back:
        the state, the schedule, the workers and the logs are as before."""
        saved = train_loop.copy_state(self.state)
        grads, aux, norm, _ = self.programs.grads(self.state, batch, seed,
                                                  self._event)
        self.programs.apply(self.state, grads, aux, norm)
        train_loop.restore_state_(self.state, saved)

    @property
    def mean_staleness(self) -> float:
        return (float(np.mean(self.staleness_log)) if self.staleness_log
                else 0.0)

