"""Backup-replica sync training (straggler mitigation), emulated.

PyTorch counterpart of ``distributed_tensorflow_models_tpu/parallel/backup.py``.
In the reference (TF ``sync_replicas_optimizer.py``), with
``total_num_replicas > replicas_to_aggregate`` every worker computes a
gradient each step, but the accumulators' ``take_grad(N)`` averages only
the first N to arrive; the late (straggler) gradients carry a stale step
stamp and are dropped.  This emulator runs ``M`` virtual replicas on their
own batch shards from the same canonical parameters, draws a seeded
arrival order per round (``np.random.RandomState(seed).permutation(M)``,
the JAX package's draws exactly), averages the first ``N`` gradients and
discards the rest, whose gradients are never computed (only the update
semantics are reproduced, not the wasted work).  The mean is applied with
the last chosen replica's aux (BN statistics, carry, metrics):
PS-resident aux variables were last-writer-wins.  Replica ``r`` of round
``e`` draws its randomness from ``StepRngs.reseed(seed, e * M + r)``.

With ``N == M`` and equal shards the update equals the sync step on the
concatenated batch (the mean of the shards' mean-loss gradients is the
global mean gradient), up to round-off: the tests' anchor.

The port's traps (``parallel/async_ps.py`` names them all) that bite here:
BatchNorm updates its running statistics in place in every replica's
forward, so the canonical statistics are put back before each chosen
replica's forward after the first, and the kept statistics are one update
from the canonical ones by the last chosen replica, as the JAX package's;
the clip reads the mean gradient's whole-array norm
(``train_loop.grad_norm``), taken in the apply program; the permutation is
a host draw, the same on every process; on CUDA the gradient program and
the apply program (the mean, its norm and ``apply_gradients``) are each
captured once, the gradients summed into buffers of the emulator's own
between the gradient replays.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Sequence

import numpy as np
import torch

from distributed_tensorflow_models_tpu_torch.core import train_loop
from distributed_tensorflow_models_tpu_torch.core.train_state import TrainState

Batch = Mapping[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class BackupConfig:
    """``total_replicas``: the reference's ``total_num_replicas``;
    ``replicas_to_aggregate``: how many gradients each round averages;
    ``seed`` drives the per-round arrival permutation."""

    total_replicas: int = 5
    replicas_to_aggregate: int = 4
    seed: int = 0

    def __post_init__(self):
        if not 1 <= self.replicas_to_aggregate <= self.total_replicas:
            raise ValueError(
                f"need 1 <= replicas_to_aggregate "
                f"({self.replicas_to_aggregate}) <= total_replicas "
                f"({self.total_replicas})")


def _apply_mean(n: int):
    """The apply of a round: the mean of the ``n`` summed gradients, its
    whole-array norm for the clip, and ``apply_gradients``."""

    def apply(state: TrainState, sums, aux: dict, norm) -> TrainState:
        mean = {k: v / n for k, v in sums.items()}
        return train_loop.apply_gradients(
            state, mean, aux, train_loop.grad_norm(state.model, mean))

    return apply


class SyncBackupEmulator:
    """First-N-of-M gradient aggregation over a grad/apply pair of programs
    (``train_loop.GradApply``: eager on the CPU, captured CUDA graphs on
    the card unless ``capture=False``)."""

    def __init__(self, state: TrainState, loss_fn: train_loop.LossFn,
                 config: BackupConfig = BackupConfig(),
                 rng_names: Sequence[str] = ("dropout",), *,
                 name: str = "the model", capture: bool = True):
        self.config = config
        self.state = state
        self._sched_rng = np.random.RandomState(config.seed)
        self.discarded: int = 0
        self._event = 0
        self.programs = train_loop.GradApply(
            train_loop.TrainStep(loss_fn, rng_names), name=name,
            capture=capture, apply_fn=_apply_mean(
                config.replicas_to_aggregate))
        with torch.no_grad():
            # The gradients' sum, and the canonical BN statistics while the
            # chosen replicas' forwards move them.
            self._sums = {k: torch.zeros_like(p)
                          for k, p in state.params.items()}
            self._stats = [b.detach().clone() for b in self._buffers()]

    def _buffers(self) -> list[torch.Tensor]:
        return [b for b in self.state.batch_stats.values()
                if b.is_floating_point()]

    def _round(self, state: TrainState, shard_batches: Sequence[Batch],
               chosen: Sequence[int], seed: int, event: int):
        """The chosen replicas' gradients summed into ``self._sums`` (each
        forward from the canonical BN statistics), then the apply: the new
        state and the last chosen replica's metrics."""
        M = self.config.total_replicas
        buffers = self._buffers()
        with torch.no_grad():
            if len(chosen) > 1 and buffers:
                torch._foreach_copy_(self._stats, buffers)
        sums = list(self._sums.values())
        for i, ridx in enumerate(chosen):
            if i and buffers:
                with torch.no_grad():
                    torch._foreach_copy_(buffers, self._stats)
            grads, aux, _, metrics = self.programs.grads(
                state, shard_batches[ridx], seed, event * M + ridx)
            with torch.no_grad():
                if i:
                    torch._foreach_add_(sums, list(grads.values()))
                else:
                    torch._foreach_copy_(sums, list(grads.values()))
        metrics = {k: v.detach().clone() for k, v in metrics.items()}
        return self.programs.apply(state, self._sums, aux, None), metrics

    def step(self, shard_batches: Sequence[Batch], seed: int) -> dict:
        """One aggregation round over one batch per replica (the
        reference's per-worker input streams): the seeded arrival order
        decides which ``replicas_to_aggregate`` gradients win, the rest
        are discarded.  Returns ``chosen``, ``discarded`` and the last
        chosen replica's metrics."""
        M, N = self.config.total_replicas, self.config.replicas_to_aggregate
        if len(shard_batches) != M:
            raise ValueError(
                f"need {M} shard batches, got {len(shard_batches)}")
        order = self._sched_rng.permutation(M)
        chosen = [int(i) for i in order[:N]]
        late = [int(i) for i in order[N:]]
        self.state, metrics = self._round(self.state, shard_batches, chosen,
                                          seed, self._event)
        self.discarded += len(late)
        self._event += 1
        return {"chosen": chosen, "discarded": late, "metrics": metrics}

    def run(self, shard_batch_stream: Sequence[Sequence[Batch]],
            seed: int) -> list[dict]:
        return [self.step(bs, seed) for bs in shard_batch_stream]

    def warm_up(self, shard_batches: Sequence[Batch], seed: int) -> None:
        """Run one round's programs (on CUDA: their eager runs and
        captures) on replicas ``0 .. N-1`` and write every state tensor
        back: the state, the arrival order and the counts are as before."""
        saved = train_loop.copy_state(self.state)
        self._round(self.state, shard_batches,
                    list(range(self.config.replicas_to_aggregate)), seed,
                    self._event)
        train_loop.restore_state_(self.state, saved)


def split_into_shards(batch: Batch, num_shards: int) -> list[dict]:
    """Cut a global batch into equal per-replica shards (row blocks, views
    of ``batch``)."""
    n = next(iter(batch.values())).shape[0]
    if n % num_shards:
        raise ValueError(f"batch {n} not divisible by {num_shards} shards")
    k = n // num_shards
    return [{key: v[i * k:(i + 1) * k] for key, v in batch.items()}
            for i in range(num_shards)]
