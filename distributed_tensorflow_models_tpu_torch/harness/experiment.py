"""The reference's flagship experiment: async-PS vs sync-replica A/B.

PyTorch counterpart of ``distributed_tensorflow_models_tpu/harness/experiment.py``.
The reference repo exists for the comparison between asynchronous
parameter-server training and synchronous replica training on the same
model and data.  :func:`async_vs_sync` (and the CLI's ``ab``) runs the same
config, init and batch stream through

- the **sync** path: ``fit``'s step (``train_loop.MultiStep``: on CUDA the
  step captured as a CUDA graph and replayed), the gradient averaged over
  the data axis, and
- the **async** path: ``parallel/async_ps.py``'s emulator with K virtual
  workers applying gradients in arrival order with logged staleness,

and reports each mode's losses and wall time and the async staleness
profile.  With one worker the async trajectory is the sync one (the tests
hold it bit for bit), so the A/B is apples to apples by construction.

Both modes replay one materialised batch stream (a finite dataset wraps
around), the seed ``cfg.seed + 1``.  Each mode is timed after a warm-up
that builds and captures its programs on the timed state itself (a graph
is bound to the addresses it was captured on) and then writes back every
state tensor it moved; the clock stops after a device sync.  The
optimizer's tables are built for ``max(cfg.train_steps, steps)`` steps:
the schedules do not read the length, and a run past ``train_steps``
would otherwise read past them.  Under a world of W processes each process
feeds its block of every global batch (``sharding.shard_batch``) and the
step averages over the data group, as in ``fit``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from distributed_tensorflow_models_tpu_torch.core import mesh as meshlib
from distributed_tensorflow_models_tpu_torch.core import sharding as shardlib
from distributed_tensorflow_models_tpu_torch.core import train_loop
from distributed_tensorflow_models_tpu_torch.core.train_state import TrainState
from distributed_tensorflow_models_tpu_torch.harness import train as trainlib
from distributed_tensorflow_models_tpu_torch.harness.config import ExperimentConfig
from distributed_tensorflow_models_tpu_torch.ops import _kernels
from distributed_tensorflow_models_tpu_torch.parallel.async_ps import (
    AsyncConfig,
    AsyncPSEmulator,
)


@dataclasses.dataclass
class ABResult:
    sync_losses: list[float]
    async_losses: list[float]
    sync_seconds: float
    async_seconds: float
    mean_staleness: float
    dropped: int
    # staleness value -> event count (the distribution the reference's
    # accumulator drop policy acts on).
    staleness_hist: dict[int, int] = dataclasses.field(default_factory=dict)
    # Not in the JSON: the async events' staleness in order; by mode, the
    # captures' seconds (0 on the CPU) and the hand-written kernels'
    # launches over the timed steps ("<wrapper>.<counter>": n, the ones
    # that launched); with keep_states=True, each mode's final state.
    staleness_log: list[int] = dataclasses.field(default_factory=list)
    capture_s: dict[str, float] = dataclasses.field(default_factory=dict)
    launches: dict[str, dict[str, int]] = dataclasses.field(
        default_factory=dict)
    sync_state: Optional[TrainState] = None
    async_state: Optional[TrainState] = None

    def to_json(self) -> dict:
        return {
            "sync": {
                "final_loss": self.sync_losses[-1],
                "losses": self.sync_losses,
                "seconds": round(self.sync_seconds, 3),
            },
            "async": {
                "final_loss": self.async_losses[-1],
                "losses": self.async_losses,
                "seconds": round(self.async_seconds, 3),
                "mean_staleness": round(self.mean_staleness, 3),
                "staleness_hist": {
                    str(k): v for k, v in sorted(self.staleness_hist.items())
                },
                "dropped": self.dropped,
            },
        }


def ab_batches(cfg: ExperimentConfig, steps: int, mesh: meshlib.Mesh
               ) -> list[dict[str, torch.Tensor]]:
    """``steps`` global batches of the config's training stream (a finite
    dataset wraps around), each cut to this process's block over
    ``mesh`` and put on its device."""
    trainlib.check_seq_len(cfg, mesh)
    dataset = trainlib.build_dataset(cfg, "train", mesh=meshlib.local_mesh(
        "cpu"))
    batches = []
    it = iter(dataset)
    try:
        for _ in range(steps):
            try:
                batch = next(it)
            except StopIteration:
                it = iter(dataset)
                try:
                    batch = next(it)
                except StopIteration:
                    raise ValueError("dataset yielded no batches") from None
            mine = shardlib.shard_batch(mesh, batch, trainlib.seq_dim(cfg))
            batches.append({k: torch.from_numpy(np.ascontiguousarray(v)).to(
                mesh.device) for k, v in mine.items()})
    finally:
        if hasattr(dataset, "close"):
            dataset.close()
    return batches


def _launches_since(before: dict) -> dict[str, int]:
    return {f"{fn.__name__}.{attr}": n - before[(fn, attr)]
            for (fn, attr), n in _kernels.launch_counts().items()
            if n != before[(fn, attr)]}


def async_vs_sync(
    cfg: ExperimentConfig,
    steps: int,
    *,
    num_workers: int = 4,
    schedule: str = "round_robin",
    staleness_limit: Optional[int] = None,
    mesh: Optional[meshlib.Mesh] = None,
    device: Optional[str | torch.device] = None,
    keep_states: bool = False,
) -> ABResult:
    """Run ``steps`` updates in each mode from an identical init and batch
    stream on ``device`` (CUDA unless asked for the CPU; a mesh's own
    device with ``mesh``); returns the paired trajectories."""
    if steps < 1:
        raise ValueError(f"steps must be >= 1, got {steps}")
    if mesh is None:
        mesh = trainlib.mesh_from_config(cfg, device)
    dev = meshlib.resolve_device(mesh.device)
    seed = cfg.seed + 1
    num_steps = max(cfg.train_steps, steps)
    batches = ab_batches(cfg, steps, mesh)
    capture_s, launches = {}, {}

    def build() -> TrainState:
        return train_loop.place_state(
            trainlib.build_state(cfg, dev, mesh, num_steps=num_steps), mesh)

    with meshlib.data_parallel(mesh, trainlib.seq_dim(cfg)):
        # -- sync ---------------------------------------------------------
        state = build()
        multi = train_loop.MultiStep(trainlib.build_step(cfg, state),
                                     name=cfg.model)

        def chunk(b):
            return {k: v[None] for k, v in b.items()}

        saved = train_loop.copy_state(state)
        multi(state, chunk(batches[0]), seed)
        train_loop.restore_state_(state, saved)
        del saved
        capture_s["sync"] = multi.capture_s
        losses = []
        trainlib._sync(dev)
        before = _kernels.launch_counts()
        t0 = time.perf_counter()
        for b in batches:
            state, rows = multi(state, chunk(b), seed)
            losses.append(rows["loss"][0])
        trainlib._sync(dev)
        sync_seconds = time.perf_counter() - t0
        launches["sync"] = _launches_since(before)
        sync_losses = [float(x) for x in torch.stack(losses).tolist()]
        sync_state = state if keep_states else None
        del multi, state
        if dev.type == "cuda":
            torch.cuda.empty_cache()

        # -- async --------------------------------------------------------
        state = build()
        emu = AsyncPSEmulator(
            state, trainlib.build_loss(cfg, state),
            AsyncConfig(num_workers=num_workers, schedule=schedule,
                        seed=cfg.seed, staleness_limit=staleness_limit),
            name=cfg.model)
        emu.warm_up(batches[0], seed)
        capture_s["async"] = emu.programs.capture_s
        losses = []
        trainlib._sync(dev)
        before = _kernels.launch_counts()
        t0 = time.perf_counter()
        for b in batches:
            losses.append(emu.step(b, seed)["metrics"]["loss"])
        trainlib._sync(dev)
        async_seconds = time.perf_counter() - t0
        launches["async"] = _launches_since(before)
        async_losses = [float(x) for x in torch.stack(losses).tolist()]

    if not (np.isfinite(sync_losses).all() and np.isfinite(async_losses).all()):
        raise FloatingPointError(f"a non-finite loss: sync {sync_losses}, "
                                 f"async {async_losses}")
    values, counts = np.unique(np.asarray(emu.staleness_log, np.int64),
                               return_counts=True)
    return ABResult(
        sync_losses=sync_losses,
        async_losses=async_losses,
        sync_seconds=sync_seconds,
        async_seconds=async_seconds,
        mean_staleness=emu.mean_staleness,
        dropped=emu.dropped,
        staleness_hist={int(v): int(c) for v, c in zip(values, counts)},
        staleness_log=list(emu.staleness_log),
        capture_s=capture_s,
        launches=launches,
        sync_state=sync_state,
        async_state=emu.state if keep_states else None,
    )
