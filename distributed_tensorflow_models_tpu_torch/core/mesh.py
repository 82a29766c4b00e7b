"""Device mesh and multi-process bootstrap on ``torch.distributed``.

PyTorch counterpart of ``distributed_tensorflow_models_tpu/core/mesh.py``
for synchronous data parallelism: one process per device, the processes
joined in one ``torch.distributed`` process group (NCCL between CUDA
devices, gloo between CPU processes).  A :class:`Mesh` is that group seen
as the JAX package's named axes: the ``data`` axis spans the processes,
and every other axis has size 1 (tensor, sequence, pipeline and expert
parallelism are not ported; a mesh that asks for them raises).

The JAX package's ops see the mesh implicitly: under ``jit`` a
batch-sharded array makes XLA insert the cross-device reductions.  Here
the ops that reduce over the batch (BatchNorm's moments) or draw for it
(dropout) read the mesh that :func:`data_parallel` makes current, so no
model constructor takes a process group.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import math
import os
from typing import Iterator, Optional

import torch
import torch.distributed as dist


class AxisNames:
    """Canonical mesh axis names, in mesh order.

    ``DATA``    — batch/data parallelism (gradient all-reduce rides this axis).
    ``MODEL``   — tensor parallelism (weight shards).
    ``SEQ``     — sequence/context parallelism (ring attention, Ulysses).
    ``PIPE``    — pipeline stages.
    ``EXPERT``  — MoE expert parallelism.
    """

    DATA = "data"
    MODEL = "model"
    SEQ = "seq"
    PIPE = "pipe"
    EXPERT = "expert"

    ALL: tuple[str, ...] = (DATA, MODEL, SEQ, PIPE, EXPERT)


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """Logical mesh shape.  ``-1`` means "absorb all remaining devices".

    The default is pure data parallelism — the only strategy the reference
    supports (SURVEY.md §2.4) — with every other axis of size 1 so that
    ``PartitionSpec``\\ s naming those axes remain valid no-ops until the axis
    is actually widened.
    """

    data: int = -1
    model: int = 1
    seq: int = 1
    pipe: int = 1
    expert: int = 1

    def sizes(self, num_devices: int) -> tuple[int, ...]:
        dims = [self.data, self.model, self.seq, self.pipe, self.expert]
        n_infer = sum(1 for d in dims if d == -1)
        if n_infer > 1:
            raise ValueError(f"at most one axis may be -1, got {self}")
        fixed = math.prod(d for d in dims if d != -1)
        if n_infer == 1:
            if num_devices % fixed != 0:
                raise ValueError(
                    f"{num_devices} devices not divisible by fixed axes "
                    f"product {fixed} in {self}"
                )
            dims = [num_devices // fixed if d == -1 else d for d in dims]
        elif fixed != num_devices:
            raise ValueError(
                f"mesh {self} wants {fixed} devices, have {num_devices}"
            )
        return tuple(dims)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This process's place in the data-parallel world.

    ``sizes`` are the axis sizes in :class:`AxisNames` order (the data
    axis first, the rest 1); ``rank`` is this process's index on the data
    axis, ``world_size`` the axis's size, ``device`` the one device this
    process computes on, and ``group`` the process group the collectives
    run over (None for a process that joined none: then nothing is
    reduced, and a ``world_size`` above 1 only says which rows of a
    global draw are this process's, as dropout reads it)."""

    sizes: tuple[int, ...]
    rank: int
    world_size: int
    device: torch.device
    group: Optional[dist.ProcessGroup] = None

    def __post_init__(self):
        if self.sizes[0] != self.world_size or not (
                0 <= self.rank < self.world_size):
            raise ValueError(f"rank {self.rank} of a data axis of "
                             f"{self.sizes[0]} in a world of "
                             f"{self.world_size}")

    @property
    def shape(self) -> dict[str, int]:
        """Axis name -> size, as ``jax.sharding.Mesh.shape``."""
        return dict(zip(AxisNames.ALL, self.sizes))

    @property
    def data_size(self) -> int:
        return self.sizes[0]

    @property
    def backend(self) -> Optional[str]:
        """``"nccl"`` or ``"gloo"``; None without a group."""
        return None if self.group is None else dist.get_backend(self.group)


def _data_only(sizes: tuple[int, ...]) -> tuple[int, ...]:
    wide = {name: n for name, n in zip(AxisNames.ALL[1:], sizes[1:])
            if n != 1}
    if wide:
        raise NotImplementedError(
            f"mesh axes {wide} are not ported: the port is data parallel "
            f"only (tensor, sequence, pipeline and expert parallelism are "
            f"the parallel layers, ROADMAP §1 item 1)")
    return sizes


def _check_device(device: torch.device, backend: str) -> torch.device:
    """The device this process computes on, checked against the group's
    backend: NCCL reduces CUDA tensors and gloo CPU ones here, and a
    mismatch raises rather than running on the other device."""
    want = "cuda" if backend == "nccl" else "cpu"
    if device.type != want:
        raise RuntimeError(
            f"the process group's backend is {backend}, which this port "
            f"runs on {want} devices; the process was asked for {device}")
    return device


def resolve_device(device: Optional[str | torch.device] = None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    the CPU.  Raises when CUDA is wanted and absent — never falls back."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device available; pass device='cpu' (--device cpu) "
            "to run on the CPU"
        )
    return dev


def create_mesh(spec: Optional[MeshSpec] = None,
                device: Optional[str | torch.device] = None) -> Mesh:
    """The mesh of ``spec`` over ``torch.distributed``'s world: every
    process of the default group on the data axis, or a world of one (no
    group, no collective) when no group is initialised.

    ``device`` defaults to the group's: the CUDA device the process set
    for NCCL, the CPU for gloo; without a group, CUDA, which must be
    there (the CPU must be asked for)."""
    spec = spec or MeshSpec()
    if not dist.is_initialized():
        return Mesh(_data_only(spec.sizes(1)), 0, 1, resolve_device(device))
    backend = dist.get_backend()
    if device is None:
        device = (torch.device("cuda", torch.cuda.current_device())
                  if backend == "nccl" else torch.device("cpu"))
    world = dist.get_world_size()
    return Mesh(_data_only(spec.sizes(world)), dist.get_rank(), world,
                _check_device(torch.device(device), backend),
                dist.group.WORLD)


def data_parallel_mesh(device: Optional[str | torch.device] = None) -> Mesh:
    """All processes on the ``data`` axis — the reference's only topology."""
    return create_mesh(MeshSpec(), device)


def local_mesh(device: Optional[str | torch.device] = None) -> Mesh:
    """A world of one with no process group, whether or not one is
    initialised: the mesh of a step that issues no collective."""
    return Mesh(_data_only(MeshSpec().sizes(1)), 0, 1, resolve_device(device))


def initialize_multihost(coordinator_address: str, num_processes: int,
                         process_id: int,
                         device: Optional[str | torch.device] = None
                         ) -> torch.device:
    """Join the process group of ``num_processes`` processes as
    ``process_id``, rendezvousing on a TCP store at
    ``coordinator_address`` (``host:port``; process 0 serves it).

    The device is ``cuda:{LOCAL_RANK or 0}`` unless the caller asks for
    another (``"cpu"``); the backend follows it: NCCL for CUDA, gloo for
    the CPU.  A CUDA device without CUDA or NCCL raises: nothing falls
    back to gloo or to the CPU.  Returns the device."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device available for the process "
                               "group; ask for device='cpu' to use gloo")
        if not dist.is_nccl_available():
            raise RuntimeError("this torch has no NCCL; a CUDA process "
                               "group needs it")
        if dev.index is None:
            dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(dev)
        backend = "nccl"
    elif dev.type == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"no process group backend for {dev}")
    dist.init_process_group(backend,
                            init_method=f"tcp://{coordinator_address}",
                            world_size=int(num_processes),
                            rank=int(process_id))
    return dev


def local_batch_size(global_batch_size: int, mesh: Mesh) -> int:
    """Per-process slice of the global batch.

    In the reference, each worker chooses its own ``batch_size`` flag and the
    effective global batch is ``batch_size * num_workers`` (implicit in the
    SyncReplicasOptimizer aggregation count, TF sync_replicas_optimizer.py:
    155-162).  Here the *global* batch is primary and each host feeds its
    shard of it.
    """
    n_data = mesh.shape[AxisNames.DATA]
    n_proc = mesh.world_size
    if global_batch_size % n_data != 0:
        raise ValueError(
            f"global batch {global_batch_size} not divisible by data-axis "
            f"size {n_data}"
        )
    if global_batch_size % n_proc != 0:
        raise ValueError(
            f"global batch {global_batch_size} not divisible by process "
            f"count {n_proc}"
        )
    return global_batch_size // n_proc


_CURRENT: contextvars.ContextVar[Optional[Mesh]] = contextvars.ContextVar(
    "dtm_data_parallel_mesh", default=None)


@contextlib.contextmanager
def data_parallel(mesh: Optional[Mesh]) -> Iterator[Optional[Mesh]]:
    """Make ``mesh`` the data axis the ops see (:func:`current_mesh`) on
    this thread until the block ends: BatchNorm reduces its moments over
    the mesh's group, dropout draws its mask for the global batch.  A
    captured step reads it at capture time, which runs on the caller's
    thread; what an op needs in its backward it keeps from its forward."""
    token = _CURRENT.set(mesh)
    try:
        yield mesh
    finally:
        _CURRENT.reset(token)


def current_mesh() -> Optional[Mesh]:
    """The mesh of the innermost :func:`data_parallel` block on this
    thread, None outside one."""
    return _CURRENT.get()
