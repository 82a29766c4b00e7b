"""Device mesh and multi-process bootstrap on ``torch.distributed``.

PyTorch counterpart of ``distributed_tensorflow_models_tpu/core/mesh.py``:
one process per device, the processes joined in one ``torch.distributed``
process group (NCCL between CUDA devices, gloo between CPU processes).  A
:class:`Mesh` is that world seen as the JAX package's named axes, laid out
as JAX lays its devices out: a process's coordinates are its rank
unravelled over the sizes in :class:`AxisNames` order.

- ``data`` — each process reads its rows of every global batch;
  BatchNorm's moments are reduced over the data group.
- ``model`` — tensor parallelism: the parameters that a rule set names
  are split over it (``parallel/tensor.py``); its group carries the
  layers' all-gathers and partial sums.
- ``seq`` — sequence parallelism: a language model's tokens are split
  into column blocks over it; its group carries the ring's rotations and
  Ulysses' all-to-alls (``parallel/ring.py``).
- ``pipe`` — pipeline parallelism: the pipelined block stack's layers are
  split over it, one stage per process; its group carries the
  activations' rotations from stage to stage (``parallel/pipeline.py``).
- ``expert`` — expert parallelism: the MoE FFN's experts are split over
  it; its group carries the two all-to-alls of the routed tokens
  (``parallel/moe.py``).
- The gradients and the metrics are averaged over data x seq, the
  ``dp_group``.  The processes of one data block hold its rows whatever
  their model, pipe and expert coordinates (the batch is split over
  ``data`` only, and a language model's tokens over ``seq``).

An axis of size one issues no collective (it gets no group), so a mesh
that widens only the data axis runs the data-parallel step unchanged.  The
JAX package's ops see the mesh implicitly: under ``jit`` a sharded array
makes XLA insert the collectives.  Here the ops read the mesh that
:func:`data_parallel` makes current, so no model constructor takes a
process group.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import math
import os
from typing import Iterator, Mapping, Optional

import numpy as np
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
    """This process's place in the mesh of processes.

    ``sizes`` are the axis sizes in :class:`AxisNames` order.  ``rank`` is
    this process's index on the data axis and ``world_size`` the data
    axis's size (so ``batch_rows`` and the datasets read rows by them);
    ``coords`` are its coordinates on all five axes, ``process_index``
    and ``process_count`` its place in the whole world.  ``device`` is the
    one device this process computes on.

    The groups: ``group`` is the data axis's (the processes that differ
    only in their data coordinate; BatchNorm's moments are reduced over
    it), ``axis_groups`` maps ``"model"``, ``"seq"``, ``"pipe"`` and
    ``"expert"`` to theirs where the axis is wider than one, and
    ``dp_group`` is data x seq (the processes that share this one's
    model, pipe and expert coordinates: the gradients and metrics are
    averaged over it).  A group is None where nothing is to be
    reduced: without a process group, and for an axis of size one inside
    a wider world (a world of one keeps its group on the data axis, so a
    world-1 NCCL group still issues the step's collectives).  A process
    with no group and a data axis above one only says which rows of a
    global draw are its own, as dropout reads it."""

    sizes: tuple[int, ...]
    rank: int
    world_size: int
    device: torch.device
    group: Optional[dist.ProcessGroup] = None
    coords: Optional[tuple[int, ...]] = None
    process_index: Optional[int] = None
    process_count: Optional[int] = None
    axis_groups: Mapping[str, dist.ProcessGroup] = dataclasses.field(
        default_factory=dict)
    dp_group: Optional[dist.ProcessGroup] = None

    def __post_init__(self):
        if self.sizes[0] != self.world_size or not (
                0 <= self.rank < self.world_size):
            raise ValueError(f"rank {self.rank} of a data axis of "
                             f"{self.sizes[0]} in a world of "
                             f"{self.world_size}")
        if self.coords is None:
            object.__setattr__(self, "coords",
                               (self.rank,) + (0,) * (len(self.sizes) - 1))
        if self.process_index is None:
            object.__setattr__(self, "process_index", self.rank)
        if self.process_count is None:
            object.__setattr__(self, "process_count", math.prod(self.sizes))
        if self.dp_group is None and self.sizes[2] == 1:
            object.__setattr__(self, "dp_group", self.group)
        if self.coords[0] != self.rank:
            raise ValueError(f"data coordinate {self.coords[0]} is not the "
                             f"rank {self.rank}")

    @property
    def shape(self) -> dict[str, int]:
        """Axis name -> size, as ``jax.sharding.Mesh.shape``."""
        return dict(zip(AxisNames.ALL, self.sizes))

    @property
    def data_size(self) -> int:
        return self.sizes[0]

    @property
    def model_size(self) -> int:
        return self.sizes[1]

    @property
    def seq_size(self) -> int:
        return self.sizes[2]

    @property
    def pipe_size(self) -> int:
        return self.sizes[3]

    @property
    def expert_size(self) -> int:
        return self.sizes[4]

    @property
    def dp_size(self) -> int:
        """Processes the gradients are averaged over: data x seq."""
        return self.sizes[0] * self.sizes[2]

    def coord(self, axis: str) -> int:
        """This process's index on ``axis``."""
        return self.coords[AxisNames.ALL.index(axis)]

    def axis_group(self, axis: str) -> Optional[dist.ProcessGroup]:
        """The group of ``axis`` (any of :class:`AxisNames`); None where
        the axis issues nothing."""
        if axis == AxisNames.DATA:
            return self.group
        return self.axis_groups.get(axis)

    def global_rank(self, **coords: int) -> int:
        """The world rank of the process at this one's coordinates with
        ``coords`` changed (``global_rank(seq=2)``)."""
        at = list(self.coords)
        for name, c in coords.items():
            at[AxisNames.ALL.index(name)] = c
        return int(np.ravel_multi_index(at, self.sizes))

    @property
    def backend(self) -> Optional[str]:
        """``"nccl"`` or ``"gloo"``; None without a group."""
        for g in (self.group, self.dp_group, *self.axis_groups.values()):
            if g is not None:
                return dist.get_backend(g)
        return None


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


def _groups_over(sizes: tuple[int, ...], axes: tuple[int, ...],
                 rank: int) -> Optional[dist.ProcessGroup]:
    """The group of the processes that differ from ``rank`` only on
    ``axes`` (indices into ``sizes``): the world's group when that is every
    process, None when it is ``rank`` alone, else a new group.  Every
    process creates every such group, in the same order (the contract of
    ``dist.new_group``), and keeps its own."""
    n = math.prod(sizes[a] for a in axes)
    if n == 1:
        return None
    world = math.prod(sizes)
    if n == world:
        return dist.group.WORLD
    grid = np.arange(world).reshape(sizes)
    keep = [a for a in range(len(sizes)) if a not in axes]
    grid = np.moveaxis(grid, keep + list(axes), range(len(sizes)))
    mine = None
    for ranks in grid.reshape(-1, n).tolist():
        g = dist.new_group(ranks)
        if rank in ranks:
            mine = g
    return mine


def create_mesh(spec: Optional[MeshSpec] = None,
                device: Optional[str | torch.device] = None) -> Mesh:
    """The mesh of ``spec`` over ``torch.distributed``'s world, or a world
    of one (no group, no collective) when no group is initialised.  A
    process's coordinates are its rank unravelled over the five sizes in
    :class:`AxisNames` order (the JAX package reshapes its devices so).
    The model, seq, pipe and expert axes get a group each where they are
    wider than one (in that order), and data x seq its own where both
    are; every group is created here, before any step runs, in the same
    order on every process.

    ``device`` defaults to the group's: the CUDA device the process set
    for NCCL, the CPU for gloo; without a group, CUDA, which must be
    there (the CPU must be asked for)."""
    spec = spec or MeshSpec()
    if not dist.is_initialized():
        return Mesh(spec.sizes(1), 0, 1, resolve_device(device))
    backend = dist.get_backend()
    if device is None:
        device = (torch.device("cuda", torch.cuda.current_device())
                  if backend == "nccl" else torch.device("cpu"))
    world, rank = dist.get_world_size(), dist.get_rank()
    sizes = spec.sizes(world)
    coords = tuple(int(c) for c in np.unravel_index(rank, sizes))
    data, seq = 0, 2
    group = (dist.group.WORLD if sizes[data] == world
             else _groups_over(sizes, (data,), rank))
    axis_groups = {}
    for axis, name in enumerate(AxisNames.ALL[1:], start=1):
        g = _groups_over(sizes, (axis,), rank)
        if g is not None:
            axis_groups[name] = g
    if sizes[seq] == 1:
        dp_group = group
    elif sizes[data] == 1:
        dp_group = axis_groups[AxisNames.SEQ]
    else:
        dp_group = _groups_over(sizes, (data, seq), rank)
    return Mesh(sizes, coords[data], sizes[data],
                _check_device(torch.device(device), backend), group,
                coords=coords, process_index=rank, process_count=world,
                axis_groups=axis_groups, dp_group=dp_group)


def data_parallel_mesh(device: Optional[str | torch.device] = None) -> Mesh:
    """All processes on the ``data`` axis — the reference's only topology."""
    return create_mesh(MeshSpec(), device)


def local_mesh(device: Optional[str | torch.device] = None) -> Mesh:
    """A world of one with no process group, whether or not one is
    initialised: the mesh of a step that issues no collective."""
    return Mesh(MeshSpec().sizes(1), 0, 1, resolve_device(device))


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
_SEQ_DIM: contextvars.ContextVar[Optional[int]] = contextvars.ContextVar(
    "dtm_seq_dim", default=None)


@contextlib.contextmanager
def data_parallel(mesh: Optional[Mesh],
                  seq_dim: Optional[int] = None) -> Iterator[Optional[Mesh]]:
    """Make ``mesh`` the mesh the ops see (:func:`current_mesh`) on this
    thread until the block ends: BatchNorm reduces its moments over the
    data axis's group, dropout draws its mask for the global batch, the
    tensor-parallel layers and the sequence-parallel attention use the
    model and seq groups.  ``seq_dim`` (:func:`current_seq_dim`) is the
    dimension of the activations that the seq axis splits (1 for a
    language model's ``[B, T, ...]``; None where the seq processes hold
    the same columns).  A captured step reads both at capture time, which
    runs on the caller's thread; what an op needs in its backward it
    keeps from its forward."""
    token = _CURRENT.set(mesh)
    seq_token = _SEQ_DIM.set(seq_dim)
    try:
        yield mesh
    finally:
        _SEQ_DIM.reset(seq_token)
        _CURRENT.reset(token)


def current_mesh() -> Optional[Mesh]:
    """The mesh of the innermost :func:`data_parallel` block on this
    thread, None outside one."""
    return _CURRENT.get()


def current_layout() -> tuple[Optional[Mesh], Optional[int]]:
    """``(mesh, seq_dim)`` of the innermost :func:`data_parallel` block,
    to re-enter it on another thread (``data_parallel(*layout)``)."""
    return _CURRENT.get(), _SEQ_DIM.get()


def current_seq_dim() -> Optional[int]:
    """The activations' dimension split over the seq axis in the innermost
    :func:`data_parallel` block: None outside one, where it was not given,
    or where the seq axis has size one."""
    mesh = _CURRENT.get()
    if mesh is None or mesh.seq_size == 1:
        return None
    return _SEQ_DIM.get()
