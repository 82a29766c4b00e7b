"""Placement and the collectives of the step.

PyTorch counterpart of ``distributed_tensorflow_models_tpu/core/sharding.py``.
The JAX package lays arrays out declaratively (parameters replicated or
split by rule over the ``model`` axis, the batch over ``data`` and a
language model's tokens over ``seq``) and XLA compiles the collectives.
Here each process holds its block of every batch (:func:`batch_rows`,
:func:`shard_batch`) and its slice of each split parameter
(:func:`tree_param_shardings` says which; ``parallel/tensor.py`` cuts
them), and the collectives are issued explicitly over the mesh's groups
(``core/mesh.py``):

- :func:`all_reduce_mean_` — the gradients over data x seq, flattened into
  one bucket per dtype (f32, or f64 for f64), one all-reduce each (XLA
  likewise combines the reference's per-parameter reductions), then
  divided by the number of processes; :func:`all_reduce_metrics` the
  step's metric vector likewise;
- :func:`all_reduce_sum_` — any f32 tensor summed in place over the data
  axis (BatchNorm's moments and their cotangents);
- :func:`all_gather_rows` — the data x seq group's token blocks laid out
  as the global batch, differentiably (the MoE FFN's tokens,
  ``parallel/moe.py``);
- on the ``model`` axis (Megatron's pair and the gather): :func:`gather`,
  an all-gather along a dim whose backward slices; :func:`reduce_sum`, an
  all-reduce whose backward is the identity (*g*); :func:`copy_in`, the
  identity whose backward all-reduces (*f*);
- on the ``seq`` axis: :func:`ring`, the point-to-point rotations around
  the ring, whose backward rotates the other way, and :func:`all_to_all`;
- on the ``pipe`` axis: :func:`rotate`, one point-to-point rotation of the
  pipeline's activations to the next stage (its backward the other way),
  with *f* and *g* (:func:`copy_in`, :func:`reduce_sum`) on the stack's
  input and output;
- on the ``expert`` axis: :func:`split`, this process's chunk of the
  tokens, whose backward all-gathers the chunks' cotangents, the two
  exchanges of the routed slots (:func:`all_to_all`), the combined chunks
  gathered back (:func:`gather`) and *f* on the router;
- :func:`square_sum`, the sum of squares of a tree of tensors as whole
  arrays: the split tensors' partial sums summed over their axes, the
  replicated ones counted once (the gradient norm that clipping reads).

Without a process group nothing is issued: a world of one with no group
runs the single-device step unchanged, and so does an axis of size one.
On NCCL a sum of an f32 or f64 tensor is issued as a sum pre-multiplied
by 1 (``_make_nccl_premul_sum(1.0)``): the same sum, bit for bit, but NCCL
launches a kernel for it at one rank too, where it makes a plain in-place
sum a no-op that never reaches the device.  A bf16 or f16 tensor's sum
is the plain SUM (at one rank the card's NCCL zeroed a bf16 tensor's
pre-multiplied sum).

Every collective counts itself under its site (``collective_counts``),
like the kernels' launch counters, the model, seq, pipe and expert axes'
under sites that start with the axis's name: a captured step takes off what its
capture counted and adds it back per replay (:func:`add_collectives`).
"""

from __future__ import annotations

import collections
import re
from typing import Iterable, Mapping, Optional, Sequence

import torch
import torch.distributed as dist

from distributed_tensorflow_models_tpu_torch.core.mesh import AxisNames, Mesh

REPLICATED = "replicated"

# Collectives issued, by site: (count, bytes).
_issued: dict[str, list[int]] = collections.defaultdict(lambda: [0, 0])


def collective_counts() -> dict[str, tuple[int, int]]:
    """Each site's collectives so far: ``{site: (count, bytes)}``."""
    return {site: (n, b) for site, (n, b) in _issued.items() if n}


def add_collectives(counts: Mapping[str, tuple[int, int]],
                    times: int = 1) -> None:
    """Add ``times`` x ``counts`` to the counters (a negative ``times``
    takes them off)."""
    for site, (n, b) in counts.items():
        _issued[site][0] += times * n
        _issued[site][1] += times * b


def counts_since(before: Mapping[str, tuple[int, int]]
                 ) -> dict[str, tuple[int, int]]:
    """What the counters gained since ``before`` (a ``collective_counts``)."""
    now = collective_counts()
    out = {}
    for site, (n, b) in now.items():
        n0, b0 = before.get(site, (0, 0))
        if n != n0 or b != b0:
            out[site] = (n - n0, b - b0)
    return out


def batch_rows(mesh: Mesh, n: int) -> slice:
    """This process's rows of a global leading axis of ``n``: the
    ``rank``-th of ``data_size`` equal blocks, in process order, as the
    JAX package's data sharding lays a global batch out."""
    w = mesh.data_size
    if n % w:
        raise ValueError(f"a leading axis of {n} does not split over a "
                         f"data axis of {w}")
    b = n // w
    return slice(mesh.rank * b, (mesh.rank + 1) * b)


def seq_cols(mesh: Mesh, n: int) -> slice:
    """This process's block of a global token axis of ``n``: the
    ``coord(seq)``-th of ``seq_size`` equal blocks."""
    w = mesh.seq_size
    if n % w:
        raise ValueError(f"a sequence of {n} does not split over a seq "
                         f"axis of {w}")
    b = n // w
    c = mesh.coord(AxisNames.SEQ)
    return slice(c * b, (c + 1) * b)


def _seq_split(x: torch.Tensor, mesh: Mesh, seq_dim: Optional[int]):
    n = mesh.seq_size
    if (seq_dim is None or n == 1 or x.ndim <= seq_dim
            or x.shape[seq_dim] % n):
        return x
    index = [slice(None)] * x.ndim
    index[seq_dim] = seq_cols(mesh, x.shape[seq_dim])
    return x[tuple(index)]


def seq_split(mesh: Mesh, batch: Mapping[str, torch.Tensor],
              seq_dim: Optional[int]) -> dict[str, torch.Tensor]:
    """This process's columns over ``seq`` of each leaf of ``batch`` (its
    rows already this process's), along ``seq_dim``.  As in the JAX
    package's ``shard_batch``, only leaves wide enough to split evenly are
    split; the rest are kept whole."""
    return {k: _seq_split(v, mesh, seq_dim) for k, v in batch.items()}


def shard_batch(mesh: Mesh, batch: Mapping[str, torch.Tensor],
                seq_dim: Optional[int] = None) -> dict[str, torch.Tensor]:
    """This process's block of a global batch: its rows over ``data``
    (:func:`batch_rows`) and, with ``seq_dim``, its columns over ``seq``
    (:func:`seq_split`)."""
    rows = {k: v[batch_rows(mesh, v.shape[0])] for k, v in batch.items()}
    return seq_split(mesh, rows, seq_dim)


def _sum_op(group: dist.ProcessGroup, dtype: torch.dtype):
    """SUM; on NCCL, for f32 and f64, the sum pre-multiplied by 1 (module
    docstring).  Not for bf16 or f16: at one rank the card's NCCL gave
    zeros for a bf16 tensor's pre-multiplied sum, so those take the plain
    SUM (a no-op at one rank)."""
    if dist.get_backend(group) == "nccl" and dtype in (torch.float32,
                                                        torch.float64):
        return dist._make_nccl_premul_sum(1.0)
    return dist.ReduceOp.SUM


def _group(mesh: Optional[Mesh], dp: bool = False
           ) -> Optional[dist.ProcessGroup]:
    """The group to reduce over (the data axis's, or with ``dp`` data x
    seq's); None where nothing is to be reduced.  An axis wider than one
    without a group cannot be reduced: raise."""
    if mesh is None:
        return None
    group = mesh.dp_group if dp else mesh.group
    size = mesh.dp_size if dp else mesh.world_size
    if group is None and size > 1:
        raise RuntimeError(
            f"a data axis of {size} with no process group cannot reduce "
            f"across its processes")
    return group


def all_reduce_sum_(t: torch.Tensor, mesh: Optional[Mesh],
                    site: str, dp: bool = False) -> torch.Tensor:
    """Sum ``t`` in place over the data axis's processes (with ``dp``,
    data x seq's; nothing without a group) and count it under ``site``;
    returns ``t``."""
    group = _group(mesh, dp)
    if group is not None:
        dist.all_reduce(t, op=_sum_op(group, t.dtype), group=group)
        add_collectives({site: (1, t.numel() * t.element_size())})
    return t


def _gather_list(x: torch.Tensor, group, n: int, site: str
                 ) -> list[torch.Tensor]:
    """The group's ``n`` copies of ``x``'s shape, in rank order: one
    all-gather into one buffer, viewed as its ``n`` parts (no copy per
    part)."""
    x = x.contiguous()
    out = torch.empty(n * x.numel(), dtype=x.dtype, device=x.device)
    dist.all_gather_into_tensor(out, x.reshape(-1), group=group)
    add_collectives({site: (1, n * x.numel() * x.element_size())})
    return list(out.view(n, *x.shape).unbind(0))


class _AllGatherRows(torch.autograd.Function):
    """Forward: the data x seq group's ``[Bl, Tl, ...]`` blocks laid out
    as the global ``[B, T, ...]`` batch (rows by data coordinate, columns
    by seq coordinate), flattened to ``[B*T, ...]``.  Backward: the
    cotangent of the whole summed over the processes (each computed its
    own loss from the gathered tokens), and this process's block of the
    sum."""

    @staticmethod
    def forward(ctx, x, mesh, site):
        D, S = mesh.data_size, mesh.seq_size
        parts = _gather_list(x, mesh.dp_group, D * S, site)
        whole = torch.stack(parts).view(D, S, *x.shape)
        whole = whole.transpose(1, 2).reshape(D * x.shape[0],
                                              S * x.shape[1], *x.shape[2:])
        ctx.mesh, ctx.site, ctx.shape = mesh, site, x.shape
        return whole.reshape(-1, *x.shape[2:])

    @staticmethod
    def backward(ctx, g):
        mesh, (Bl, Tl) = ctx.mesh, ctx.shape[:2]
        g = g.contiguous().clone()
        all_reduce_sum_(g, mesh, f"{ctx.site}_grad", dp=True)
        g = g.view(mesh.data_size * Bl, mesh.seq_size * Tl, *ctx.shape[2:])
        r, c = mesh.rank, mesh.coord(AxisNames.SEQ)
        return (g[r * Bl:(r + 1) * Bl, c * Tl:(c + 1) * Tl].contiguous(),
                None, None)


def _as_grid(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """``x [..., d]`` as the ``[Bl, Tl, d]`` block of the global token
    grid: its rows read as ``Tl`` = 1 where the seq axis has size one (or
    ``x`` has no token axis)."""
    if mesh.seq_size == 1 or x.ndim < 3:
        return x.reshape(-1, 1, x.shape[-1])
    return x.reshape(x.shape[0], x.shape[1], x.shape[-1])


def all_gather_rows(x: torch.Tensor, mesh: Mesh, site: str) -> torch.Tensor:
    """The tokens of the data x seq group as the global batch: ``x [...,
    d]`` is this process's block of tokens (``[Bl, Tl, d]`` under a seq
    axis; any rows without one); the result is ``[N, d]`` in the global
    batch's row-major order, over the mesh's data x seq group, counted
    under ``site`` (and its backward's sum under ``site + "_grad"``).
    :func:`own_rows` takes this process's block back out.  ``x``
    flattened without a group."""
    if _group(mesh, dp=True) is None:
        return x.reshape(-1, x.shape[-1])
    return _AllGatherRows.apply(_as_grid(x, mesh), mesh, site)


def own_rows(y: torch.Tensor, mesh: Mesh, block: Sequence[int]
             ) -> torch.Tensor:
    """This process's tokens, shaped ``[*block, d]``, of ``y [N, d]``, a
    result over the tokens of :func:`all_gather_rows` of a ``block``-
    shaped ``x``."""
    if _group(mesh, dp=True) is None:
        return y.reshape(*block, y.shape[-1])
    grid = _as_grid(torch.empty(*block, 1, device="meta"), mesh).shape
    Bl, Tl = grid[0], grid[1]
    g = y.view(mesh.data_size * Bl, mesh.seq_size * Tl, y.shape[-1])
    c = mesh.coord(AxisNames.SEQ)
    out = g[mesh.rank * Bl:(mesh.rank + 1) * Bl, c * Tl:(c + 1) * Tl]
    return out.reshape(*block, y.shape[-1])


def all_reduce_mean_(tensors: Iterable[torch.Tensor], mesh: Optional[Mesh],
                     site: str = "grads") -> None:
    """Replace each tensor by its mean over the mesh's data x seq
    processes, in place: the tensors of each dtype flattened into one
    bucket (f32, or f64 for f64), one sum over the group, divided by the
    number of processes and copied back.  Nothing is issued without a
    group (nor over an axis of one)."""
    if _group(mesh, dp=True) is None:
        return
    by_dtype: dict[torch.dtype, list[torch.Tensor]] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for dtype, ts in by_dtype.items():
        acc = torch.promote_types(dtype, torch.float32)
        bucket = torch.cat([t.reshape(-1).to(acc) for t in ts])
        all_reduce_sum_(bucket, mesh, site, dp=True)
        bucket.div_(mesh.dp_size)
        for t, part in zip(ts, bucket.split([t.numel() for t in ts])):
            t.copy_(part.view_as(t))


def all_reduce_metrics(metrics: Mapping[str, torch.Tensor],
                       mesh: Optional[Mesh]) -> dict[str, torch.Tensor]:
    """The step's scalar metrics averaged over the mesh's data x seq
    processes in one small collective (as f32); unchanged without a
    group."""
    if _group(mesh, dp=True) is None:
        return dict(metrics)
    names = list(metrics)
    vec = torch.stack([metrics[n].float() for n in names])
    all_reduce_sum_(vec, mesh, "metrics", dp=True)
    vec.div_(mesh.dp_size)
    return {n: vec[i] for i, n in enumerate(names)}


# ------------------------------------- the model, seq, pipe and expert axes


class _Gather(torch.autograd.Function):
    """All-gather along ``dim`` over an axis; the backward takes this
    process's slice (what follows is computed alike on every process of
    the axis, so every process holds the whole cotangent)."""

    @staticmethod
    def forward(ctx, x, mesh, axis, dim, site):
        n = mesh.shape[axis]
        parts = _gather_list(x, mesh.axis_group(axis), n, site)
        ctx.dim, ctx.n, ctx.index = dim, n, mesh.coord(axis)
        return torch.cat(parts, dim=dim)

    @staticmethod
    def backward(ctx, g):
        return (g.chunk(ctx.n, dim=ctx.dim)[ctx.index].contiguous(),
                None, None, None, None)


class _ReduceSum(torch.autograd.Function):
    """Megatron's *g*: an all-reduce sum over an axis; the backward is the
    identity."""

    @staticmethod
    def forward(ctx, x, mesh, axis, site):
        y = x.contiguous().clone()
        group = mesh.axis_group(axis)
        dist.all_reduce(y, op=_sum_op(group, y.dtype), group=group)
        add_collectives({site: (1, y.numel() * y.element_size())})
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None, None, None


class _CopyIn(torch.autograd.Function):
    """Megatron's *f*: the identity; the backward sums the cotangent over
    an axis (each process's layers saw only its slice of the weights)."""

    @staticmethod
    def forward(ctx, x, mesh, axis, site):
        ctx.mesh, ctx.axis, ctx.site = mesh, axis, site
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        group = ctx.mesh.axis_group(ctx.axis)
        dist.all_reduce(g, op=_sum_op(group, g.dtype), group=group)
        add_collectives({ctx.site: (1, g.numel() * g.element_size())})
        return g, None, None, None


def _wide(mesh: Optional[Mesh], axis: str, x: torch.Tensor) -> bool:
    """True when ``x`` is to be exchanged over the axis: the axis has a
    group, and ``x`` holds values (on the meta device, where a step's
    FLOPs are counted, the collectives keep only their shapes)."""
    return (mesh is not None and mesh.axis_group(axis) is not None
            and x.device.type != "meta")


def gather(x: torch.Tensor, mesh: Optional[Mesh], dim: int,
           axis: str = AxisNames.MODEL, site: str = "gather"
           ) -> torch.Tensor:
    """The axis's slices of ``x`` concatenated along ``dim`` in coordinate
    order (an all-gather, counted under ``"<axis>/<site>"``); its backward
    slices.  ``x`` itself on an axis of one."""
    if mesh is not None and x.device.type == "meta":
        return torch.cat([x] * mesh.shape[axis], dim=dim)
    if not _wide(mesh, axis, x):
        return x
    return _Gather.apply(x, mesh, axis, dim, f"{axis}/{site}")


def reduce_sum(x: torch.Tensor, mesh: Optional[Mesh],
               axis: str = AxisNames.MODEL, site: str = "sum"
               ) -> torch.Tensor:
    """``x`` summed over the axis (*g*; counted under
    ``"<axis>/<site>"``); ``x`` itself on an axis of one."""
    if not _wide(mesh, axis, x):
        return x
    return _ReduceSum.apply(x, mesh, axis, f"{axis}/{site}")


def copy_in(x: torch.Tensor, mesh: Optional[Mesh],
            axis: str = AxisNames.MODEL, site: str = "copy_grad"
            ) -> torch.Tensor:
    """``x``, whose cotangent is summed over the axis in the backward
    (*f*; counted under ``"<axis>/<site>"``); ``x`` itself on an axis of
    one."""
    if not _wide(mesh, axis, x):
        return x
    return _CopyIn.apply(x, mesh, axis, f"{axis}/{site}")


def _sendrecv(xs: Sequence[torch.Tensor], mesh: Mesh, axis: str,
              shift: int, site: str) -> list[torch.Tensor]:
    """``xs`` sent ``shift`` places along the axis's ring, and what the
    process ``shift`` places behind sent: one send and one receive per
    tensor, in one batch."""
    n, i = mesh.shape[axis], mesh.coord(axis)
    xs = [x.contiguous() for x in xs]
    outs = [torch.empty_like(x) for x in xs]
    group = mesh.axis_group(axis)
    to = mesh.global_rank(**{axis: (i + shift) % n})
    frm = mesh.global_rank(**{axis: (i - shift) % n})
    ops = []
    for x, out in zip(xs, outs):
        ops += [dist.P2POp(dist.isend, x, to, group),
                dist.P2POp(dist.irecv, out, frm, group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    add_collectives({site: (1, sum(x.numel() * x.element_size()
                                   for x in xs))})
    return outs


class _Ring(torch.autograd.Function):
    """Every rotation of a ring at once: for tensors ``xs`` of this
    process, ``n`` lists, the ``r``-th holding the tensors of the process
    ``r`` places behind (``r = 0``: ``xs`` themselves), from ``n - 1``
    rotations (the last receives and sends nothing more).  The backward
    runs the rotations the other way, summing each list's cotangent into
    the one travelling back, so it is one node of the autograd graph:
    every process runs it, whichever of the lists its loss used, and its
    sends pair with its neighbours' in one order."""

    @staticmethod
    def forward(ctx, mesh, axis, site, *xs):
        ctx.mesh, ctx.axis, ctx.site, ctx.k = mesh, axis, site, len(xs)
        ctx.shapes = [(x.shape, x.dtype, x.device) for x in xs]
        n = mesh.shape[axis]
        cur, out = list(xs), list(xs)
        for _ in range(n - 1):
            cur = _sendrecv(cur, mesh, axis, 1, site)
            out += cur
        return tuple(out)

    @staticmethod
    def backward(ctx, *gs):
        k, n = ctx.k, ctx.mesh.shape[ctx.axis]

        def grad(j):
            g = gs[j]
            if g is None:
                shape, dtype, device = ctx.shapes[j % k]
                return torch.zeros(shape, dtype=dtype, device=device)
            return g

        acc = [grad((n - 1) * k + j) for j in range(k)]
        for r in range(n - 2, -1, -1):
            back = _sendrecv(acc, ctx.mesh, ctx.axis, -1, f"{ctx.site}_grad")
            acc = [b + grad(r * k + j) for j, b in enumerate(back)]
        return (None, None, None, *acc)


def ring(xs: Sequence[torch.Tensor], mesh: Optional[Mesh],
         axis: str = AxisNames.SEQ, site: str = "ring"
         ) -> list[list[torch.Tensor]]:
    """``[xs_0, ..., xs_{n-1}]``: ``xs_r`` the tensors of the process ``r``
    places behind this one on the axis's ring (``xs_0 = xs``), from
    ``n - 1`` point-to-point rotations (each a send to the next process and
    a receive from the previous, counted under ``"<axis>/<site>"``; the
    backward's under ``"<axis>/<site>_grad"``).  ``[xs]`` on an axis of
    one."""
    xs = list(xs)
    n = 1 if mesh is None else mesh.shape[axis]
    if not _wide(mesh, axis, xs[0]):
        if n > 1 and xs[0].device.type != "meta":
            raise RuntimeError(f"a {axis} axis of {n} with no process group "
                               f"cannot rotate around its processes")
        return [xs] * n
    flat = _Ring.apply(mesh, axis, f"{axis}/{site}", *xs)
    k = len(xs)
    return [list(flat[r * k:(r + 1) * k]) for r in range(n)]


class _Rotate(torch.autograd.Function):
    """One rotation of a ring: ``xs`` sent to the next process on the
    axis, and what the previous one sent returned.  The backward rotates
    the cotangents of the floating tensors the other way (zeros where this
    process's loss reached none), so every process of the axis that runs
    one of the rotation's backwards pairs with its neighbours'."""

    @staticmethod
    def forward(ctx, mesh, axis, site, *xs):
        ctx.mesh, ctx.axis, ctx.site = mesh, axis, site
        ctx.shapes = [(x.shape, x.dtype, x.device) for x in xs]
        outs = _sendrecv(xs, mesh, axis, 1, site)
        ctx.mark_non_differentiable(*(o for o in outs
                                      if not o.is_floating_point()))
        return tuple(outs)

    @staticmethod
    def backward(ctx, *gs):
        floats = [i for i, (_, dtype, _) in enumerate(ctx.shapes)
                  if dtype.is_floating_point]
        send = [gs[i] if gs[i] is not None else torch.zeros(
                    ctx.shapes[i][0], dtype=ctx.shapes[i][1],
                    device=ctx.shapes[i][2]) for i in floats]
        back = _sendrecv(send, ctx.mesh, ctx.axis, -1, f"{ctx.site}_grad")
        grads = [None] * len(ctx.shapes)
        for i, g in zip(floats, back):
            grads[i] = g
        return (None, None, None, *grads)


def rotate(xs: Sequence[torch.Tensor], mesh: Optional[Mesh],
           axis: str = AxisNames.PIPE, site: str = "rotate"
           ) -> list[torch.Tensor]:
    """What the process one place behind this one on the axis's ring holds
    of ``xs``: one point-to-point rotation (a send to the next process and
    a receive from the previous, counted under ``"<axis>/<site>"``; the
    backward's, the other way, under ``"<axis>/<site>_grad"``).  ``xs``
    themselves on an axis of one, or on the meta device."""
    xs = list(xs)
    n = 1 if mesh is None else mesh.shape[axis]
    if not _wide(mesh, axis, xs[0]):
        if n > 1 and xs[0].device.type != "meta":
            raise RuntimeError(f"a {axis} axis of {n} with no process group "
                               f"cannot rotate around its processes")
        return xs
    return list(_Rotate.apply(mesh, axis, f"{axis}/{site}", *xs))


class _Split(torch.autograd.Function):
    """This process's chunk of ``x`` along ``dim`` over an axis (every
    process of the axis holds the same ``x``); the backward all-gathers
    the chunks' cotangents, so each process gets the whole cotangent."""

    @staticmethod
    def forward(ctx, x, mesh, axis, dim, site):
        n, i = mesh.shape[axis], mesh.coord(axis)
        ctx.mesh, ctx.axis, ctx.dim, ctx.site = mesh, axis, dim, site
        return x.chunk(n, dim=dim)[i].clone()

    @staticmethod
    def backward(ctx, g):
        mesh, n = ctx.mesh, ctx.mesh.shape[ctx.axis]
        parts = _gather_list(g, mesh.axis_group(ctx.axis), n, ctx.site)
        return torch.cat(parts, dim=ctx.dim), None, None, None, None


def split(x: torch.Tensor, mesh: Optional[Mesh], dim: int,
          axis: str = AxisNames.EXPERT, site: str = "split_grad"
          ) -> torch.Tensor:
    """This process's chunk of ``x`` (the same on every process of the
    axis) along ``dim``: the ``coord(axis)``-th of ``n`` equal chunks.
    Its backward all-gathers the cotangents (counted under
    ``"<axis>/<site>"``).  ``x`` itself on an axis of one."""
    n = 1 if mesh is None else mesh.shape[axis]
    if n == 1:
        return x
    if x.shape[dim] % n:
        raise ValueError(f"a dim of {x.shape[dim]} does not split over a "
                         f"{axis} axis of {n}")
    if not _wide(mesh, axis, x):
        if x.device.type != "meta":
            raise RuntimeError(f"a {axis} axis of {n} with no process group "
                               f"cannot gather the cotangents of its chunks")
        return x.chunk(n, dim=dim)[mesh.coord(axis)]
    return _Split.apply(x, mesh, axis, dim, f"{axis}/{site}")


def _all_to_all(x: torch.Tensor, group, site: str) -> torch.Tensor:
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    add_collectives({site: (1, x.numel() * x.element_size())})
    return out


class _AllToAll(torch.autograd.Function):
    """``all_to_all_single`` of equal blocks of the leading dim: block
    ``j`` goes to process ``j``, which keeps it as block ``i``; the
    backward is the same exchange of the cotangent."""

    @staticmethod
    def forward(ctx, x, mesh, axis, site):
        ctx.mesh, ctx.axis, ctx.site = mesh, axis, site
        return _all_to_all(x, mesh.axis_group(axis), site)

    @staticmethod
    def backward(ctx, g):
        return (_all_to_all(g, ctx.mesh.axis_group(ctx.axis),
                            f"{ctx.site}_grad"), None, None, None)


def all_to_all(x: torch.Tensor, mesh: Mesh, axis: str = AxisNames.SEQ,
               site: str = "all_to_all") -> torch.Tensor:
    """Exchange the ``n`` equal blocks of ``x``'s leading dim over the
    axis (``all_to_all_single``), counted under ``"<axis>/<site>"``;
    ``x`` itself on an axis of one."""
    if not _wide(mesh, axis, x):
        return x
    return _AllToAll.apply(x, mesh, axis, f"{axis}/{site}")


def square_sum(tree: Mapping[str, torch.Tensor], mesh: Optional[Mesh],
               axes: Mapping[str, str]) -> torch.Tensor:
    """The sum of squares (f32) of the tensors of ``tree`` read as whole
    arrays: ``axes`` names the axis each split tensor is split over; the
    partial sums of the tensors split over an axis with a group are summed
    over it (one all-reduce per such axis, counted under
    ``"<axis>/norm"``) and every other tensor, each process's whole copy,
    counted once.  Where no tensor is split over an axis with a group no
    collective is issued, and the sum is the tensors' in ``tree``'s
    order."""

    def sq(v):
        return torch.sum(torch.square(v.float()))

    wide = {k: a for k, a in axes.items()
            if k in tree and mesh is not None
            and mesh.axis_group(a) is not None}
    if not wide:
        return sum(sq(v) for v in tree.values())
    total = sum(sq(v) for k, v in tree.items() if k not in wide)
    for axis in AxisNames.ALL:
        names = [k for k in tree if wide.get(k) == axis]
        if names:
            part = sum(sq(tree[k]) for k in names)
            group = mesh.axis_group(axis)
            dist.all_reduce(part, op=_sum_op(group, part.dtype), group=group)
            add_collectives({f"{axis}/norm": (1, part.element_size())})
            total = total + part
    return total


# ------------------------------------------------------------ parameters

# A rule maps a regex over the '/'-joined flax path of a parameter to its
# spec: a tuple of axis names (or None) per dimension.
ShardingRule = tuple[str, tuple]


def flax_path(name: str) -> str:
    """The flax path of a parameter of the port's state dict, as
    ``interop`` names it: ``blocks_0.attn.query.kernel`` ->
    ``blocks_0/attn/query/kernel``."""
    return name.replace(".", "/")


def tree_param_shardings(mesh: Mesh, params: Mapping[str, torch.Tensor],
                         rules: Sequence[ShardingRule] = ()
                         ) -> dict[str, object]:
    """Each parameter's placement: the spec of the first rule whose regex
    matches its flax path (:func:`flax_path`), else :data:`REPLICATED`, as
    the JAX package's ``tree_param_shardings``, its ``PartitionSpec``
    written as tuples."""
    out: dict[str, object] = {}
    for name in params:
        path = flax_path(name)
        out[name] = next((tuple(spec) for pattern, spec in rules
                          if re.search(pattern, path)), REPLICATED)
    return out
