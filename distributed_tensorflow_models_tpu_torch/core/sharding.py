"""Data-parallel placement and the collectives of the step.

PyTorch counterpart of ``distributed_tensorflow_models_tpu/core/sharding.py``
for data parallelism.  The JAX package lays arrays out declaratively:
parameters replicated, the batch sharded over the ``data`` axis, and XLA
compiles the gradient all-reduce, the only per-step communication.  Here
each process holds a full replica of the parameters and its row block of
every batch (:func:`batch_rows`), and the step reduces explicitly over the
mesh's process group:

- :func:`all_reduce_mean_` — the gradients, flattened into one bucket per
  dtype (f32, or f64 for f64), one all-reduce each (XLA likewise combines
  the reference's per-parameter reductions), then divided by the world
  size;
- :func:`all_reduce_sum_` — any f32 tensor summed in place (BatchNorm's
  moments and their cotangents, the step's metric vector);
- :func:`all_gather_rows` — every process's rows concatenated in rank
  order, differentiably (the MoE FFN's tokens, ``parallel/moe.py``).

Without a process group nothing is issued: a world of one with no group
runs the single-device step unchanged.  With one, the collectives run
whatever its size.  On NCCL a sum is issued as a sum pre-multiplied by 1
(``_make_nccl_premul_sum(1.0)``): the same sum, bit for bit, but NCCL
launches a kernel for it at one rank too, where it makes a plain in-place
sum a no-op that never reaches the device.

Every collective counts itself under its site (``collective_counts``),
like the kernels' launch counters: a captured step takes off what its
capture counted and adds it back per replay (:func:`add_collectives`).
"""

from __future__ import annotations

import collections
from typing import Iterable, Mapping, Optional, Sequence

import torch
import torch.distributed as dist

from distributed_tensorflow_models_tpu_torch.core.mesh import Mesh

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


def _sum_op(group: dist.ProcessGroup):
    if dist.get_backend(group) == "nccl":
        return dist._make_nccl_premul_sum(1.0)
    return dist.ReduceOp.SUM


def _group(mesh: Optional[Mesh]) -> Optional[dist.ProcessGroup]:
    """The group to reduce over; None where nothing is to be reduced.  A
    data axis wider than one without a group cannot be reduced: raise."""
    if mesh is None or mesh.group is None:
        if mesh is not None and mesh.world_size > 1:
            raise RuntimeError(
                f"a data axis of {mesh.world_size} with no process group "
                f"cannot reduce across its processes")
        return None
    return mesh.group


def all_reduce_sum_(t: torch.Tensor, mesh: Optional[Mesh],
                    site: str) -> torch.Tensor:
    """Sum ``t`` in place over the mesh's processes (nothing without a
    group) and count it under ``site``; returns ``t``."""
    group = _group(mesh)
    if group is not None:
        dist.all_reduce(t, op=_sum_op(group), group=group)
        add_collectives({site: (1, t.numel() * t.element_size())})
    return t


class _AllGatherRows(torch.autograd.Function):
    """Forward: the processes' ``[n, ...]`` tensors concatenated in rank
    order.  Backward: the cotangent of the whole summed over the
    processes (each computed its own loss from the gathered rows), and
    this process's rows of the sum."""

    @staticmethod
    def forward(ctx, x, mesh, site):
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(mesh.world_size)]
        dist.all_gather(parts, x, group=mesh.group)
        add_collectives({site: (1, mesh.world_size * x.numel()
                                * x.element_size())})
        ctx.mesh, ctx.site = mesh, site
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        all_reduce_sum_(g, ctx.mesh, f"{ctx.site}_grad")
        return g[batch_rows(ctx.mesh, g.shape[0])], None, None


def all_gather_rows(x: torch.Tensor, mesh: Mesh, site: str) -> torch.Tensor:
    """Every process's ``x`` (same shape) concatenated along the leading
    axis in rank order, over the mesh's group, counted under ``site``
    (and its backward's sum under ``site + "_grad"``); ``x`` itself
    without a group."""
    if _group(mesh) is None:
        return x
    return _AllGatherRows.apply(x, mesh, site)


def all_reduce_mean_(tensors: Iterable[torch.Tensor], mesh: Optional[Mesh],
                     site: str = "grads") -> None:
    """Replace each tensor by its mean over the mesh's processes, in
    place: the tensors of each dtype flattened into one bucket (f32, or
    f64 for f64), one sum over the group, divided by the world size and
    copied back.  Nothing is issued without a group."""
    if _group(mesh) is None:
        return
    by_dtype: dict[torch.dtype, list[torch.Tensor]] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for dtype, ts in by_dtype.items():
        acc = torch.promote_types(dtype, torch.float32)
        bucket = torch.cat([t.reshape(-1).to(acc) for t in ts])
        all_reduce_sum_(bucket, mesh, site)
        bucket.div_(mesh.world_size)
        for t, part in zip(ts, bucket.split([t.numel() for t in ts])):
            t.copy_(part.view_as(t))


def all_reduce_metrics(metrics: Mapping[str, torch.Tensor],
                       mesh: Optional[Mesh]) -> dict[str, torch.Tensor]:
    """The step's scalar metrics averaged over the mesh's processes in one
    small collective (as f32); unchanged without a group."""
    if _group(mesh) is None:
        return dict(metrics)
    names = list(metrics)
    vec = torch.stack([metrics[n].float() for n in names])
    all_reduce_sum_(vec, mesh, "metrics")
    vec.div_(mesh.world_size)
    return {n: vec[i] for i, n in enumerate(names)}


def tree_param_shardings(mesh: Mesh, params: Mapping[str, torch.Tensor],
                         rules: Sequence = ()) -> dict[str, str]:
    """Each parameter's placement: replicated on every process, the
    data-parallel layout.  Sharding rules (tensor parallelism over the
    ``model`` axis) are not ported and raise."""
    if rules:
        raise NotImplementedError(
            "parameter sharding rules are not ported: the port is data "
            "parallel only (tensor parallelism is among the parallel "
            "layers, ROADMAP §1 item 1)")
    return dict.fromkeys(params, REPLICATED)
