"""Pipeline parallelism over the ``pipe`` mesh axis (GPipe).

PyTorch counterpart of ``distributed_tensorflow_models_tpu/parallel/pipeline.py``.
A *uniform* stage function ``stage_fn(stage_params, x) -> y`` runs with
per-stage parameters stacked on a leading axis of ``n`` stages; each
process of the pipe axis holds one stage's slice (:func:`pipeline_spec`,
cut by ``parallel/tensor.py::shard_model``), and the batch streams through
the stages as microbatches.  The JAX package runs the schedule as one
``lax.scan`` whose ticks rotate the activations with ``lax.ppermute``;
here the ticks are a Python loop on every process of the pipe axis, each
rotation a counted point-to-point exchange (``core/sharding.py::rotate``)
whose backward rotates the cotangents the other way, so autograd through
:func:`pipeline_apply` is GPipe's backward.

The gradients: the microbatches enter through Megatron's *f* on ``pipe``
(the identity, the cotangents summed over the axis in the backward), so
every process gets the true input gradient although only the first stage
reads the input; the output leaves through *g* (a sum over the axis, the
identity backward), so every process holds the last stage's output and
computes the same loss on it.  Every process takes part in every
rotation, in the same order, whatever it computed: a process skips only
its stage's arithmetic on the bubble ticks, whose outputs are never
collected, and passes its input on instead.

:func:`sequential_apply` is the oracle (the stages back to back, one
microbatch at a time) and :func:`emulate` the schedule's arithmetic for
``n`` virtual stages in one process, lists rotated in place of the
exchanges, which is how the card holds it with one GPU.
"""

from __future__ import annotations

from typing import Callable, Mapping, Optional, Sequence, Union

import torch

from distributed_tensorflow_models_tpu_torch.core import sharding as shardlib
from distributed_tensorflow_models_tpu_torch.core.mesh import AxisNames, Mesh

Tree = Union[torch.Tensor, Mapping[str, torch.Tensor]]


def split_microbatches(batch: torch.Tensor,
                       num_microbatches: int) -> torch.Tensor:
    """``[B, ...]`` -> ``[M, B/M, ...]``; B must divide evenly."""
    b = batch.shape[0]
    if b % num_microbatches:
        raise ValueError(
            f"batch {b} not divisible by num_microbatches {num_microbatches}"
        )
    return batch.reshape((num_microbatches, b // num_microbatches)
                         + tuple(batch.shape[1:]))


def merge_microbatches(x: torch.Tensor) -> torch.Tensor:
    return x.reshape((x.shape[0] * x.shape[1],) + tuple(x.shape[2:]))


def stack_stage_params(stage_params: Sequence[Mapping[str, torch.Tensor]]
                       ) -> dict[str, torch.Tensor]:
    """Per-stage parameter dicts -> one dict with a leading stage axis."""
    return {k: torch.stack([p[k] for p in stage_params])
            for k in stage_params[0]}


def pipeline_spec(params_stacked: Mapping[str, torch.Tensor],
                  axis: str = AxisNames.PIPE) -> dict[str, tuple]:
    """Each stacked parameter's spec: its leading (stage) dim over
    ``axis``, as the JAX package's ``P(axis)``."""
    return {k: (axis,) for k in params_stacked}


def _flatten(tree: Tree) -> tuple[Optional[list[str]], list[torch.Tensor]]:
    if isinstance(tree, torch.Tensor):
        return None, [tree]
    keys = list(tree)
    return keys, [tree[k] for k in keys]


def _rebuild(keys: Optional[list[str]], leaves: Sequence[torch.Tensor]
             ) -> Tree:
    return leaves[0] if keys is None else dict(zip(keys, leaves))


def pipeline_apply(stage_fn: Callable[[dict, Tree], Tree],
                   stage_params: Mapping[str, torch.Tensor],
                   microbatches: Tree, *, mesh: Mesh,
                   axis: str = AxisNames.PIPE) -> Tree:
    """Run ``microbatches`` (a tensor or a dict of tensors, each
    ``[M, mb, ...]``) through the stages of the ``axis`` ring; this
    process applies its stage, ``stage_params`` (its slice of the stacked
    parameters, without the stage axis).  ``stage_fn`` returns the same
    structure it takes.

    ``M + n - 1`` ticks.  At tick ``t`` the first stage takes microbatch
    ``min(t, M - 1)``, every stage applies its parameters to what it holds
    (stage ``r`` skips the arithmetic outside ``r <= t < r + M``, where
    what it holds is no microbatch's, and passes it on unchanged), and the
    activations rotate one stage on (no rotation after the last tick: its
    result is not read).  The last stage's outputs from tick ``n - 1`` on
    are the result, summed over the axis from zeros elsewhere (*g*), so
    every process returns them: ``[M, mb, ...]``.  Integer leaves (the
    row ids) ride along with their microbatch, which ``stage_fn`` passes
    on unchanged; every process holds them already, so they are returned
    as given, with no sum."""
    n, r = mesh.shape[axis], mesh.coord(axis)
    keys, leaves = _flatten(microbatches)
    M = leaves[0].shape[0]
    leaves = [shardlib.copy_in(v, mesh, axis, site="input_grad")
              if v.is_floating_point() else v for v in leaves]
    device = leaves[0].device
    # Fills, not copies from the host: a captured step may run this.
    first = torch.full((), r == 0, dtype=torch.bool, device=device)
    last = torch.full((), r == n - 1, dtype=torch.bool, device=device)
    state = [torch.zeros_like(v[0]) for v in leaves]
    ticks = M + n - 1
    outs = []
    for t in range(ticks):
        # The first stage's input is the microbatch; the others' what was
        # rotated to them.  Both stay in the graph on every process (a
        # zero cotangent where unused), so every process runs the backward
        # of every rotation and of the input's *f*.
        m = min(t, M - 1)
        x = [torch.where(first, v[m], s) for v, s in zip(leaves, state)]
        if r <= t < r + M:
            _, y = _flatten(stage_fn(stage_params, _rebuild(keys, x)))
        else:
            y = x
        if t >= n - 1:
            outs.append(y)
        if t < ticks - 1:
            state = shardlib.rotate(y, mesh, axis)
    result = []
    for i, v in enumerate(leaves):
        if not v.is_floating_point():
            result.append(v)
            continue
        stacked = torch.stack([o[i] for o in outs])
        stacked = torch.where(last, stacked, torch.zeros_like(stacked))
        result.append(shardlib.reduce_sum(stacked, mesh, axis, site="output"))
    return _rebuild(keys, result)


def _stage(params_stacked: Mapping[str, torch.Tensor], i: int) -> dict:
    return {k: v[i] for k, v in params_stacked.items()}


def sequential_apply(stage_fn: Callable[[dict, Tree], Tree],
                     params_stacked: Mapping[str, torch.Tensor],
                     microbatches: Tree) -> Tree:
    """The oracle: each microbatch through the stages back to back, with
    no pipelining (the same contract as :func:`pipeline_apply`).
    ``params_stacked``'s values are indexed by stage (stacked tensors, or
    lists)."""
    keys, leaves = _flatten(microbatches)
    n_stages = len(next(iter(params_stacked.values())))
    outs = []
    for m in range(leaves[0].shape[0]):
        x = _rebuild(keys, [v[m] for v in leaves])
        for i in range(n_stages):
            x = stage_fn(_stage(params_stacked, i), x)
        outs.append(_flatten(x)[1])
    return _rebuild(keys, [torch.stack([o[i] for o in outs])
                           for i in range(len(leaves))])


def emulate(stage_fn: Callable[[dict, Tree], Tree],
            params_stacked: Mapping[str, torch.Tensor], microbatches: Tree,
            n: int) -> Tree:
    """:func:`pipeline_apply`'s tick schedule for ``n`` virtual stages in
    one process: stage ``r`` applies ``params_stacked``'s ``r``-th slice
    on the same ticks, the rotations a shift of the list of what the
    stages hold.  Differentiable; no collective is issued."""
    keys, leaves = _flatten(microbatches)
    M = leaves[0].shape[0]
    params = [_stage(params_stacked, r) for r in range(n)]
    state = [[torch.zeros_like(v[0]) for v in leaves] for _ in range(n)]
    outs = []
    for t in range(M + n - 1):
        ys = []
        for r in range(n):
            x = [v[min(t, M - 1)] for v in leaves] if r == 0 else state[r]
            if r <= t < r + M:
                x = _flatten(stage_fn(params[r], _rebuild(keys, x)))[1]
            ys.append(x)
        if t >= n - 1:
            outs.append(ys[n - 1])
        state = [ys[(r - 1) % n] for r in range(n)]
    return _rebuild(keys, [torch.stack([o[i] for o in outs])
                           for i in range(len(leaves))])
