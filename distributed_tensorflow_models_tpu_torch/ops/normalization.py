"""Batch normalization with activation-dtype I/O and f32 statistics.

PyTorch counterpart of ``distributed_tensorflow_models_tpu/ops/normalization.py``
— deliberately not ``nn.BatchNorm2d``, which stores the unbiased variance
and would drift from the reference:

- statistics are taken in f32 as ``E[x^2] - E[x]^2`` clamped at 0 (the
  biased variance), over every axis but the last (NHWC);
- the running statistics update as ``m*old + (1-m)*new``;
- the normalization is one multiply-add in the activation dtype:
  ``y = x*a + b`` with ``a = scale*rsqrt(var+eps)``, ``b = bias - mean*a``.

Parameters ``scale``/``bias`` and buffers ``mean``/``var`` carry the flax
names.  In training mode the running statistics are updated in place on
the buffers (the JAX module returns them as a new collection).

Under remat (``ops/remat.py``) a block's recompute in the backward leaves
the running statistics alone: they take one update a step, as from one
forward (its moments' all-reduce does run again, as a rematerialised
``psum`` does in the JAX package, and counts again).

Under a data-parallel mesh (``core/mesh.py::data_parallel``) the moments
are global across its processes, as XLA makes them for a batch-sharded
array in the JAX package: each process sums its rows, one all-reduce
adds the processes' ``[sum x, sum x^2]``, and the sums are divided by
the global row count; the backward adds the processes' cotangents of the
moments the same way.  Without a group the same sums and division run
with no collective, so a group of one gives the same bits as none.  The
running statistics then update identically on every process.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch import nn

from distributed_tensorflow_models_tpu_torch.core import mesh as meshlib
from distributed_tensorflow_models_tpu_torch.core import sharding as shardlib
from distributed_tensorflow_models_tpu_torch.ops import remat as rematlib


class _BatchMoments(torch.autograd.Function):
    """``(E[x], E[x^2])`` over all but the last axis, in f32, over the rows
    of every process of ``mesh`` (this process's alone when it is None).

    The f32 copy of ``x`` is transient: backward recomputes from the saved
    ``x`` instead of keeping an f32 activation alive per layer."""

    @staticmethod
    def forward(ctx, x, mesh):
        dims = tuple(range(x.dim() - 1))
        c = x.shape[-1]
        n = x.numel() // c * (1 if mesh is None else mesh.data_size)
        xf = x.float()
        sums = torch.cat([xf.sum(dims), (xf * xf).sum(dims)])
        shardlib.all_reduce_sum_(sums, mesh, "bn_moments")
        ctx.save_for_backward(x)
        ctx.mesh, ctx.n = mesh, n
        moments = sums / n
        return moments[:c], moments[c:]

    @staticmethod
    def backward(ctx, g_mean, g_sq):
        (x,) = ctx.saved_tensors
        c, n = x.shape[-1], ctx.n
        g = torch.cat([g_mean, g_sq])
        shardlib.all_reduce_sum_(g, ctx.mesh, "bn_moments_grad")
        gx = g[:c] / n + 2.0 * x.float() * (g[c:] / n)
        return gx.to(x.dtype), None


class BatchNorm(nn.Module):
    def __init__(self, features: int, momentum: float = 0.9,
                 epsilon: float = 1e-5,
                 scale_init: Callable[[torch.Tensor], torch.Tensor] = nn.init.ones_):
        super().__init__()
        self.momentum = momentum
        self.epsilon = epsilon
        self.scale = nn.Parameter(torch.empty(features))
        with torch.no_grad():
            scale_init(self.scale)
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def forward(self, x: torch.Tensor, use_running_average: bool) -> torch.Tensor:
        if use_running_average:
            mean, var = self.mean, self.var
        else:
            mean, mean_sq = _BatchMoments.apply(x, meshlib.current_mesh())
            var = torch.clamp(mean_sq - mean * mean, min=0.0)
            if not rematlib.recomputing():
                m = self.momentum
                with torch.no_grad():
                    self.mean.copy_(m * self.mean + (1.0 - m) * mean)
                    self.var.copy_(m * self.var + (1.0 - m) * var)
        inv = torch.rsqrt(var + self.epsilon) * self.scale
        shift = self.bias - mean * inv
        return x * inv.to(x.dtype) + shift.to(x.dtype)
