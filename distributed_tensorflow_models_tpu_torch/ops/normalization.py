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
"""

from __future__ import annotations

from typing import Callable

import torch
from torch import nn


class _BatchMoments(torch.autograd.Function):
    """``(E[x], E[x^2])`` over all but the last axis, in f32.

    The f32 copy of ``x`` is transient: backward recomputes from the saved
    ``x`` instead of keeping an f32 activation alive per layer."""

    @staticmethod
    def forward(ctx, x):
        dims = tuple(range(x.dim() - 1))
        xf = x.float()
        ctx.save_for_backward(x)
        return xf.mean(dims), (xf * xf).mean(dims)

    @staticmethod
    def backward(ctx, g_mean, g_sq):
        (x,) = ctx.saved_tensors
        n = x.numel() // x.shape[-1]
        gx = g_mean / n + 2.0 * x.float() * (g_sq / n)
        return gx.to(x.dtype)


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
            mean, mean_sq = _BatchMoments.apply(x)
            var = torch.clamp(mean_sq - mean * mean, min=0.0)
            m = self.momentum
            with torch.no_grad():
                self.mean.copy_(m * self.mean + (1.0 - m) * mean)
                self.var.copy_(m * self.var + (1.0 - m) * var)
        inv = torch.rsqrt(var + self.epsilon) * self.scale
        shift = self.bias - mean * inv
        return x * inv.to(x.dtype) + shift.to(x.dtype)
