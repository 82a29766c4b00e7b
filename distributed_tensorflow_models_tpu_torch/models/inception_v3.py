"""Inception-v3 with auxiliary logits (the slim flagship).

PyTorch counterpart of ``distributed_tensorflow_models_tpu/models/inception_v3.py``,
layer for layer: stem -> 3x Inception-A (35x35) -> Reduction-A -> 4x
Inception-B (17x17) -> [aux head] -> Reduction-B -> 2x Inception-C (8x8) ->
mean pool, dropout, f32 head.  Every conv is conv (no bias) + BN (decay
0.9997, epsilon 1e-3, scale and bias) + ReLU in ``dtype`` (bf16 by
default), with f32 BN statistics.  The loss-side pieces (label smoothing,
the 0.4-weighted aux loss, the weight EMA) live in ``core/train_loop.py``
and ``ops/ema.py``.

Submodules carry the flax names (``ConvBN_3.Conv2D_0.kernel``,
``Mixed_6e.ConvBN_9.BatchNorm_0.mean``, ``AuxHead.aux_logits``,
``head``...), so ``interop`` maps a flax tree onto the state dict name for
name.  flax numbers the unnamed submodules of a block in the order its
``__call__`` creates them; the constructors below create theirs in the
same order.

The aux head is constructed whether or not the model trains (the JAX
model runs it at eval-mode init for its parameters to exist); it runs only
in training, where its logits are returned.  It needs the 17x17 grid of a
299x299 input: on a smaller grid its pool and 5x5 conv are empty, the JAX
model's aux logits are NaN (the mean of an empty map) and so is a loss
that weights them.  The port raises there instead; a smaller input trains
with ``aux_head=False``.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from distributed_tensorflow_models_tpu_torch.models import register
from distributed_tensorflow_models_tpu_torch.ops.conv import (
    Conv2D,
    Dense,
    avg_pool,
    max_pool,
)
from distributed_tensorflow_models_tpu_torch.ops.dropout import dropout
from distributed_tensorflow_models_tpu_torch.ops.normalization import BatchNorm


class ConvBN(nn.Module):
    """slim ``conv2d`` under the inception arg_scope: conv (no bias) + BN +
    ReLU."""

    def __init__(self, in_features: int, filters: int,
                 kernel: tuple[int, int], strides: tuple[int, int] = (1, 1),
                 padding: str = "SAME", dtype: torch.dtype = torch.bfloat16,
                 impl: str = "auto",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.Conv2D_0 = Conv2D(in_features, filters, kernel, strides=strides,
                               padding=padding, use_bias=False, dtype=dtype,
                               impl=impl, generator=generator)
        self.BatchNorm_0 = BatchNorm(filters, momentum=0.9997, epsilon=1e-3)

    def forward(self, x, train: bool = False):
        return torch.relu(self.BatchNorm_0(self.Conv2D_0(x), not train))


class _Block(nn.Module):
    """An Inception block: ``ConvBN_<i>`` submodules added in the JAX
    block's creation order."""

    def __init__(self, dtype: torch.dtype, conv_impl: str,
                 generator: Optional[torch.Generator]):
        super().__init__()
        self.conv_impl = conv_impl
        self._kw = dict(dtype=dtype, impl=conv_impl, generator=generator)
        self._n = 0

    def _c(self, cin: int, filters: int, kernel, **kw) -> str:
        name = f"ConvBN_{self._n}"
        self._n += 1
        self.add_module(name, ConvBN(cin, filters, kernel, **kw, **self._kw))
        return name

    def _run(self, name: str, x, train: bool):
        return getattr(self, name)(x, train)

    def _pool3(self, x):
        return avg_pool(x, (3, 3), strides=(1, 1), padding="SAME",
                        impl=self.conv_impl)


class InceptionA(_Block):
    """35x35 block (Mixed_5b/5c/5d): 1x1 / 5x5 / double-3x3 / pool-proj."""

    def __init__(self, cin: int, pool_filters: int,
                 dtype: torch.dtype = torch.bfloat16, conv_impl: str = "auto",
                 generator: Optional[torch.Generator] = None):
        super().__init__(dtype, conv_impl, generator)
        self.b0 = [self._c(cin, 64, (1, 1))]
        self.b1 = [self._c(cin, 48, (1, 1)), self._c(48, 64, (5, 5))]
        self.b2 = [self._c(cin, 64, (1, 1)), self._c(64, 96, (3, 3)),
                   self._c(96, 96, (3, 3))]
        self.b3 = self._c(cin, pool_filters, (1, 1))
        self.features = 64 + 64 + 96 + pool_filters

    def forward(self, x, train: bool = False):
        outs = []
        for branch in (self.b0, self.b1, self.b2):
            y = x
            for name in branch:
                y = self._run(name, y, train)
            outs.append(y)
        outs.append(self._run(self.b3, self._pool3(x), train))
        return torch.cat(outs, dim=-1)


class ReductionA(_Block):
    """Mixed_6a: stride-2 3x3 / stride-2 double-3x3 / max pool."""

    def __init__(self, cin: int, dtype: torch.dtype = torch.bfloat16,
                 conv_impl: str = "auto",
                 generator: Optional[torch.Generator] = None):
        super().__init__(dtype, conv_impl, generator)
        self.b0 = [self._c(cin, 384, (3, 3), strides=(2, 2), padding="VALID")]
        self.b1 = [self._c(cin, 64, (1, 1)), self._c(64, 96, (3, 3)),
                   self._c(96, 96, (3, 3), strides=(2, 2), padding="VALID")]
        self.features = 384 + 96 + cin

    def forward(self, x, train: bool = False):
        outs = []
        for branch in (self.b0, self.b1):
            y = x
            for name in branch:
                y = self._run(name, y, train)
            outs.append(y)
        pooled = max_pool(x, (3, 3), strides=(2, 2), padding="VALID",
                          impl=self.conv_impl)
        return torch.cat(outs + [pooled.to(outs[0].dtype)], dim=-1)


class InceptionB(_Block):
    """17x17 block (Mixed_6b..6e): factorized 7x7 branches; ``width`` is the
    inner channel count (128 / 160 / 160 / 192 across the four blocks)."""

    def __init__(self, cin: int, width: int,
                 dtype: torch.dtype = torch.bfloat16, conv_impl: str = "auto",
                 generator: Optional[torch.Generator] = None):
        super().__init__(dtype, conv_impl, generator)
        w = width
        self.b0 = [self._c(cin, 192, (1, 1))]
        self.b1 = [self._c(cin, w, (1, 1)), self._c(w, w, (1, 7)),
                   self._c(w, 192, (7, 1))]
        self.b2 = [self._c(cin, w, (1, 1)), self._c(w, w, (7, 1)),
                   self._c(w, w, (1, 7)), self._c(w, w, (7, 1)),
                   self._c(w, 192, (1, 7))]
        self.b3 = self._c(cin, 192, (1, 1))
        self.features = 4 * 192

    forward = InceptionA.forward


class ReductionB(_Block):
    """Mixed_7a."""

    def __init__(self, cin: int, dtype: torch.dtype = torch.bfloat16,
                 conv_impl: str = "auto",
                 generator: Optional[torch.Generator] = None):
        super().__init__(dtype, conv_impl, generator)
        self.b0 = [self._c(cin, 192, (1, 1)),
                   self._c(192, 320, (3, 3), strides=(2, 2), padding="VALID")]
        self.b1 = [self._c(cin, 192, (1, 1)), self._c(192, 192, (1, 7)),
                   self._c(192, 192, (7, 1)),
                   self._c(192, 192, (3, 3), strides=(2, 2), padding="VALID")]
        self.features = 320 + 192 + cin

    forward = ReductionA.forward


class InceptionC(_Block):
    """8x8 block (Mixed_7b/7c): expanded-filter-bank branches."""

    def __init__(self, cin: int, dtype: torch.dtype = torch.bfloat16,
                 conv_impl: str = "auto",
                 generator: Optional[torch.Generator] = None):
        super().__init__(dtype, conv_impl, generator)
        self.b0 = self._c(cin, 320, (1, 1))
        self.b1 = self._c(cin, 384, (1, 1))
        self.b1_split = [self._c(384, 384, (1, 3)), self._c(384, 384, (3, 1))]
        self.b2 = [self._c(cin, 448, (1, 1)), self._c(448, 384, (3, 3))]
        self.b2_split = [self._c(384, 384, (1, 3)), self._c(384, 384, (3, 1))]
        self.b3 = self._c(cin, 192, (1, 1))
        self.features = 320 + 2 * 768 + 192

    def forward(self, x, train: bool = False):
        b0 = self._run(self.b0, x, train)
        b1 = self._run(self.b1, x, train)
        b1 = torch.cat([self._run(n, b1, train) for n in self.b1_split], -1)
        b2 = x
        for name in self.b2:
            b2 = self._run(name, b2, train)
        b2 = torch.cat([self._run(n, b2, train) for n in self.b2_split], -1)
        b3 = self._run(self.b3, self._pool3(x), train)
        return torch.cat([b0, b1, b2, b3], dim=-1)


class AuxHead(nn.Module):
    """Auxiliary classifier off Mixed_6e (slim ``AuxLogits``): 5x5/3 avg
    pool -> 1x1 (128) -> 5x5 (768, VALID) -> mean -> ``aux_logits``."""

    def __init__(self, cin: int, num_classes: int,
                 dtype: torch.dtype = torch.bfloat16, conv_impl: str = "auto",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.conv_impl = conv_impl
        kw = dict(dtype=dtype, impl=conv_impl, generator=generator)
        self.ConvBN_0 = ConvBN(cin, 128, (1, 1), **kw)
        self.ConvBN_1 = ConvBN(128, 768, (5, 5), padding="VALID", **kw)
        self.aux_logits = Dense(768, num_classes, dtype=torch.float32,
                                generator=generator)
        # flax's truncated_normal(0.001): 0.001 times a unit normal cut at
        # +-2 (no variance correction).
        with torch.no_grad():
            nn.init.trunc_normal_(self.aux_logits.kernel, 0.0, 0.001, -0.002,
                                  0.002, generator=generator)

    def forward(self, x, train: bool = False):
        if min(x.shape[1], x.shape[2]) < 17:
            raise ValueError(
                f"inception_v3: the aux head needs a grid of at least 17x17 "
                f"(a 299x299 input), got {x.shape[1]}x{x.shape[2]}; build "
                f"the model with aux_head=False for smaller inputs")
        x = avg_pool(x, (5, 5), strides=(3, 3), padding="VALID",
                     impl=self.conv_impl)
        x = self.ConvBN_0(x, train)
        x = self.ConvBN_1(x, train)
        x = torch.mean(x, dim=(1, 2))
        return self.aux_logits(x.to(torch.float32))


class InceptionV3(nn.Module):
    """Input ``[B, 299, 299, 3]`` NHWC.  Returns ``logits`` (eval) or
    ``(logits, aux_logits)`` (training, with ``aux_head``)."""

    def __init__(self, num_classes: int = 1000, dropout_rate: float = 0.2,
                 aux_head: bool = True, dtype: torch.dtype = torch.bfloat16,
                 conv_impl: str = "auto", remat: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if remat:
            raise NotImplementedError(
                "inception_v3: remat is not ported yet")
        self.dtype = dtype
        self.conv_impl = conv_impl
        self.dropout_rate = dropout_rate
        kw = dict(dtype=dtype, impl=conv_impl, generator=generator)
        # Stem: 299x299x3 -> 35x35x192.
        self.ConvBN_0 = ConvBN(3, 32, (3, 3), strides=(2, 2), padding="VALID",
                               **kw)
        self.ConvBN_1 = ConvBN(32, 32, (3, 3), padding="VALID", **kw)
        self.ConvBN_2 = ConvBN(32, 64, (3, 3), **kw)
        self.ConvBN_3 = ConvBN(64, 80, (1, 1), padding="VALID", **kw)
        self.ConvBN_4 = ConvBN(80, 192, (3, 3), padding="VALID", **kw)
        bk = dict(dtype=dtype, conv_impl=conv_impl, generator=generator)
        self.Mixed_5b = InceptionA(192, 32, **bk)
        self.Mixed_5c = InceptionA(self.Mixed_5b.features, 64, **bk)
        self.Mixed_5d = InceptionA(self.Mixed_5c.features, 64, **bk)
        self.Mixed_6a = ReductionA(self.Mixed_5d.features, **bk)
        self.Mixed_6b = InceptionB(self.Mixed_6a.features, 128, **bk)
        self.Mixed_6c = InceptionB(self.Mixed_6b.features, 160, **bk)
        self.Mixed_6d = InceptionB(self.Mixed_6c.features, 160, **bk)
        self.Mixed_6e = InceptionB(self.Mixed_6d.features, 192, **bk)
        self.AuxHead = (AuxHead(self.Mixed_6e.features, num_classes, **bk)
                        if aux_head else None)
        self.Mixed_7a = ReductionB(self.Mixed_6e.features, **bk)
        self.Mixed_7b = InceptionC(self.Mixed_7a.features, **bk)
        self.Mixed_7c = InceptionC(self.Mixed_7b.features, **bk)
        self.head = Dense(self.Mixed_7c.features, num_classes,
                          dtype=torch.float32, generator=generator)

    def _pool(self, x):
        return max_pool(x, (3, 3), strides=(2, 2), padding="VALID",
                        impl=self.conv_impl)

    def forward(self, x, train: bool = False, rngs=None):
        x = x.to(self.dtype)
        x = self.ConvBN_0(x, train)
        x = self.ConvBN_1(x, train)
        x = self.ConvBN_2(x, train)
        x = self._pool(x)
        x = self.ConvBN_3(x, train)
        x = self.ConvBN_4(x, train)
        x = self._pool(x)
        for name in ("Mixed_5b", "Mixed_5c", "Mixed_5d", "Mixed_6a",
                     "Mixed_6b", "Mixed_6c", "Mixed_6d", "Mixed_6e"):
            x = getattr(self, name)(x, train)
        aux = (self.AuxHead(x, train)
               if self.AuxHead is not None and train else None)
        for name in ("Mixed_7a", "Mixed_7b", "Mixed_7c"):
            x = getattr(self, name)(x, train)
        x = torch.mean(x, dim=(1, 2))
        x = dropout(x, self.dropout_rate, train, rngs)
        logits = self.head(x.to(torch.float32))
        if aux is not None:
            return logits, aux
        return logits


@register("inception_v3")
def build_inception_v3(**kwargs) -> InceptionV3:
    return InceptionV3(**kwargs)
