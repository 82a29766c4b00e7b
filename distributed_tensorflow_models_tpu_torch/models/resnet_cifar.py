"""CIFAR-10 ResNet-32: a v1 residual net with a 3x3 stem and three stages
of basic blocks at widths 16/32/64 (``depth = 6n + 2``, n = 5).

PyTorch counterpart of
``distributed_tensorflow_models_tpu/models/resnet_cifar.py``.  The
downsampling stride sits on the first conv of stages 1 and 2, whose
shortcut is a strided 1x1 ``proj`` plus ``proj_bn``.  BN keeps momentum
0.9, epsilon 1e-5 and f32 statistics; activations are NHWC in ``dtype``
(f32 by default) and the head is f32.  A block's own convs and norms carry
flax's automatic names (``Conv2D_0``, ``BatchNorm_0``, ``Conv2D_1``,
``BatchNorm_1``), the shortcut its given ones, so a flax tree maps onto
the state dict name for name.  Under ``impl="mxu"`` the nine 3x3 convs of
stage 2 with Cin 64 take K1 (in f32 at the default dtype); the rest route
to ``conv2d_patches`` by K1's 128-lane rule.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from distributed_tensorflow_models_tpu_torch.models import register
from distributed_tensorflow_models_tpu_torch.ops.conv import Conv2D, Dense
from distributed_tensorflow_models_tpu_torch.ops.normalization import BatchNorm


def _norm(features: int) -> BatchNorm:
    return BatchNorm(features, momentum=0.9, epsilon=1e-5)


class BasicBlock(nn.Module):
    """Two 3x3 convs and an identity or projection shortcut (ResNet v1)."""

    def __init__(self, in_features: int, filters: int, strides: int = 1,
                 dtype: torch.dtype = torch.float32, conv_impl: str = "auto",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        conv = dict(padding="SAME", use_bias=False, dtype=dtype,
                    impl=conv_impl, generator=generator)
        self.Conv2D_0 = Conv2D(in_features, filters, (3, 3),
                               strides=(strides, strides), **conv)
        self.BatchNorm_0 = _norm(filters)
        self.Conv2D_1 = Conv2D(filters, filters, (3, 3), **conv)
        self.BatchNorm_1 = _norm(filters)
        # The JAX block projects when the residual's shape differs from
        # the output's: a stride or a channel change.
        if strides != 1 or in_features != filters:
            self.proj = Conv2D(in_features, filters, (1, 1),
                               strides=(strides, strides), use_bias=False,
                               dtype=dtype, impl=conv_impl,
                               generator=generator)
            self.proj_bn = _norm(filters)
        else:
            self.proj = None

    def forward(self, x, train: bool = False):
        eval_mode = not train
        y = torch.relu(self.BatchNorm_0(self.Conv2D_0(x), eval_mode))
        y = self.BatchNorm_1(self.Conv2D_1(y), eval_mode)
        residual = x
        if self.proj is not None:
            residual = self.proj_bn(self.proj(x), eval_mode)
        return torch.relu(y + residual.to(y.dtype))


class CifarResNet(nn.Module):
    """``depth = 6n + 2`` ResNet for 32x32 inputs; n = 5 is ResNet-32."""

    def __init__(self, blocks_per_stage: int = 5,
                 widths: Sequence[int] = (16, 32, 64), num_classes: int = 10,
                 dtype: torch.dtype = torch.float32, conv_impl: str = "auto",
                 in_channels: int = 3,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dtype = dtype
        self.conv_init = Conv2D(in_channels, widths[0], (3, 3),
                                padding="SAME", use_bias=False, dtype=dtype,
                                impl=conv_impl, generator=generator)
        self.bn_init = _norm(widths[0])
        features = widths[0]
        self.block_names = []
        for stage, width in enumerate(widths):
            for block in range(blocks_per_stage):
                strides = 2 if stage > 0 and block == 0 else 1
                name = f"stage{stage}_block{block}"
                self.add_module(name, BasicBlock(features, width, strides,
                                                 dtype, conv_impl, generator))
                self.block_names.append(name)
                features = width
        self.head = Dense(features, num_classes, dtype=torch.float32,
                          generator=generator)

    def forward(self, x, train: bool = False, rngs=None):
        """``rngs`` is taken for the classification step's uniform call
        and unused: the model has no dropout."""
        x = x.to(self.dtype)
        x = torch.relu(self.bn_init(self.conv_init(x), not train))
        for name in self.block_names:
            x = getattr(self, name)(x, train)
        x = torch.mean(x, dim=(1, 2))  # global average pool
        return self.head(x)


@register("resnet32_cifar")
def build_resnet32(**kwargs) -> CifarResNet:
    return CifarResNet(**kwargs)
