"""ImageNet ResNet-v1 (50/101/152).

PyTorch counterpart of ``distributed_tensorflow_models_tpu/models/resnet.py``:
7x7/2 stem conv (64) and 3x3/2 max pool, four stages of bottleneck units
([3,4,6,3] for ResNet-50) with the downsampling stride on the 3x3 conv of
each stage's first unit, global average pool, linear head.  Activations
are NHWC in ``dtype`` (bf16 by default) with f32 BN statistics and an f32
head.  Submodules carry the flax module names (``conv_init``,
``stage0_block0.Conv2D_1``, ``proj_bn``, ``head``...) so that a flax
variable tree maps onto the state dict name for name (``interop.py``).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from distributed_tensorflow_models_tpu_torch.models import register
from distributed_tensorflow_models_tpu_torch.ops.conv import Conv2D, Dense, max_pool
from distributed_tensorflow_models_tpu_torch.ops.normalization import BatchNorm


def _norm(features: int, **kw) -> BatchNorm:
    return BatchNorm(features, momentum=0.9, epsilon=1e-5, **kw)


class BottleneckBlock(nn.Module):
    """1x1 reduce -> 3x3 -> 1x1 expand (x4), projection shortcut on a shape
    change; BN after each conv, ReLU after the residual add."""

    def __init__(self, in_features: int, filters: int, strides: int = 1,
                 dtype: torch.dtype = torch.bfloat16, conv_impl: str = "auto",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        out_filters = 4 * filters
        conv = dict(use_bias=False, dtype=dtype, impl=conv_impl,
                    generator=generator)
        self.Conv2D_0 = Conv2D(in_features, filters, (1, 1), **conv)
        self.BatchNorm_0 = _norm(filters)
        self.Conv2D_1 = Conv2D(filters, filters, (3, 3),
                               strides=(strides, strides), padding="SAME",
                               **conv)
        self.BatchNorm_1 = _norm(filters)
        self.Conv2D_2 = Conv2D(filters, out_filters, (1, 1), **conv)
        # Zero-init the last BN scale so each block starts as identity.
        self.BatchNorm_2 = _norm(out_filters, scale_init=nn.init.zeros_)
        if in_features != out_filters or strides != 1:
            self.proj = Conv2D(in_features, out_filters, (1, 1),
                               strides=(strides, strides), **conv)
            self.proj_bn = _norm(out_filters)
        else:
            self.proj = None

    def forward(self, x, train: bool = False):
        eval_mode = not train
        residual = x
        y = torch.relu(self.BatchNorm_0(self.Conv2D_0(x), eval_mode))
        y = torch.relu(self.BatchNorm_1(self.Conv2D_1(y), eval_mode))
        y = self.BatchNorm_2(self.Conv2D_2(y), eval_mode)
        if self.proj is not None:
            residual = self.proj_bn(self.proj(residual), eval_mode)
        return torch.relu(y + residual.to(y.dtype))


class ResNet(nn.Module):
    """slim-style ResNet-v1 for 224x224 ImageNet inputs (NHWC)."""

    def __init__(self, stage_sizes: Sequence[int] = (3, 4, 6, 3),
                 num_classes: int = 1000, width: int = 64,
                 dtype: torch.dtype = torch.bfloat16, conv_impl: str = "auto",
                 in_channels: int = 3,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dtype = dtype
        self.conv_impl = conv_impl
        self.conv_init = Conv2D(in_channels, width, (7, 7), strides=(2, 2),
                                padding=[(3, 3), (3, 3)], use_bias=False,
                                dtype=dtype, impl=conv_impl,
                                generator=generator)
        self.bn_init = _norm(width)
        features = width
        self.block_names = []
        for stage, n_blocks in enumerate(stage_sizes):
            for block in range(n_blocks):
                strides = 2 if stage > 0 and block == 0 else 1
                name = f"stage{stage}_block{block}"
                filters = width * 2 ** stage
                self.add_module(name, BottleneckBlock(
                    features, filters, strides, dtype, conv_impl, generator))
                self.block_names.append(name)
                features = 4 * filters
        self.head = Dense(features, num_classes, dtype=torch.float32,
                          generator=generator)

    def forward(self, x, train: bool = False, rngs=None):
        """``rngs`` is taken for the classification step's uniform call
        and unused: the ResNet has no dropout."""
        x = x.to(self.dtype)
        x = self.conv_init(x)
        x = torch.relu(self.bn_init(x, not train))
        x = max_pool(x, (3, 3), strides=(2, 2), padding="SAME",
                     impl=self.conv_impl)
        for name in self.block_names:
            x = getattr(self, name)(x, train)
        x = torch.mean(x, dim=(1, 2))
        return self.head(x.to(torch.float32))


@register("resnet50")
def build_resnet50(**kwargs) -> ResNet:
    return ResNet(stage_sizes=(3, 4, 6, 3), **kwargs)


@register("resnet101")
def build_resnet101(**kwargs) -> ResNet:
    return ResNet(stage_sizes=(3, 4, 23, 3), **kwargs)


@register("resnet152")
def build_resnet152(**kwargs) -> ResNet:
    return ResNet(stage_sizes=(3, 8, 36, 3), **kwargs)
