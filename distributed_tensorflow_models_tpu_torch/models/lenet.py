"""MNIST LeNet: conv5x5(32)-pool / conv5x5(64)-pool / fc1024-dropout /
f32 head.

PyTorch counterpart of ``distributed_tensorflow_models_tpu/models/lenet.py``.
Activations are NHWC in ``dtype`` (f32 by default).  The flatten before
``Dense_0`` is in NHWC order, as flax's, and ``Dense_0``'s width
(``(image_size // 4)**2 * 64``, 3136 at 28x28) is fixed at construction
from ``image_size``, where flax infers it from the sample at ``init``; an
input of another size raises.  Submodules carry the flax names
(``Conv2D_0``, ``Conv2D_1``, ``Dense_0``, ``head``).  Both convs route to
``conv2d_patches`` under ``impl="mxu"`` (Cin 1 and 32 fill under half of
K1's 128-lane rule), so LeNet runs no hand-written kernel.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from distributed_tensorflow_models_tpu_torch.models import register
from distributed_tensorflow_models_tpu_torch.ops.conv import Conv2D, Dense, max_pool
from distributed_tensorflow_models_tpu_torch.ops.dropout import dropout


def check_image_size(model: nn.Module, x: torch.Tensor) -> None:
    """Raise unless ``x`` is ``[B, image_size, image_size, in_channels]``:
    the first dense layer's width was fixed from those at construction."""
    want = (model.image_size, model.image_size, model.in_channels)
    if tuple(x.shape[1:]) != want:
        raise ValueError(
            f"{type(model).__name__} was built for {want[0]}x{want[1]}x"
            f"{want[2]} inputs (its first dense layer's width follows "
            f"from that), got {tuple(x.shape[1:])}")


class LeNet(nn.Module):
    """Input ``[B, 28, 28, 1]`` float images in [0, 1]."""

    def __init__(self, num_classes: int = 10, dropout_rate: float = 0.5,
                 dtype: torch.dtype = torch.float32, conv_impl: str = "auto",
                 image_size: int = 28, in_channels: int = 1,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dtype = dtype
        self.conv_impl = conv_impl
        self.dropout_rate = dropout_rate
        self.image_size = image_size
        self.in_channels = in_channels
        conv = dict(padding="SAME", dtype=dtype, impl=conv_impl,
                    generator=generator)
        self.Conv2D_0 = Conv2D(in_channels, 32, (5, 5), **conv)
        self.Conv2D_1 = Conv2D(32, 64, (5, 5), **conv)
        side = image_size // 2 // 2  # two 2x2/2 VALID pools
        self.Dense_0 = Dense(side * side * 64, 1024, dtype=dtype,
                             generator=generator)
        self.head = Dense(1024, num_classes, dtype=torch.float32,
                          generator=generator)

    def forward(self, x, train: bool = False, rngs=None):
        check_image_size(self, x)
        x = x.to(self.dtype)
        for conv in (self.Conv2D_0, self.Conv2D_1):
            x = torch.relu(conv(x))
            x = max_pool(x, (2, 2), strides=(2, 2), impl=self.conv_impl)
        x = x.reshape(x.shape[0], -1)  # NHWC order, as flax flattens
        x = torch.relu(self.Dense_0(x))
        x = dropout(x, self.dropout_rate, train, rngs)
        return self.head(x)


register("lenet")(LeNet)
