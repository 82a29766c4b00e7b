"""AlexNet (slim ``alexnet_v2``), a throughput benchmark model.

PyTorch counterpart of
``distributed_tensorflow_models_tpu/models/alexnet.py``: ``conv1`` 11x11/4
VALID (64) and a 3x3/2 max pool, ``conv2`` 5x5 SAME (192) and a pool,
``conv3``-``conv5`` 3x3 SAME (384/384/256) and a pool, ``fc6`` and
``fc7`` (4096, ReLU, dropout) in ``dtype`` (bf16 by default), a cast to
f32 and the f32 ``head``; no LRN.  ``fc6``'s width (6400 = 5x5x256 at
224x224) is fixed at construction from ``image_size``, in the NHWC
flatten order flax uses; an input of another size raises.  Under
``impl="mxu"`` ``conv2``-``conv5`` take K1 (``conv1``, Cin 3, routes to
``conv2d_patches``).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from distributed_tensorflow_models_tpu_torch.models import register
from distributed_tensorflow_models_tpu_torch.models.lenet import check_image_size
from distributed_tensorflow_models_tpu_torch.ops.conv import Conv2D, Dense, max_pool
from distributed_tensorflow_models_tpu_torch.ops.dropout import dropout


def _pooled(n: int) -> int:
    """Side of a 3x3/2 VALID max pool's output."""
    return (n - 3) // 2 + 1


class AlexNet(nn.Module):
    def __init__(self, num_classes: int = 1000, dropout_rate: float = 0.5,
                 dtype: torch.dtype = torch.bfloat16, conv_impl: str = "auto",
                 image_size: int = 224, in_channels: int = 3,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dtype = dtype
        self.conv_impl = conv_impl
        self.dropout_rate = dropout_rate
        self.image_size = image_size
        self.in_channels = in_channels
        conv = dict(dtype=dtype, impl=conv_impl, generator=generator)
        self.conv1 = Conv2D(in_channels, 64, (11, 11), strides=(4, 4),
                            padding="VALID", **conv)
        self.conv2 = Conv2D(64, 192, (5, 5), padding="SAME", **conv)
        self.conv3 = Conv2D(192, 384, (3, 3), padding="SAME", **conv)
        self.conv4 = Conv2D(384, 384, (3, 3), padding="SAME", **conv)
        self.conv5 = Conv2D(384, 256, (3, 3), padding="SAME", **conv)
        side = _pooled(_pooled(_pooled((image_size - 11) // 4 + 1)))
        self.fc6 = Dense(side * side * 256, 4096, dtype=dtype,
                         generator=generator)
        self.fc7 = Dense(4096, 4096, dtype=dtype, generator=generator)
        self.head = Dense(4096, num_classes, dtype=torch.float32,
                          generator=generator)

    def _pool(self, x):
        return max_pool(x, (3, 3), strides=(2, 2), impl=self.conv_impl)

    def forward(self, x, train: bool = False, rngs=None):
        check_image_size(self, x)
        x = x.to(self.dtype)
        x = self._pool(torch.relu(self.conv1(x)))
        x = self._pool(torch.relu(self.conv2(x)))
        for conv in (self.conv3, self.conv4, self.conv5):
            x = torch.relu(conv(x))
        x = self._pool(x)
        x = x.reshape(x.shape[0], -1)  # NHWC order, as flax flattens
        for fc in (self.fc6, self.fc7):
            x = dropout(torch.relu(fc(x)), self.dropout_rate, train, rngs)
        return self.head(x.to(torch.float32))


register("alexnet")(AlexNet)
