"""VGG-16 (slim ``vgg_16``), the throughput benchmark's dense-gradient
model.

PyTorch counterpart of ``distributed_tensorflow_models_tpu/models/vgg.py``:
five stages of 2-2-3-3-3 SAME 3x3 convs (64/128/256/512/512) named
``conv{stage}_{i}``, each stage followed by a 2x2/2 max pool, then ``fc6``
and ``fc7`` (4096, ReLU, dropout) in ``dtype`` (bf16 by default), a cast
to f32 and the f32 ``head``.  ``fc6``'s width (``(image_size // 32)**2 *
512``, 25088 at 224x224) is fixed at construction from ``image_size``, in
the NHWC flatten order flax uses; an input of another size raises.  Under
``impl="mxu"`` every conv but ``conv1_1`` (Cin 3) takes K1.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from distributed_tensorflow_models_tpu_torch.models import register
from distributed_tensorflow_models_tpu_torch.models.lenet import check_image_size
from distributed_tensorflow_models_tpu_torch.ops.conv import Conv2D, Dense, max_pool
from distributed_tensorflow_models_tpu_torch.ops.dropout import dropout

STAGES = ((2, 64), (2, 128), (3, 256), (3, 512), (3, 512))


class VGG16(nn.Module):
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
        self.stage_names = []
        features, side = in_channels, image_size
        for stage, (n_convs, width) in enumerate(STAGES):
            names = [f"conv{stage + 1}_{i + 1}" for i in range(n_convs)]
            for name in names:
                self.add_module(name, Conv2D(
                    features, width, (3, 3), padding="SAME", dtype=dtype,
                    impl=conv_impl, generator=generator))
                features = width
            self.stage_names.append(names)
            side //= 2  # the stage's 2x2/2 VALID pool
        self.fc6 = Dense(side * side * features, 4096, dtype=dtype,
                         generator=generator)
        self.fc7 = Dense(4096, 4096, dtype=dtype, generator=generator)
        self.head = Dense(4096, num_classes, dtype=torch.float32,
                          generator=generator)

    def forward(self, x, train: bool = False, rngs=None):
        check_image_size(self, x)
        x = x.to(self.dtype)
        for names in self.stage_names:
            for name in names:
                x = torch.relu(getattr(self, name)(x))
            x = max_pool(x, (2, 2), strides=(2, 2), impl=self.conv_impl)
        x = x.reshape(x.shape[0], -1)  # NHWC order, as flax flattens
        for fc in (self.fc6, self.fc7):
            x = dropout(torch.relu(fc(x)), self.dropout_rate, train, rngs)
        return self.head(x.to(torch.float32))


register("vgg16")(VGG16)
