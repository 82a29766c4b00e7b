"""Training state: step, parameters, BN statistics and optimizer slots.

PyTorch counterpart of ``distributed_tensorflow_models_tpu/core/train_state.py``.
``params`` and ``batch_stats`` are dicts of the model's own parameter and
buffer tensors, keyed by their state-dict names, so an update applied to
them in place is what the model computes with next.  ``carry`` is the
recurrent state an LM threads across steps (``None`` for the transformer,
which passes it through).  The EMA shadow (``ema_params``) stays ``None``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
from torch import nn

from distributed_tensorflow_models_tpu_torch.ops.optim import GradientTransformation


@dataclasses.dataclass(frozen=True)
class TrainState:
    step: int
    params: dict[str, torch.Tensor]
    batch_stats: dict[str, torch.Tensor]
    opt_state: dict[str, Any]
    model: nn.Module
    tx: GradientTransformation
    ema_params: Optional[dict[str, torch.Tensor]] = None
    carry: Optional[Any] = None

    def replace(self, **kw) -> "TrainState":
        return dataclasses.replace(self, **kw)

    @classmethod
    def create(cls, model: nn.Module, tx: GradientTransformation,
               carry: Optional[Any] = None) -> "TrainState":
        params = dict(model.named_parameters())
        return cls(
            step=0,
            params=params,
            batch_stats=dict(model.named_buffers()),
            opt_state=tx.init(params),
            model=model,
            tx=tx,
            carry=carry,
        )
