"""Training state: step, parameters, BN statistics, optimizer slots and the
EMA shadows.

PyTorch counterpart of ``distributed_tensorflow_models_tpu/core/train_state.py``.
``params`` and ``batch_stats`` are dicts of the model's own parameter and
buffer tensors, keyed by their state-dict names, so an update applied to
them in place is what the model computes with next.  ``ema_params`` holds
f32 shadow copies of the parameters when ``ema_decay`` is set (``None``
otherwise); evaluation restores them through :attr:`TrainState.eval_params`.
``carry`` is the recurrent state an LM threads across steps (``None`` for
the transformer, which passes it through).
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
    ema_decay: Optional[float] = None

    def replace(self, **kw) -> "TrainState":
        return dataclasses.replace(self, **kw)

    @property
    def eval_params(self) -> dict[str, torch.Tensor]:
        """The parameters to evaluate with: the EMA shadows when they are
        kept (TF slim's eval-time ``variables_to_restore`` swap),
        else the parameters."""
        return self.ema_params if self.ema_params is not None else self.params

    @classmethod
    def create(cls, model: nn.Module, tx: GradientTransformation,
               ema_decay: Optional[float] = None,
               carry: Optional[Any] = None) -> "TrainState":
        params = dict(model.named_parameters())
        ema_params = None
        if ema_decay is not None:
            ema_params = {k: v.detach().to(torch.float32, copy=True)
                          for k, v in params.items()}
        return cls(
            step=0,
            params=params,
            batch_stats=dict(model.named_buffers()),
            opt_state=tx.init(params),
            model=model,
            tx=tx,
            ema_params=ema_params,
            carry=carry,
            ema_decay=ema_decay,
        )
