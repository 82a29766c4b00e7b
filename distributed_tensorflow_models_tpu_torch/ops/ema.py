"""Exponential moving average of parameters with TF semantics.

PyTorch counterpart of ``distributed_tensorflow_models_tpu/ops/ema.py``:
the shadow copies live in the train state (``TrainState.ema_params``) and
are what evaluation restores in place of the raw weights.  The shadows are
updated in place (``torch._foreach_*``), which saves a copy of every
parameter per step and keeps them at the addresses a captured step wrote.
"""

from __future__ import annotations

from typing import Mapping, Optional, Union

import torch

Count = Union[int, torch.Tensor, None]


def effective_decay(decay: float, num_updates: Count = None) -> torch.Tensor:
    """TF's warm-up-damped decay: ``min(decay, (1 + n) / (10 + n))`` with
    ``n = num_updates``, so early steps average faster; ``decay`` itself
    when no count is given.  In f32, as the JAX package computes it: on the
    CPU for a Python count, on the count's device for a tensor (the step of
    a captured train step), with the same value."""
    if isinstance(num_updates, torch.Tensor):
        n = num_updates.to(torch.float32)
        d = torch.full((), decay, dtype=torch.float32, device=n.device)
    else:
        d = torch.tensor(decay, dtype=torch.float32)
        if num_updates is None:
            return d
        n = torch.tensor(num_updates, dtype=torch.float32)
    return torch.minimum(d, (1.0 + n) / (10.0 + n))


@torch.no_grad()
def update_ema(ema_params: Mapping[str, torch.Tensor],
               params: Mapping[str, torch.Tensor], decay: float,
               num_updates: Count = None) -> Mapping[str, torch.Tensor]:
    """``shadow <- shadow - (1 - decay) * (shadow - value)`` for every
    shadow, in place; returns ``ema_params``."""
    names = list(ema_params)
    if not names:
        return ema_params
    shadows = [ema_params[k] for k in names]
    w = (1.0 - effective_decay(decay, num_updates)).to(shadows[0].device)
    diff = torch._foreach_sub(shadows,
                              [params[k].to(ema_params[k].dtype)
                               for k in names])
    torch._foreach_mul_(diff, w)
    torch._foreach_sub_(shadows, diff)
    return ema_params
