"""Exponential moving average of parameters with TF semantics.

PyTorch counterpart of ``distributed_tensorflow_models_tpu/ops/ema.py``:
the shadow copies live in the train state (``TrainState.ema_params``) and
are what evaluation restores in place of the raw weights.  The shadows are
updated in place, which saves a copy of every parameter per step.
"""

from __future__ import annotations

from typing import Mapping, Optional

import torch


def effective_decay(decay: float,
                    num_updates: Optional[int] = None) -> torch.Tensor:
    """TF's warm-up-damped decay: ``min(decay, (1 + n) / (10 + n))`` with
    ``n = num_updates``, so early steps average faster; ``decay`` itself
    when no count is given.  In f32, as the JAX package computes it."""
    d = torch.tensor(decay, dtype=torch.float32)
    if num_updates is None:
        return d
    n = torch.tensor(num_updates, dtype=torch.float32)
    return torch.minimum(d, (1.0 + n) / (10.0 + n))


@torch.no_grad()
def update_ema(ema_params: Mapping[str, torch.Tensor],
               params: Mapping[str, torch.Tensor], decay: float,
               num_updates: Optional[int] = None
               ) -> Mapping[str, torch.Tensor]:
    """``shadow <- shadow - (1 - decay) * (shadow - value)`` for every
    shadow, in place; returns ``ema_params``."""
    # A 0-d CPU tensor enters a CUDA op as a scalar: no copy per leaf.
    w = 1.0 - effective_decay(decay, num_updates)
    for k, s in ema_params.items():
        s.sub_(w * (s - params[k].to(s.dtype)))
    return ema_params
