"""``flax.linen.Dropout`` for the port's models."""

from __future__ import annotations

from typing import Mapping, Optional

import torch


def dropout(x: torch.Tensor, rate: float, train: bool,
            rngs: Optional[Mapping[str, torch.Generator]]) -> torch.Tensor:
    """Keep each value with probability 1 - rate and scale the kept ones by
    1 / (1 - rate), in training only.  The bits come from
    ``rngs['dropout']`` and differ from JAX's."""
    if not rate or not train:
        return x
    if not rngs or "dropout" not in rngs:
        raise ValueError("dropout in training needs rngs={'dropout': gen}")
    keep = torch.rand(x.shape, generator=rngs["dropout"],
                      device=x.device) < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))
