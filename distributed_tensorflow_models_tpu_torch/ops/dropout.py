"""``flax.linen.Dropout`` for the port's models."""

from __future__ import annotations

from typing import Mapping, Optional

import torch

from distributed_tensorflow_models_tpu_torch.core import mesh as meshlib
from distributed_tensorflow_models_tpu_torch.core import sharding as shardlib


def dropout(x: torch.Tensor, rate: float, train: bool,
            rngs: Optional[Mapping[str, torch.Generator]]) -> torch.Tensor:
    """Keep each value with probability 1 - rate and scale the kept ones by
    1 / (1 - rate), in training only.  The bits come from
    ``rngs['dropout']`` and differ from JAX's.

    Under a data axis of W processes (``core/mesh.py::data_parallel``) the
    mask is drawn for the global batch, ``W * x.shape[0]`` rows (``x`` is
    batch-leading), and this process keeps its rows of it: W processes
    then draw exactly the masks of one process at the global batch, as the
    JAX package draws one mask for the global array.  It costs W times the
    draws of the local mask.

    Under remat (``ops/remat.py``) a block's recompute is given
    generators that start where its forward's did, so it draws the
    forward's masks again, bit for bit."""
    if not rate or not train:
        return x
    if not rngs or "dropout" not in rngs:
        raise ValueError("dropout in training needs rngs={'dropout': gen}")
    mesh = meshlib.current_mesh()
    if mesh is None or mesh.data_size == 1:
        u = torch.rand(x.shape, generator=rngs["dropout"], device=x.device)
    else:
        u = torch.rand((mesh.data_size * x.shape[0], *x.shape[1:]),
                       generator=rngs["dropout"], device=x.device)
        u = u[shardlib.batch_rows(mesh, u.shape[0])]
    keep = u < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))
