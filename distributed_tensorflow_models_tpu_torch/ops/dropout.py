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

    Under a mesh (``core/mesh.py::data_parallel``) the mask is drawn for
    the global array and this process keeps its block of it: its rows
    over a data axis of D (``x`` is batch-leading) and its columns of the
    token axis over a seq axis of S (the context's ``seq_dim``).  Every
    layout then draws exactly the masks of one process at the global
    array, as the JAX package draws one mask for the global array.  It
    costs D x S times the draws of the local mask.  No model drops out an
    activation split over the model axis (the tensor-parallel layers
    drop out whole ones), so the processes of a model axis hold the same
    values and draw the same mask.

    Under remat (``ops/remat.py``) a block's recompute is given
    generators that start where its forward's did, so it draws the
    forward's masks again, bit for bit."""
    if not rate or not train:
        return x
    if not rngs or "dropout" not in rngs:
        raise ValueError("dropout in training needs rngs={'dropout': gen}")
    mesh = meshlib.current_mesh()
    shape, block = list(x.shape), [slice(None)] * x.ndim
    if mesh is not None:
        seq_dim = meshlib.current_seq_dim()
        if mesh.data_size > 1:
            shape[0] *= mesh.data_size
            block[0] = shardlib.batch_rows(mesh, shape[0])
        if seq_dim is not None:
            shape[seq_dim] *= mesh.seq_size
            block[seq_dim] = shardlib.seq_cols(mesh, shape[seq_dim])
    u = torch.rand(shape, generator=rngs["dropout"], device=x.device)
    if shape != list(x.shape):
        u = u[tuple(block)]
    keep = u < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))
