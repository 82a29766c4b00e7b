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
    keep = uniform(x.shape, rngs, x.device) < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


def uniform(shape, rngs: Optional[Mapping[str, torch.Generator]],
            device: torch.device, batch_dim: int = 0) -> torch.Tensor:
    """:func:`dropout`'s uniform draw for a tensor of ``shape`` whose batch
    dim is ``batch_dim`` (and whose token dim, under a seq axis, the
    context's ``seq_dim`` after it): the global array's draw from
    ``rngs['dropout']``, this process's block of it kept."""
    if not rngs or "dropout" not in rngs:
        raise ValueError("dropout in training needs rngs={'dropout': gen}")
    mesh = meshlib.current_mesh()
    shape = list(shape)
    local, block = list(shape), [slice(None)] * len(shape)
    if mesh is not None:
        seq_dim = meshlib.current_seq_dim()
        if mesh.data_size > 1:
            shape[batch_dim] *= mesh.data_size
            block[batch_dim] = shardlib.batch_rows(mesh, shape[batch_dim])
        if seq_dim is not None:
            d = batch_dim + seq_dim
            shape[d] *= mesh.seq_size
            block[d] = shardlib.seq_cols(mesh, shape[d])
    u = torch.rand(shape, generator=rngs["dropout"], device=device)
    if shape != local:
        u = u[tuple(block)]
    return u
