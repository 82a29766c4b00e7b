"""Token embedding lookup with the JAX package's scatter gradient.

PyTorch counterpart of ``distributed_tensorflow_models_tpu/ops/embed.py``.
The forward is a row gather; the backward adds each token's cotangent row
into an f32 ``[V, d]`` table and casts the sum to the table's dtype (the
``scatter`` lowering, the default).  The chunked one-hot matmul gradient
(``DTM_EMBED_GRAD=matmul``) is not ported yet and raises.
"""

from __future__ import annotations

import math
import os
from typing import Optional

import torch
from torch import nn

_VALID_IMPLS = ("scatter", "matmul")


def resolve_embed_grad_impl(impl: str = "auto") -> str:
    if impl == "auto":
        impl = os.environ.get("DTM_EMBED_GRAD", "scatter")
    if impl not in _VALID_IMPLS:
        raise ValueError(f"embed grad impl (DTM_EMBED_GRAD) must be one of "
                         f"{_VALID_IMPLS}, got {impl!r}")
    if impl == "matmul":
        raise NotImplementedError(
            "the one-hot matmul embedding gradient (DTM_EMBED_GRAD=matmul) "
            "is not ported yet")
    return impl


class _EmbedLookup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, tokens):
        ctx.save_for_backward(tokens)
        ctx.table_shape = table.shape
        ctx.table_dtype = table.dtype
        flat = tokens.reshape(-1)
        return table.index_select(0, flat).reshape(*tokens.shape,
                                                   table.shape[1])

    @staticmethod
    def backward(ctx, g):
        (tokens,) = ctx.saved_tensors
        V, d = ctx.table_shape
        dt = torch.zeros(V, d, dtype=torch.float32, device=g.device)
        dt.index_add_(0, tokens.reshape(-1), g.reshape(-1, d).float())
        return dt.to(ctx.table_dtype), None


def embed_lookup(table: torch.Tensor, tokens: torch.Tensor,
                 grad_impl: str = "scatter") -> torch.Tensor:
    """``table[tokens]``; output shape ``tokens.shape + (d,)``.  Only the
    ``scatter`` gradient is ported; anything else raises."""
    resolve_embed_grad_impl(grad_impl)
    return _EmbedLookup.apply(table, tokens)


class TokenEmbed(nn.Module):
    """``flax.linen.Embed``-shaped lookup: parameter ``embedding [V, d]``
    in f32, initialised as ``variance_scaling(1, fan_in, normal,
    out_axis=0)`` (a normal of variance 1/d), cast to ``dtype`` before the
    lookup."""

    def __init__(self, num_embeddings: int, features: int,
                 dtype: torch.dtype = torch.float32, grad_impl: str = "auto",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dtype = dtype
        self.grad_impl = grad_impl
        self.embedding = nn.Parameter(
            torch.empty(num_embeddings, features, dtype=torch.float32))
        with torch.no_grad():
            self.embedding.normal_(0.0, 1.0 / math.sqrt(features),
                                   generator=generator)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return embed_lookup(self.embedding.to(self.dtype), tokens,
                            self.grad_impl)
