"""Token embedding lookup with the JAX package's scatter gradient.

PyTorch counterpart of ``distributed_tensorflow_models_tpu/ops/embed.py``.
The forward is a row gather (negative ids wrap by ``+V``, as the JAX
gather wraps them); the backward sums each token's cotangent row into an
f32 ``[V, d]`` table and casts the sum to the table's dtype, by one of two
lowerings (``grad_impl``, or ``DTM_EMBED_GRAD`` for ``"auto"``):

- ``"scatter"`` (the default): ``index_add_`` of the rows;
- ``"matmul"``: the chunked one-hot product ``one_hot(tokens)^T @ g``, in
  chunks of ``chunk`` (2048) tokens with zero-padded tail rows, the
  one-hot built by comparison with an ``arange(V)``, each chunk's product
  accumulated in f32 (the JAX package builds the one-hot in ``g``'s dtype;
  {0, 1} and each product are exact in any float dtype, so the sums are
  the same).

Both give the same values up to the order of the f32 sums.
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
    return impl


def _one_hot_matmul_grad(flat: torch.Tensor, g: torch.Tensor, V: int,
                         chunk: int) -> torch.Tensor:
    """``[V, d]`` f32: the rows of ``g [n, d]`` summed by token id
    ``flat [n]`` (ids in ``[0, V)``) as one-hot products, chunk by chunk.
    Padding rows carry ``g = 0``, so the id they compare against adds
    nothing; ``max(1, ...)`` keeps the empty edge from a zero chunk."""
    n, d = g.shape
    chunk = max(1, min(chunk, n))
    pad = (-n) % chunk
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
        g = torch.cat([g, g.new_zeros(pad, d)])
    vocab = torch.arange(V, device=g.device, dtype=flat.dtype)
    acc = torch.zeros(V, d, dtype=torch.float32, device=g.device)
    for lo in range(0, n + pad, chunk):
        # Only the order of the f32 sums differs from the scatter.
        oh = (flat[lo:lo + chunk, None] == vocab).float()
        acc += torch.matmul(oh.t(), g[lo:lo + chunk].float())
    return acc


class _EmbedLookup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, tokens, grad_impl, chunk):
        V = table.shape[0]
        flat = tokens.reshape(-1)
        flat = torch.where(flat < 0, flat + V, flat)
        ctx.save_for_backward(flat)
        ctx.table_shape = table.shape
        ctx.table_dtype = table.dtype
        ctx.grad_impl, ctx.chunk = grad_impl, chunk
        return table.index_select(0, flat).reshape(*tokens.shape,
                                                   table.shape[1])

    @staticmethod
    def backward(ctx, g):
        (flat,) = ctx.saved_tensors
        V, d = ctx.table_shape
        gf = g.reshape(-1, d)
        if ctx.grad_impl == "matmul":
            dt = _one_hot_matmul_grad(flat, gf, V, ctx.chunk)
        else:
            dt = torch.zeros(V, d, dtype=torch.float32, device=g.device)
            dt.index_add_(0, flat, gf.float())
        return dt.to(ctx.table_dtype), None, None, None


def embed_lookup(table: torch.Tensor, tokens: torch.Tensor,
                 grad_impl: str = "scatter", chunk: int = 2048
                 ) -> torch.Tensor:
    """``table[tokens]``; output shape ``tokens.shape + (d,)``; the
    backward by ``grad_impl`` (module docstring)."""
    impl = resolve_embed_grad_impl(grad_impl)
    return _EmbedLookup.apply(table, tokens, impl, chunk)


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

    # A table split over its columns under the model axis
    # (parallel/tensor.py::Split, kind "embed") gathers them after the
    # lookup; None when it is whole.
    tp = None

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        out = embed_lookup(self.embedding.to(self.dtype), tokens,
                           self.grad_impl)
        return out if self.tp is None else self.tp.exit(out)
