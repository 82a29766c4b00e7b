"""Loss functions: softmax cross entropy, slim-style L2 weight decay, and
the fused chunked unembedding + cross entropy of the LM head.

PyTorch counterpart of ``distributed_tensorflow_models_tpu/ops/losses.py``.
"""

from __future__ import annotations

import os
import sys
from typing import Mapping, Optional, Union

import torch
import torch.nn.functional as F


def resolve_unembed_chunk(default: int = 2048) -> int:
    """``DTM_UNEMBED_CHUNK``, validated as in the JAX package; ``default``
    when unset."""
    env = os.environ.get("DTM_UNEMBED_CHUNK")
    if not env:
        return default
    try:
        v = int(env)
    except ValueError:
        raise ValueError(
            f"DTM_UNEMBED_CHUNK must be an integer, got {env!r}") from None
    if v < 1:
        raise ValueError(f"DTM_UNEMBED_CHUNK must be >= 1, got {env!r}")
    return v


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                          label_smoothing: float = 0.0) -> torch.Tensor:
    """Per-example softmax cross entropy from integer labels; with
    ``label_smoothing`` = eps the targets are
    ``onehot*(1-eps) + eps/num_classes``."""
    num_classes = logits.shape[-1]
    onehot = F.one_hot(labels.long(), num_classes).to(logits.dtype)
    if label_smoothing:
        onehot = onehot * (1.0 - label_smoothing) + label_smoothing / num_classes
    log_probs = torch.log_softmax(logits, dim=-1)
    return -torch.sum(onehot * log_probs, dim=-1)


def mean_softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                               label_smoothing: float = 0.0) -> torch.Tensor:
    return torch.mean(softmax_cross_entropy(logits, labels, label_smoothing))


def l2_weight_decay(params: Mapping[str, torch.Tensor],
                    scale: float) -> torch.Tensor:
    """``scale * sum(0.5 * ||w||^2)`` over kernel parameters: exactly the
    tensors whose name (the flax path of the same parameter) ends in
    ``kernel`` — conv and dense kernels, not BN or biases."""
    total = 0.0
    for name, leaf in params.items():
        if name.endswith("kernel"):
            total = total + 0.5 * torch.sum(torch.square(leaf))
    return scale * total


class _UnembedChunk(torch.autograd.Function):
    """Per-row NLL of one chunk, ``logsumexp(x W + b) - (x W + b)[t]``.

    ``x`` and ``W`` come in the compute dtype; their product is taken in
    f32 (the compute dtype's products are exact there, so this is a
    compute-dtype matmul with f32 accumulation), the bias is f32.  Only the
    inputs are saved: backward recomputes the chunk's logits, so no
    ``[chunk, V]`` tensor outlives the call.  The input and kernel
    cotangents are rounded to their dtypes, as the JAX transpose rule of
    the same product rounds them."""

    @staticmethod
    def forward(ctx, x, kmat, bias, targets):
        logits = torch.matmul(x.float(), kmat.float())
        if bias is not None:
            logits = logits + bias
        lse = torch.logsumexp(logits, dim=-1)
        picked = logits.gather(1, targets.long()[:, None])[:, 0]
        ctx.save_for_backward(x, kmat, bias, targets, lse)
        return lse - picked

    @staticmethod
    def backward(ctx, g):
        x, kmat, bias, targets, lse = ctx.saved_tensors
        logits = torch.matmul(x.float(), kmat.float())
        if bias is not None:
            logits = logits + bias
        # d(lse - picked)/dlogits = softmax - onehot(target).
        dlogits = torch.exp(logits - lse[:, None])
        rows = torch.arange(dlogits.shape[0], device=dlogits.device)
        dlogits[rows, targets.long()] -= 1.0
        dlogits = dlogits * g[:, None]
        dx = dk = db = None
        if ctx.needs_input_grad[0]:
            dx = torch.matmul(dlogits, kmat.float().t()).to(x.dtype)
        if ctx.needs_input_grad[1]:
            dk = torch.matmul(x.float().t(), dlogits).to(kmat.dtype)
        if bias is not None and ctx.needs_input_grad[2]:
            db = dlogits.sum(0)
        return dx, dk, db, None


def chunked_unembed_xent(hidden: torch.Tensor, kernel: torch.Tensor,
                         bias: Optional[torch.Tensor], targets: torch.Tensor,
                         *, chunk_rows: Union[int, str] = "auto",
                         compute_dtype: torch.dtype = torch.bfloat16
                         ) -> torch.Tensor:
    """Per-token NLL of ``Dense(hidden) -> softmax xent`` without the full
    ``[B*T, V]`` f32 logits: rows go in chunks of ``chunk_rows`` (2048, or
    ``DTM_UNEMBED_CHUNK``), each chunk's matmul in ``compute_dtype`` with
    f32 accumulation and an f32 bias, its logits recomputed in backward.

    ``hidden [B, T, d]``, ``kernel [d, V]``, ``bias [V]`` or None,
    ``targets [B, T]``; returns ``[B, T]`` f32.  The cast kernel is one
    tensor shared by every chunk, so its gradient sums over chunks in the
    compute dtype before the cast back, as in the JAX package."""
    B, T, d = hidden.shape
    n = B * T
    x = hidden.reshape(n, d)
    t = targets.reshape(n)
    if chunk_rows == "auto":
        chunk_rows = resolve_unembed_chunk()
    c = min(chunk_rows, n)
    if c != chunk_rows and os.environ.get("DTM_UNEMBED_CHUNK"):
        print(f"[losses] DTM_UNEMBED_CHUNK={chunk_rows} clamped to {c} "
              f"(B*T={n})", file=sys.stderr)
    xc = x.to(compute_dtype)
    kmat = kernel.to(compute_dtype)
    b32 = None if bias is None else bias.float()
    nll = torch.cat([_UnembedChunk.apply(xc[lo:lo + c], kmat, b32,
                                         t[lo:lo + c])
                     for lo in range(0, n, c)])
    return nll.reshape(B, T)
