"""Rotary position embeddings (RoPE).

PyTorch counterpart of ``distributed_tensorflow_models_tpu/ops/rotary.py``:
each query and key is rotated by an angle proportional to its token's
global position before attention, so ``q . k`` depends only on the
distance between the two; the attention kernels see ordinary q and k.
Half-split ("rotate_half", GPT-NeoX/Llama) convention: feature ``i`` of
``[0, D/2)`` pairs with feature ``i + D/2``.  The rotation is done in f32
and the result cast back to the input's dtype.
"""

from __future__ import annotations

import torch


def rope_angles(positions: torch.Tensor, dim: int, theta: float = 10000.0):
    """``(cos, sin)`` f32 tables of shape ``positions.shape + (dim/2,)`` for
    an even head dim ``dim``."""
    if dim % 2:
        raise ValueError(f"RoPE head dim must be even, got {dim}")
    inv_freq = theta ** (
        -torch.arange(0, dim, 2, dtype=torch.float32,
                      device=positions.device) / dim)
    ang = positions.to(torch.float32)[..., None] * inv_freq
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """Rotate ``x [B, T, H, D]`` by its tokens' global ``positions``
    (``[T]`` or ``[B, T]``, on ``x``'s device: in decode
    ``cache.index + arange(T)``, made without a host read)."""
    cos, sin = rope_angles(positions, x.shape[-1], theta)  # [..., T, D/2]
    return rotate(x, cos, sin)


def rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
           ) -> torch.Tensor:
    """Rotate ``x [B, T, H, D]`` by the angles' tables ``cos``/``sin``
    (``[T, D/2]`` or ``[B, T, D/2]``, f32)."""
    D = x.shape[-1]
    if cos.dim() == 2:
        cos, sin = cos[None], sin[None]
    cos, sin = cos[:, :, None, :], sin[:, :, None, :]
    x32 = x.to(torch.float32)
    x1, x2 = x32[..., :D // 2], x32[..., D // 2:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)
