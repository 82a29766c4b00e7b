"""Loss functions: softmax cross entropy and slim-style L2 weight decay.

PyTorch counterpart of ``distributed_tensorflow_models_tpu/ops/losses.py``.
"""

from __future__ import annotations

from typing import Mapping

import torch
import torch.nn.functional as F


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
