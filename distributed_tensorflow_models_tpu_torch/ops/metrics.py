"""Evaluation metrics: top-k accuracy.

PyTorch counterpart of ``distributed_tensorflow_models_tpu/ops/metrics.py``.
"""

from __future__ import annotations

import torch


def top_k_correct(logits: torch.Tensor, labels: torch.Tensor, k: int) -> torch.Tensor:
    """Per-example 0/1 indicator that the true label is in the top-k."""
    topk = torch.topk(logits, k, dim=-1).indices
    return (topk == labels[..., None]).any(dim=-1).to(torch.float32)


def accuracy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return torch.mean((torch.argmax(logits, dim=-1) == labels).to(torch.float32))
