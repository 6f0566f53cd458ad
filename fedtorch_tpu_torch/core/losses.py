"""Criterion and metrics (port of ``fedtorch_tpu/core/losses.py``)."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def per_sample_nll(logits: torch.Tensor,
                   labels: torch.Tensor) -> torch.Tensor:
    """Per-sample negative log-likelihood, [B]."""
    return F.cross_entropy(logits, labels.long(), reduction="none")


def per_sample_loss(logits: torch.Tensor, labels: torch.Tensor,
                    is_regression: bool) -> torch.Tensor:
    """Per-sample criterion value, [B]."""
    if is_regression:
        return torch.square(logits.reshape(labels.shape[0], -1).mean(-1)
                            - labels)
    return per_sample_nll(logits, labels)


def softmax_cross_entropy(logits: torch.Tensor,
                          labels: torch.Tensor) -> torch.Tensor:
    """Mean CE over the batch."""
    return per_sample_nll(logits, labels).mean()


def mse_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.square(pred.reshape(-1) - target.reshape(-1)))


def make_criterion(is_regression: bool):
    """criterion.py:6-11 dispatch."""
    return mse_loss if is_regression else softmax_cross_entropy


def accuracy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Top-1 accuracy in [0, 1] (the first maximal logit wins ties, as
    ``lax.top_k`` does in the JAX package)."""
    pred = logits.argmax(dim=-1)
    return (pred == labels.to(pred.dtype)).to(torch.float32).mean()
