"""Criterion and metrics (port of ``fedtorch_tpu/core/losses.py``).

Top-k follows ``lax.top_k``'s order: the floats' total order (+0.0
above -0.0, NaN on top) and, among equal logits, the lower class index
first. ``torch.topk`` promises no order among ties (and bf16 logits tie
often), and ``torch.sort`` counts -0.0 equal to +0.0, so top-k here is a
stable descending sort of an integer key that orders the float32 bits
as the total order does; top-1 is the key's ``argmax``, which returns
the first maximal index.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F


def per_sample_nll(logits: torch.Tensor,
                   labels: torch.Tensor) -> torch.Tensor:
    """Per-sample negative log-likelihood, [B]: log-softmax over the
    last axis, the label's entry; for a sequence model's ``[B, T, V]``
    logits the time axis is averaged per sample."""
    logp = F.log_softmax(logits, dim=-1)
    nll = -logp.gather(-1, labels.long()[..., None])[..., 0]
    return nll.mean(-1) if nll.dim() == 2 else nll


def per_sample_loss(logits: torch.Tensor, labels: torch.Tensor,
                    is_regression: bool) -> torch.Tensor:
    """Per-sample criterion value, [B]."""
    if is_regression:
        return torch.square(logits.reshape(labels.shape[0], -1).mean(-1)
                            - labels)
    return per_sample_nll(logits, labels)


def softmax_cross_entropy(logits: torch.Tensor,
                          labels: torch.Tensor) -> torch.Tensor:
    """Mean CE over the batch (and the time axis of ``[B, T, V]``
    logits)."""
    return per_sample_nll(logits, labels).mean()


def mse_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.square(pred.reshape(-1) - target.reshape(-1)))


def make_criterion(is_regression: bool):
    """criterion.py:6-11 dispatch."""
    return mse_loss if is_regression else softmax_cross_entropy


def _total_order_key(logits: torch.Tensor) -> torch.Tensor:
    """int32 keys that order as the float32 values do in the total order:
    negative floats' magnitude bits flipped, so -0.0 (-1) < +0.0 (0)."""
    bits = logits.to(torch.float32).contiguous().view(torch.int32)
    return bits ^ ((bits >> 31) & 0x7FFFFFFF)


def topk_indices(logits: torch.Tensor, k: int) -> torch.Tensor:
    """The ``k`` largest classes per row, ``[..., k]``, in
    ``lax.top_k``'s order (ties to the lower index)."""
    key = _total_order_key(logits)
    if k == 1:
        return key.argmax(dim=-1, keepdim=True)
    return torch.sort(key, dim=-1, descending=True, stable=True).indices[
        ..., :k]


def topk_accuracy(logits: torch.Tensor, labels: torch.Tensor,
                  ks: Sequence[int] = (1,)) -> torch.Tensor:
    """Top-k accuracies (metrics.py:50-73), ``[len(ks)]``; ``[B, T, V]``
    logits count every token."""
    if logits.dim() == 3:
        logits = logits.reshape(-1, logits.shape[-1])
        labels = labels.reshape(-1)
    pred = topk_indices(logits, max(ks))
    correct = pred == labels[:, None].to(pred.dtype)
    return torch.stack([correct[:, :k].any(dim=1).to(torch.float32).mean()
                        for k in ks])


def accuracy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Top-1 accuracy in [0, 1]."""
    return topk_accuracy(logits, labels, (1,))[0]


def per_class_accuracy(logits: torch.Tensor, labels: torch.Tensor,
                       num_classes: int, mask: torch.Tensor = None):
    """metrics.py:77-91: (correct_count, total_count) per class, float32
    ``[num_classes]`` each. ``mask`` [B] zeroes padding rows out of both
    counts."""
    pred = logits.argmax(dim=-1)
    onehot = F.one_hot(labels.long(), num_classes).to(torch.float32)
    if mask is not None:
        onehot = onehot * mask[:, None]
    correct = (pred == labels.to(pred.dtype))[:, None] * onehot
    return correct.sum(0), onehot.sum(0)


def metrics_topk(num_classes: int) -> Sequence[int]:
    """define_metrics (metrics.py:8-18): (1,) for few classes, (1, 5)
    when there are at least 5 classes."""
    return (1, 5) if num_classes >= 5 else (1,)
