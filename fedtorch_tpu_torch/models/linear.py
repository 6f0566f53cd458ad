"""Convex models (port of ``fedtorch_tpu/models/linear.py``):
``logistic_regression`` — a zero-initialised linear classifier with the
per-dataset class count of ``CONVEX_DIMS`` (ref:
convex/logistic_regression.py:9-83) — and ``least_square``, a linear
regression head with one output (ref: convex/least_square.py:9-41).

The single product runs in the compute dtype and the output is float32,
as in the JAX package. Not ported, refused by ``define_model``: the
``robust_*`` variants (their input-noise ascent, ``robust_noise_ascent``,
goes with the algorithm zoo) and the factorized ``LinearMAFL``.
"""
from __future__ import annotations

import torch
import torch.nn as nn

from fedtorch_tpu_torch.models.common import (
    CONVEX_DIMS, REGRESSION_DIMS, Dense,
)

_FLATTEN_DATASETS = ("mnist", "cifar10", "cifar100", "fashion_mnist",
                     "emnist", "emnist_full")


class LogisticRegression(nn.Module):
    """``[B, ...]`` -> ``[B, classes]`` float32 logits; image datasets are
    flattened first. ``in_features`` is the flattened input size."""

    def __init__(self, dataset: str, in_features: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if dataset not in CONVEX_DIMS:
            raise ValueError(
                f"convex models do not support dataset {dataset!r}")
        # zero init matches logistic_regression.py:75-80
        self.Dense_0 = Dense(in_features, CONVEX_DIMS[dataset][1],
                             dtype=dtype, kernel_init="zeros")
        self.flatten = dataset in _FLATTEN_DATASETS

    def forward(self, x):
        if self.flatten:
            x = x.reshape(x.shape[0], -1)
        return self.Dense_0(x).to(torch.float32)


class LeastSquare(nn.Module):
    """``[B, F]`` -> ``[B, 1]`` float32 predictions."""

    def __init__(self, dataset: str, in_features: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if dataset not in REGRESSION_DIMS:
            raise ValueError(
                f"least squares does not support dataset {dataset!r}")
        self.Dense_0 = Dense(in_features, 1, dtype=dtype)

    def forward(self, x):
        return self.Dense_0(x).to(torch.float32)
