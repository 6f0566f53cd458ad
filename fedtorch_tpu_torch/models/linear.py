"""Convex models (port of ``fedtorch_tpu/models/linear.py``):
``logistic_regression`` — a zero-initialised linear classifier with the
per-dataset class count of ``CONVEX_DIMS`` (ref:
convex/logistic_regression.py:9-83) —, ``least_square``, a linear
regression head with one output (ref: convex/least_square.py:9-41), the
factorized ``LinearMAFL`` (least_square.py:43-67), and the ``robust_*``
variants: the same models with a learnable adversarial input noise
``noise`` of shape ``[features]``, drawn N(0, 0.001^2) and added to the
(flattened) input (ref: convex/robust_logistic_regression.py:18,32). The
local step takes gradient *ascent* on it (``algorithms/base.py``) and
evaluation first ascends it over the eval set
(``parallel/evaluate.py``).

The products run in the compute dtype and the output is float32, as in
the JAX package.
"""
from __future__ import annotations

import torch
import torch.nn as nn

from fedtorch_tpu_torch.models.common import (
    CONVEX_DIMS, REGRESSION_DIMS, Dense,
)

_FLATTEN_DATASETS = ("mnist", "cifar10", "cifar100", "fashion_mnist",
                     "emnist", "emnist_full")
NOISE_STD = 0.001


class NoiseInput:
    """Mixin of a model with the robust input noise: ``add_noise``
    registers the ``noise`` param on the model itself, ``noisy(x)`` adds
    it (identity without one), ``init_params`` draws it."""

    def add_noise(self, features: int) -> None:
        self.noise = nn.Parameter(torch.empty(features))

    def noisy(self, x):
        noise = getattr(self, "noise", None)
        return x if noise is None else x + noise

    def init_params(self, generator: torch.Generator) -> dict:
        if getattr(self, "noise", None) is None:
            return {}
        return {"noise": NOISE_STD * torch.randn(self.noise.shape,
                                                 generator=generator)}


class LogisticRegression(nn.Module, NoiseInput):
    """``[B, ...]`` -> ``[B, classes]`` float32 logits; image datasets are
    flattened first. ``in_features`` is the flattened input size."""

    def __init__(self, dataset: str, in_features: int,
                 dtype: torch.dtype = torch.float32, robust: bool = False):
        super().__init__()
        if dataset not in CONVEX_DIMS:
            raise ValueError(
                f"convex models do not support dataset {dataset!r}")
        if robust:
            self.add_noise(in_features)
        # zero init matches logistic_regression.py:75-80
        self.Dense_0 = Dense(in_features, CONVEX_DIMS[dataset][1],
                             dtype=dtype, kernel_init="zeros")
        self.flatten = dataset in _FLATTEN_DATASETS

    def forward(self, x):
        if self.flatten:
            x = x.reshape(x.shape[0], -1)
        return self.Dense_0(self.noisy(x)).to(torch.float32)


class LeastSquare(nn.Module, NoiseInput):
    """``[B, F]`` -> ``[B, 1]`` float32 predictions."""

    def __init__(self, dataset: str, in_features: int,
                 dtype: torch.dtype = torch.float32, robust: bool = False):
        super().__init__()
        if dataset not in REGRESSION_DIMS:
            raise ValueError(
                f"least squares does not support dataset {dataset!r}")
        if robust:
            self.add_noise(in_features)
        self.Dense_0 = Dense(in_features, 1, dtype=dtype)

    def forward(self, x):
        return self.Dense_0(self.noisy(x)).to(torch.float32)


class LinearMAFL(nn.Module):
    """The factorized linear model ``W(Z(x))`` (least_square.py:43-67):
    ``Z`` a bias-free ``in -> middle`` map in the compute dtype, ``W`` a
    float32 ``middle -> out`` map with a bias. A library class: neither
    package's ``define_model`` builds it."""

    def __init__(self, in_features: int, middle_features: int,
                 out_features: int = 1, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.Z = Dense(in_features, middle_features, bias=False, dtype=dtype)
        self.W = Dense(middle_features, out_features)

    def forward(self, x):
        return self.W(self.Z(x).to(torch.float32))
