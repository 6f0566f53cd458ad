"""Shared model pieces: dataset dims, layers, the model definition API.

Port of ``fedtorch_tpu/models/common.py``. Module and parameter names
mirror the JAX package's flax auto-names (``Conv_0``,
``BatchStatsNorm_1``, ``Dense_0``), so a flax path maps onto a
``state_dict`` key by joining with '.' and renaming the leaf
(``bridge.py``). Layouts follow PyTorch: conv weights OIHW, dense
weights ``(out, in)``; activations run NCHW inside the models, while the
public ``forward`` takes the JAX package's NHWC batches.
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.func import functional_call

# flax's lecun_normal draws a standard normal truncated to [-2, 2] and
# rescales by this constant, the std of that truncated normal
_TRUNC_STD = 0.87962566103423978


def num_classes_of(dataset: str) -> int:
    """ref: mlp.py:33-41 / cnn.py:31-37 / resnet.py ResNetBase."""
    table = {
        "cifar10": 10, "mnist": 10, "fashion_mnist": 10, "emnist": 10,
        "stl10": 10, "cifar100": 100, "emnist_full": 62, "adult": 2,
        "synthetic": 10, "higgs": 2, "epsilon": 2, "rcv1": 2,
        "shakespeare": 86, "imagenet": 1000,
    }
    if dataset not in table:
        raise ValueError(f"No class count known for dataset {dataset!r}")
    return table[dataset]


def image_shape(dataset: str):
    """NHWC sample shape for conv models."""
    if "cifar" in dataset:
        return (32, 32, 3)
    if "mnist" in dataset:
        return (28, 28, 1)
    if dataset == "stl10":
        return (96, 96, 3)
    raise NotImplementedError(f"No image shape for {dataset!r}")


def lecun_normal(shape, fan_in: int,
                 generator: torch.Generator) -> torch.Tensor:
    """flax's default kernel init: truncated normal, variance 1/fan_in
    (drawn on the CPU)."""
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    return nn.init.trunc_normal_(torch.empty(shape), std=std,
                                 a=-2.0 * std, b=2.0 * std,
                                 generator=generator)


class Conv(nn.Module):
    """Bias-free 2-D convolution computed in ``dtype`` (the compute
    dtype: params stay float32, input and weight are cast per call, as
    flax's ``nn.Conv(dtype=...)`` does). NCHW in and out; ``padding`` is
    the explicit symmetric pad (flax's 'SAME' for the 1x1 shortcut is
    0)."""

    def __init__(self, cin: int, cout: int, kernel_size: int,
                 stride: int = 1, padding: int = 0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.weight = nn.Parameter(
            torch.empty(cout, cin, kernel_size, kernel_size))
        self.stride, self.padding, self.dtype = stride, padding, dtype

    def init_params(self, generator: torch.Generator) -> dict:
        cout, cin, kh, kw = self.weight.shape
        return {"weight": lecun_normal(self.weight.shape, cin * kh * kw,
                                       generator)}

    def forward(self, x):
        return F.conv2d(x.to(self.dtype), self.weight.to(self.dtype),
                        stride=self.stride, padding=self.padding)


class Dense(nn.Module):
    """Affine layer in float32 (the classifier head)."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin))
        self.bias = nn.Parameter(torch.empty(cout))

    def init_params(self, generator: torch.Generator) -> dict:
        return {"weight": lecun_normal(self.weight.shape,
                                       self.weight.shape[1], generator),
                "bias": torch.zeros(self.bias.shape)}

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)


class BatchStatsNorm(nn.Module):
    """BatchNorm with ``track_running_stats=False`` semantics: always the
    current batch statistics with the BIASED variance, only the affine
    pair in params. Normalizes NCHW over every axis but the channel."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(channels))
        self.bias = nn.Parameter(torch.empty(channels))
        self.eps = eps

    def init_params(self, generator: torch.Generator) -> dict:
        return {"weight": torch.ones(self.weight.shape),
                "bias": torch.zeros(self.bias.shape)}

    def forward(self, x):
        return F.batch_norm(x, None, None, self.weight, self.bias,
                            training=True, eps=self.eps)


def norm_f32(norm: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """Normalize in float32, return in the input's (compute) dtype."""
    return norm(x.to(torch.float32)).to(x.dtype)


class ModelDef(NamedTuple):
    """A model as functions over a params dict (port of the JAX
    package's ``ModelDef``): ``init(generator)`` draws a fresh params
    dict and ``apply(params, x)`` runs the shared module with those
    params (``torch.func.functional_call``), so one module serves every
    client's weights."""
    name: str
    module: Any
    sample_input: torch.Tensor
    is_regression: bool = False

    def init(self, generator: torch.Generator) -> dict:
        """Fresh params (flax's default initializers): drawn on the CPU
        from ``generator`` so the draw is device independent, then moved
        to the module's device."""
        device = self.sample_input.device
        out = {}
        for name, mod in self.module.named_modules():
            if hasattr(mod, "init_params"):
                for pname, t in mod.init_params(generator).items():
                    out[f"{name}.{pname}"] = t.to(device)
        return {k: out[k] for k, _ in self.module.named_parameters()}

    def apply(self, params: dict, x: torch.Tensor):
        return functional_call(self.module, params, (x,))
