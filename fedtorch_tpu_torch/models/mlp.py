"""MLP and robust MLP (port of ``fedtorch_tpu/models/mlp.py``; ref:
nonconvex/mlp.py:8-64, robust_mlp.py:9-65).

``num_layers`` x [Dense -> norm (batch statistics or GroupNorm, computed
in float32) -> ReLU -> dropout] on the flattened input, then a bias-free
float32 head. ``robust`` (``robust_mlp``) adds the learnable input noise
``noise`` to the flattened input (robust_mlp.py:54); dropout drops only
in a training forward given a mask source (``drop``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from fedtorch_tpu_torch.models.common import (
    Dense, Normed, dropout, norm_f32, num_classes_of,
)
from fedtorch_tpu_torch.models.linear import NoiseInput


class MLP(Normed, NoiseInput):
    def __init__(self, dataset: str, in_features: int, num_layers: int = 2,
                 hidden_size: int = 500, dtype: torch.dtype = torch.float32,
                 drop_rate: float = 0.0, norm: str = "bn",
                 robust: bool = False):
        super().__init__(norm)
        if robust:
            self.add_noise(in_features)
        self.num_layers = num_layers
        for i in range(num_layers):
            setattr(self, f"layer{i + 1}",
                    Dense(in_features if i == 0 else hidden_size,
                          hidden_size, dtype=dtype))
            self.add_norm(i, hidden_size)
        self.fc = Dense(hidden_size, num_classes_of(dataset), bias=False)
        self.dtype, self.drop_rate = dtype, drop_rate

    def forward(self, x, drop=None):
        x = self.noisy(x.reshape(x.shape[0], -1))
        for i in range(self.num_layers):
            x = getattr(self, f"layer{i + 1}")(x.to(self.dtype))
            x = F.relu(norm_f32(self.nrm(i), x))
            x = dropout(x, self.drop_rate, drop)
        return self.fc(x.to(torch.float32))
