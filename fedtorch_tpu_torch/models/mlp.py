"""MLP (port of ``fedtorch_tpu/models/mlp.py``; ref: nonconvex/mlp.py).

``num_layers`` x [Dense -> BatchStatsNorm (batch statistics, computed in
float32) -> ReLU] on the flattened input, then a bias-free float32 head.
Dropout (``drop_rate > 0``) and the ``robust_mlp`` input noise are not
ported; ``define_model`` refuses both.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from fedtorch_tpu_torch.models.common import (
    BatchStatsNorm, Dense, norm_f32, num_classes_of,
)


class MLP(nn.Module):
    def __init__(self, dataset: str, in_features: int, num_layers: int = 2,
                 hidden_size: int = 500, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_layers = num_layers
        for i in range(num_layers):
            setattr(self, f"layer{i + 1}",
                    Dense(in_features if i == 0 else hidden_size,
                          hidden_size, dtype=dtype))
            setattr(self, f"BatchStatsNorm_{i}", BatchStatsNorm(hidden_size))
        self.fc = Dense(hidden_size, num_classes_of(dataset), bias=False)
        self.dtype = dtype

    def forward(self, x):
        x = x.reshape(x.shape[0], -1)
        for i in range(self.num_layers):
            x = getattr(self, f"layer{i + 1}")(x.to(self.dtype))
            x = F.relu(norm_f32(getattr(self, f"BatchStatsNorm_{i}"), x))
        return self.fc(x.to(torch.float32))
