"""ResNet for CIFAR (6n+2), port of ``fedtorch_tpu/models/resnet.py``.

3x3 stem, 16/32/64 planes, three stages of (size-2)//6 blocks;
BasicBlock below depth 44, Bottleneck from 44 up; global average pool
and a float32 linear head (the reference's resnet.py:209-257).

The public ``forward`` takes NHWC batches like the JAX package; inside,
activations are NCHW views of that memory (channels-last strides), the
layout cuDNN's NHWC kernels take. Convs run in the compute dtype
(``float32`` or ``bfloat16``); every norm and the head run in float32.
The convs are XLA code in the JAX package, not Pallas, so they stay
``F.conv2d`` here.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from fedtorch_tpu_torch.models.common import (
    BatchStatsNorm, Conv, Dense, norm_f32, num_classes_of,
)


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, cin: int, planes: int, stride: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.Conv_0 = Conv(cin, planes, 3, stride, 1, dtype)
        self.BatchStatsNorm_0 = BatchStatsNorm(planes)
        self.Conv_1 = Conv(planes, planes, 3, 1, 1, dtype)
        self.BatchStatsNorm_1 = BatchStatsNorm(planes)
        self.shortcut = stride != 1 or cin != planes
        if self.shortcut:
            # 1x1 projection; flax's default 'SAME' padding is 0 here
            self.Conv_2 = Conv(cin, planes, 1, stride, 0, dtype)
            self.BatchStatsNorm_2 = BatchStatsNorm(planes)

    def forward(self, x):
        y = F.relu(norm_f32(self.BatchStatsNorm_0, self.Conv_0(x)))
        y = norm_f32(self.BatchStatsNorm_1, self.Conv_1(y))
        residual = x
        if self.shortcut:
            residual = norm_f32(self.BatchStatsNorm_2, self.Conv_2(x))
        return F.relu(y + residual)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, cin: int, planes: int, stride: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        out_planes = planes * self.expansion
        self.Conv_0 = Conv(cin, planes, 1, 1, 0, dtype)
        self.BatchStatsNorm_0 = BatchStatsNorm(planes)
        self.Conv_1 = Conv(planes, planes, 3, stride, 1, dtype)
        self.BatchStatsNorm_1 = BatchStatsNorm(planes)
        self.Conv_2 = Conv(planes, out_planes, 1, 1, 0, dtype)
        self.BatchStatsNorm_2 = BatchStatsNorm(out_planes)
        self.shortcut = stride != 1 or cin != out_planes
        if self.shortcut:
            self.Conv_3 = Conv(cin, out_planes, 1, stride, 0, dtype)
            self.BatchStatsNorm_3 = BatchStatsNorm(out_planes)

    def forward(self, x):
        y = F.relu(norm_f32(self.BatchStatsNorm_0, self.Conv_0(x)))
        y = F.relu(norm_f32(self.BatchStatsNorm_1, self.Conv_1(y)))
        y = norm_f32(self.BatchStatsNorm_2, self.Conv_2(y))
        residual = x
        if self.shortcut:
            residual = norm_f32(self.BatchStatsNorm_3, self.Conv_3(x))
        return F.relu(y + residual)


class ResNetCifar(nn.Module):
    def __init__(self, dataset: str, size: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if size % 6 != 2:
            raise ValueError(f"resnet_size must be 6n+2, got {size}")
        self.dtype = dtype
        n_blocks = (size - 2) // 6
        block = Bottleneck if size >= 44 else BasicBlock
        self.Conv_0 = Conv(3, 16, 3, 1, 1, dtype)
        self.BatchStatsNorm_0 = BatchStatsNorm(16)
        cin, bi = 16, 0
        for stage, planes in enumerate((16, 32, 64)):
            for i in range(n_blocks):
                stride = 2 if (stage > 0 and i == 0) else 1
                self.add_module(f"{block.__name__}_{bi}",
                                block(cin, planes, stride, dtype))
                cin = planes * block.expansion
                bi += 1
        self.num_blocks = bi
        self.block_name = block.__name__
        self.Dense_0 = Dense(cin, num_classes_of(dataset))

    def forward(self, x):
        """x: [N, H, W, C] -> logits [N, classes] (float32)."""
        x = x.to(self.dtype).permute(0, 3, 1, 2)  # NCHW view of NHWC
        x = F.relu(norm_f32(self.BatchStatsNorm_0, self.Conv_0(x)))
        for bi in range(self.num_blocks):
            x = getattr(self, f"{self.block_name}_{bi}")(x)
        x = x.mean(dim=(2, 3))
        # classifier head in f32 for logit fidelity
        return self.Dense_0(x.to(torch.float32))


def build_resnet(arch: str, dataset: str,
                 dtype: torch.dtype = torch.float32) -> nn.Module:
    """Factory matching resnet.py:260-274 arch-string parsing; only the
    CIFAR-family variant is ported."""
    size = int(arch.replace("resnet", ""))
    if "cifar" in dataset or "svhn" in dataset \
            or "downsampled_imagenet" in dataset or dataset == "stl10":
        return ResNetCifar(dataset, size, dtype)
    raise ValueError(f"resnet on dataset {dataset!r} is not yet ported "
                     "(the port has the CIFAR-family variant)")
