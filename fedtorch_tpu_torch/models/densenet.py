"""DenseNet with optional BC mode, port of ``fedtorch_tpu/models/densenet.py``
(ref: nonconvex/densenet.py, factory :200-208).

DenseNet(depth, growth_rate, bc_mode, compression): a 3x3 stem conv,
three dense blocks of [norm -> ReLU -> (BC: 1x1 bottleneck to
4 x growth -> norm -> ReLU) -> 3x3 conv to growth -> dropout] layers
whose outputs are concatenated onto their inputs, two transitions
[norm -> ReLU -> 1x1 conv to ``compression`` x the channels -> 2x2
average pool], then a float32 norm, ReLU, global average pool and the
linear head. (depth - 4) / 3 layers a block, half as many in BC mode;
compression applies only in BC mode (Huang et al., CVPR 2017: the CIFAR
DenseNet-BC-100 with growth 12 and compression 0.5 is 769,162 params).

Same idiom as ``models/resnet.py``: NHWC in, NCHW views inside, convs
in the compute dtype, every norm in float32; module names are flax's
(``Conv_0``, ``_DenseLayer_<i>``, the transitions' ``Conv_1``/``Conv_2``,
norms auto-named per parent in call order, ``Dense_0``). Inside a dense
layer the 3x3 conv is ``Conv_1`` after a bottleneck and ``Conv_0``
without one, as flax auto-names them. ``remat`` recomputes each dense
layer in the backward (the JAX package's per-layer ``nn.remat``), its
dropout masks replayed (``models/common.py`` ``rematerialized``).
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from fedtorch_tpu_torch.models.common import (
    Dense, Normed, conv_of, dropout, image_shape, norm_f32, num_classes_of,
    rematerialized,
)


class _DenseLayer(Normed):
    def __init__(self, cin: int, growth_rate: int, bc_mode: bool,
                 drop_rate: float, norm: str, dtype: torch.dtype,
                 conv_impl: str):
        super().__init__(norm)
        Conv = conv_of(conv_impl)
        self.add_norm(0, cin)
        self.bc_mode = bc_mode
        if bc_mode:
            self.Conv_0 = Conv(cin, 4 * growth_rate, 1, 1, 0, dtype)
            self.add_norm(1, 4 * growth_rate)
            self.Conv_1 = Conv(4 * growth_rate, growth_rate, 3, 1, 1, dtype)
        else:
            self.Conv_0 = Conv(cin, growth_rate, 3, 1, 1, dtype)
        self.drop_rate, self.dtype = drop_rate, dtype

    def forward(self, x, drop=None):
        y = F.relu(norm_f32(self.nrm(0), x))
        if self.bc_mode:
            y = F.relu(norm_f32(self.nrm(1), self.Conv_0(y)))
            y = self.Conv_1(y)
        else:
            y = self.Conv_0(y)
        y = dropout(y, self.drop_rate, drop)
        return torch.cat([x.to(self.dtype), y], dim=1)


class DenseNet(Normed):
    def __init__(self, dataset: str, depth: int = 40, growth_rate: int = 12,
                 bc_mode: bool = False, compression: float = 1.0,
                 drop_rate: float = 0.0, norm: str = "bn",
                 dtype: torch.dtype = torch.float32, conv_impl: str = "conv",
                 remat: bool = False):
        super().__init__(norm)
        Conv = conv_of(conv_impl)
        layers_per_block = (depth - 4) // 3
        if bc_mode:
            layers_per_block //= 2
        ch = 2 * growth_rate if bc_mode else 16
        self.dtype, self.remat = dtype, remat
        self.Conv_0 = Conv(image_shape(dataset)[-1], ch, 3, 1, 1, dtype)
        li = 0
        for block in range(3):
            for _ in range(layers_per_block):
                self.add_module(f"_DenseLayer_{li}", _DenseLayer(
                    ch, growth_rate, bc_mode, drop_rate, norm, dtype,
                    conv_impl))
                ch += growth_rate
                li += 1
            if block < 2:
                out_ch = int(ch * compression)
                self.add_norm(block, ch)
                self.add_module(f"Conv_{block + 1}",
                                Conv(ch, out_ch, 1, 1, 0, dtype))
                ch = out_ch
        self.num_layers, self.layers_per_block = li, layers_per_block
        self.add_norm(2, ch)
        self.Dense_0 = Dense(ch, num_classes_of(dataset))

    def forward(self, x, drop=None):
        """x: [N, H, W, C] -> logits [N, classes] (float32); ``drop``
        the keep-mask source of a training forward."""
        x = self.Conv_0(x.to(self.dtype).permute(0, 3, 1, 2))
        for li in range(self.num_layers):
            layer = getattr(self, f"_DenseLayer_{li}")
            x = rematerialized(layer, x, drop) if self.remat \
                else layer(x, drop)
            block, last = divmod(li + 1, self.layers_per_block)
            if last == 0 and block < 3:  # a transition after blocks 1, 2
                x = F.relu(norm_f32(self.nrm(block - 1), x))
                x = getattr(self, f"Conv_{block}")(x)
                x = F.avg_pool2d(x, 2, stride=2)
        # the head stays in float32, with no cast back
        x = F.relu(self.nrm(2)(x.to(torch.float32)))
        return self.Dense_0(x.mean(dim=(2, 3)))


def build_densenet(arch: str, dataset: str, growth_rate: int, bc_mode: bool,
                   compression: float, drop_rate: float, norm: str = "bn",
                   dtype: torch.dtype = torch.float32,
                   conv_impl: str = "conv", remat: bool = False) -> nn.Module:
    """arch string 'densenet<depth>' (factory densenet.py:200-208)."""
    depth = int(arch.replace("densenet", ""))
    return DenseNet(dataset, depth, growth_rate, bc_mode,
                    compression if bc_mode else 1.0, drop_rate, norm, dtype,
                    conv_impl, remat)
