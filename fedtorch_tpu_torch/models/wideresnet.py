"""WideResNet, port of ``fedtorch_tpu/models/wideresnet.py``.

WRN(depth, widen_factor): n = (depth - 4) / 6 blocks per stage, widths
16, 16k, 32k, 64k, pre-activation basic blocks, a float32 norm + ReLU +
global average pool + linear head (Zagoruyko & Komodakis, arXiv:1605.07146;
WRN-28-10 is 36.5 M parameters).

Same idiom as ``models/resnet.py``: the public ``forward`` takes NHWC
batches, activations inside are NCHW views of that memory, convs run in
the compute dtype and every norm in float32. Module names are the flax
names (``Conv_0``, ``_WideBasic_<i>``, norms auto-named
``BatchStatsNorm_0``/``_1`` in call order, ``Dense_0``), so
``bridge.py`` maps the params both ways unchanged. ``norm='gn'`` names
them ``_GN_<i>`` as flax does; ``conv_impl='matmul'`` swaps in the
im2col conv. Dropout between the two convolutions of a block
(``drop_rate > 0``) drops only in a training forward given a mask source
(``drop``, see ``ModelDef.apply``). ``remat`` recomputes each block in
the backward (the JAX package's per-block ``nn.remat``), its dropout
masks replayed (``models/common.py`` ``rematerialized``).
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from fedtorch_tpu_torch.models.common import (
    Dense, Normed, conv_of, dropout, image_shape, norm_f32, num_classes_of,
    rematerialized,
)


class _WideBasic(Normed):
    """Pre-activation block: norm + ReLU on entry; the projection
    shortcut reads that activated tensor, the identity shortcut the raw
    input; dropout between the convolutions; no ReLU after the add."""

    def __init__(self, cin: int, planes: int, stride: int = 1,
                 dtype: torch.dtype = torch.float32, drop_rate: float = 0.0,
                 norm: str = "bn", conv_impl: str = "conv"):
        super().__init__(norm)
        Conv = conv_of(conv_impl)
        self.add_norm(0, cin)
        self.Conv_0 = Conv(cin, planes, 3, stride, 1, dtype)
        self.add_norm(1, planes)
        self.Conv_1 = Conv(planes, planes, 3, 1, 1, dtype)
        self.projection = stride != 1 or cin != planes
        if self.projection:
            # 1x1 projection; flax's default 'SAME' padding is 0 here
            self.Conv_2 = Conv(cin, planes, 1, stride, 0, dtype)
        self.drop_rate = drop_rate

    def forward(self, x, drop=None):
        y = F.relu(norm_f32(self.nrm(0), x))
        shortcut = self.Conv_2(y) if self.projection else x
        y = self.Conv_0(y)
        y = F.relu(norm_f32(self.nrm(1), y))
        y = self.Conv_1(dropout(y, self.drop_rate, drop))
        return y + shortcut.to(y.dtype)


class WideResNet(Normed):
    def __init__(self, dataset: str, depth: int = 28, widen_factor: int = 4,
                 dtype: torch.dtype = torch.float32, drop_rate: float = 0.0,
                 norm: str = "bn", conv_impl: str = "conv",
                 remat: bool = False):
        super().__init__(norm)
        if (depth - 4) % 6 != 0:
            raise ValueError("wideresnet depth must be 6n+4")
        self.dtype, self.remat = dtype, remat
        n = (depth - 4) // 6
        k = widen_factor
        cin = 16
        self.Conv_0 = conv_of(conv_impl)(image_shape(dataset)[-1], cin, 3,
                                         1, 1, dtype)
        bi = 0
        for stage, planes in enumerate((16 * k, 32 * k, 64 * k)):
            for i in range(n):
                stride = 2 if (stage > 0 and i == 0) else 1
                self.add_module(f"_WideBasic_{bi}", _WideBasic(
                    cin, planes, stride, dtype, drop_rate, norm, conv_impl))
                cin = planes
                bi += 1
        self.num_blocks = bi
        self.add_norm(0, cin)
        self.Dense_0 = Dense(cin, num_classes_of(dataset))

    def forward(self, x, drop=None):
        """x: [N, H, W, C] -> logits [N, classes] (float32); ``drop``
        the keep-mask source of a training forward."""
        x = x.to(self.dtype).permute(0, 3, 1, 2)  # NCHW view of NHWC
        x = self.Conv_0(x)
        for bi in range(self.num_blocks):
            block = getattr(self, f"_WideBasic_{bi}")
            x = rematerialized(block, x, drop) if self.remat \
                else block(x, drop)
        # the head stays in float32, with no cast back
        x = F.relu(self.nrm(0)(x.to(torch.float32)))
        return self.Dense_0(x.mean(dim=(2, 3)))


def build_wideresnet(arch: str, dataset: str, widen_factor: int,
                     dtype: torch.dtype = torch.float32,
                     drop_rate: float = 0.0, norm: str = "bn",
                     conv_impl: str = "conv",
                     remat: bool = False) -> nn.Module:
    """arch string 'wideresnet<depth>' (wideresnet.py:89-98)."""
    depth = int(arch.replace("wideresnet", ""))
    return WideResNet(dataset, depth, widen_factor, dtype, drop_rate, norm,
                      conv_impl, remat)
