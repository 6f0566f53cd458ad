"""ResNet for CIFAR (6n+2) and ImageNet depths, port of
``fedtorch_tpu/models/resnet.py``.

* CIFAR variant (the reference's resnet.py:209-257): 3x3 stem, 16/32/64
  planes, three stages of (size-2)//6 blocks; BasicBlock below depth
  44, Bottleneck from 44 up; global average pool and a float32 linear
  head.
* ImageNet variant (resnet.py:145-206): 7x7/2 stem and a 3x3/2 max
  pool, 64/128/256/512 planes, depths 18/34/50/101/152 (ResNet-18 is
  11,689,512 params). The JAX package's ``define_model`` cannot reach
  it (its ``image_shape`` has no ImageNet entry); neither can the
  port's: build the class, or :func:`build_resnet` on an
  ``imagenet`` dataset.

The public ``forward`` takes NHWC batches like the JAX package; inside,
activations are NCHW views of that memory (channels-last strides), the
layout cuDNN's NHWC kernels take. Convs run in the compute dtype
(``float32`` or ``bfloat16``); every norm and the head run in float32.
``norm`` is 'bn' (batch statistics) or 'gn' (GroupNorm), named as flax
auto-names them; ``conv_impl`` 'matmul' swaps in the im2col conv with
the same params. The convs are XLA code in the JAX package, not Pallas,
so they stay torch ops here. ``remat`` recomputes each residual block in
the backward instead of keeping its activations (the JAX package's
per-block ``nn.remat``; ``models/common.py`` ``rematerialized``): same
params, same outputs and gradients.

The client-fused variant (``cfg.mesh.client_fusion='fused'``):
:class:`FusedResNetCifar` maps the k online clients' stacked ``[k, B, H,
W, C]`` batches to ``[k, B, classes]`` logits, every conv one grouped
convolution over the clients' packed channels (``models/common.py``
"client-fused layers"); its blocks are named without the ``Fused``
prefix, so its params are the stacked ``ResNetCifar`` params.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from fedtorch_tpu_torch.models.common import (
    Dense, FusedConv, FusedDense, FusedNormed, Normed, conv_of, norm_f32,
    num_classes_of, pack_clients, rematerialized,
)


class BasicBlock(Normed):
    expansion = 1

    def __init__(self, cin: int, planes: int, stride: int = 1,
                 dtype: torch.dtype = torch.float32, norm: str = "bn",
                 conv_impl: str = "conv"):
        super().__init__(norm)
        Conv = conv_of(conv_impl)
        self.Conv_0 = Conv(cin, planes, 3, stride, 1, dtype)
        self.add_norm(0, planes)
        self.Conv_1 = Conv(planes, planes, 3, 1, 1, dtype)
        self.add_norm(1, planes)
        self.shortcut = stride != 1 or cin != planes
        if self.shortcut:
            # 1x1 projection; flax's default 'SAME' padding is 0 here
            self.Conv_2 = Conv(cin, planes, 1, stride, 0, dtype)
            self.add_norm(2, planes)

    def forward(self, x):
        y = F.relu(norm_f32(self.nrm(0), self.Conv_0(x)))
        y = norm_f32(self.nrm(1), self.Conv_1(y))
        residual = x
        if self.shortcut:
            residual = norm_f32(self.nrm(2), self.Conv_2(x))
        return F.relu(y + residual)


class Bottleneck(Normed):
    expansion = 4

    def __init__(self, cin: int, planes: int, stride: int = 1,
                 dtype: torch.dtype = torch.float32, norm: str = "bn",
                 conv_impl: str = "conv"):
        super().__init__(norm)
        Conv = conv_of(conv_impl)
        out_planes = planes * self.expansion
        self.Conv_0 = Conv(cin, planes, 1, 1, 0, dtype)
        self.add_norm(0, planes)
        self.Conv_1 = Conv(planes, planes, 3, stride, 1, dtype)
        self.add_norm(1, planes)
        self.Conv_2 = Conv(planes, out_planes, 1, 1, 0, dtype)
        self.add_norm(2, out_planes)
        self.shortcut = stride != 1 or cin != out_planes
        if self.shortcut:
            self.Conv_3 = Conv(cin, out_planes, 1, stride, 0, dtype)
            self.add_norm(3, out_planes)

    def forward(self, x):
        y = F.relu(norm_f32(self.nrm(0), self.Conv_0(x)))
        y = F.relu(norm_f32(self.nrm(1), self.Conv_1(y)))
        y = norm_f32(self.nrm(2), self.Conv_2(y))
        residual = x
        if self.shortcut:
            residual = norm_f32(self.nrm(3), self.Conv_3(x))
        return F.relu(y + residual)


class _ResNet(Normed):
    """The stem-blocks-head skeleton both variants share."""

    def _add_blocks(self, block, stages, cin: int, dtype, conv_impl: str):
        bi = 0
        for stage, (planes, n_blocks) in enumerate(stages):
            for i in range(n_blocks):
                stride = 2 if (stage > 0 and i == 0) else 1
                self.add_module(f"{block.__name__}_{bi}",
                                block(cin, planes, stride, dtype,
                                      self.norm, conv_impl))
                cin = planes * block.expansion
                bi += 1
        self.num_blocks = bi
        self.block_name = block.__name__
        return cin

    def _blocks(self, x):
        for bi in range(self.num_blocks):
            block = getattr(self, f"{self.block_name}_{bi}")
            x = rematerialized(block, x) if self.remat else block(x)
        return x

    def _blocks_and_head(self, x):
        x = self._blocks(x).mean(dim=(2, 3))
        # classifier head in f32 for logit fidelity
        return self.Dense_0(x.to(torch.float32))


class ResNetCifar(_ResNet):
    def __init__(self, dataset: str, size: int,
                 dtype: torch.dtype = torch.float32, norm: str = "bn",
                 conv_impl: str = "conv", remat: bool = False):
        super().__init__(norm)
        if size % 6 != 2:
            raise ValueError(f"resnet_size must be 6n+2, got {size}")
        self.dtype, self.remat = dtype, remat
        n_blocks = (size - 2) // 6
        block = Bottleneck if size >= 44 else BasicBlock
        self.Conv_0 = conv_of(conv_impl)(3, 16, 3, 1, 1, dtype)
        self.add_norm(0, 16)
        cin = self._add_blocks(block, [(p, n_blocks) for p in (16, 32, 64)],
                               16, dtype, conv_impl)
        self.Dense_0 = Dense(cin, num_classes_of(dataset))

    def forward(self, x):
        """x: [N, H, W, C] -> logits [N, classes] (float32)."""
        x = x.to(self.dtype).permute(0, 3, 1, 2)  # NCHW view of NHWC
        x = F.relu(norm_f32(self.nrm(0), self.Conv_0(x)))
        return self._blocks_and_head(x)


class ResNetImageNet(_ResNet):
    _PARAMS = {
        18: (BasicBlock, (2, 2, 2, 2)),
        34: (BasicBlock, (3, 4, 6, 3)),
        50: (Bottleneck, (3, 4, 6, 3)),
        101: (Bottleneck, (3, 4, 23, 3)),
        152: (Bottleneck, (3, 8, 36, 3)),
    }

    def __init__(self, dataset: str, size: int,
                 dtype: torch.dtype = torch.float32, norm: str = "bn",
                 conv_impl: str = "conv", remat: bool = False):
        super().__init__(norm)
        self.dtype, self.remat = dtype, remat
        block, layers = self._PARAMS[size]
        self.Conv_0 = conv_of(conv_impl)(3, 64, 7, 2, 3, dtype)
        self.add_norm(0, 64)
        cin = self._add_blocks(block, list(zip((64, 128, 256, 512), layers)),
                               64, dtype, conv_impl)
        self.Dense_0 = Dense(cin, num_classes_of(dataset))

    def forward(self, x):
        """x: [N, H, W, 3] -> logits [N, classes] (float32)."""
        x = x.to(self.dtype).permute(0, 3, 1, 2)  # NCHW view of NHWC
        x = F.relu(norm_f32(self.nrm(0), self.Conv_0(x)))
        # flax's max_pool pads with -inf, as max_pool2d does
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        return self._blocks_and_head(x)


def _cifar_family(dataset: str) -> bool:
    return "cifar" in dataset or "svhn" in dataset \
        or "downsampled_imagenet" in dataset or dataset == "stl10"


def build_resnet(arch: str, dataset: str, dtype: torch.dtype = torch.float32,
                 norm: str = "bn", conv_impl: str = "conv",
                 remat: bool = False) -> nn.Module:
    """Factory matching resnet.py:260-274 arch-string parsing: the CIFAR
    variant for the CIFAR family, the ImageNet one for ``imagenet``
    datasets."""
    size = int(arch.replace("resnet", ""))
    if _cifar_family(dataset):
        return ResNetCifar(dataset, size, dtype, norm, conv_impl, remat)
    if "imagenet" in dataset:
        return ResNetImageNet(dataset, size, dtype, norm, conv_impl, remat)
    raise ValueError(f"resnet on dataset {dataset!r} is not yet ported "
                     "(the JAX package has the cifar and imagenet "
                     "families)")


# -- client-fused variants (cfg.mesh.client_fusion='fused') ----------------


class FusedBasicBlock(FusedNormed):
    """:class:`BasicBlock` on client-packed activations: the same forward
    over grouped convs and per-client norms."""
    expansion = 1
    forward = BasicBlock.forward

    def __init__(self, num_clients: int, cin: int, planes: int,
                 stride: int = 1, dtype: torch.dtype = torch.float32,
                 norm: str = "bn"):
        super().__init__(num_clients, norm)
        k = num_clients
        self.Conv_0 = FusedConv(k, cin, planes, 3, stride, 1, dtype)
        self.add_norm(0, planes)
        self.Conv_1 = FusedConv(k, planes, planes, 3, 1, 1, dtype)
        self.add_norm(1, planes)
        self.shortcut = stride != 1 or cin != planes
        if self.shortcut:
            self.Conv_2 = FusedConv(k, cin, planes, 1, stride, 0, dtype)
            self.add_norm(2, planes)


class FusedBottleneck(FusedNormed):
    """:class:`Bottleneck` on client-packed activations."""
    expansion = 4
    forward = Bottleneck.forward

    def __init__(self, num_clients: int, cin: int, planes: int,
                 stride: int = 1, dtype: torch.dtype = torch.float32,
                 norm: str = "bn"):
        super().__init__(num_clients, norm)
        k = num_clients
        out_planes = planes * self.expansion
        self.Conv_0 = FusedConv(k, cin, planes, 1, 1, 0, dtype)
        self.add_norm(0, planes)
        self.Conv_1 = FusedConv(k, planes, planes, 3, stride, 1, dtype)
        self.add_norm(1, planes)
        self.Conv_2 = FusedConv(k, planes, out_planes, 1, 1, 0, dtype)
        self.add_norm(2, out_planes)
        self.shortcut = stride != 1 or cin != out_planes
        if self.shortcut:
            self.Conv_3 = FusedConv(k, cin, out_planes, 1, stride, 0, dtype)
            self.add_norm(3, out_planes)


class FusedResNetCifar(FusedNormed):
    """Client-fused :class:`ResNetCifar`: ``[k, B, H, W, C]`` stacked
    inputs -> ``[k, B, classes]`` logits. Its params are the stacked
    ``ResNetCifar`` params (``BasicBlock_<i>``/``Bottleneck_<i>``
    blocks)."""

    _blocks = _ResNet._blocks

    def __init__(self, dataset: str, size: int, num_clients: int,
                 dtype: torch.dtype = torch.float32, norm: str = "bn",
                 remat: bool = False):
        super().__init__(num_clients, norm)
        if size % 6 != 2:
            raise ValueError(f"resnet_size must be 6n+2, got {size}")
        self.dtype, self.remat = dtype, remat
        k = num_clients
        n_blocks = (size - 2) // 6
        block = FusedBottleneck if size >= 44 else FusedBasicBlock
        self.Conv_0 = FusedConv(k, 3, 16, 3, 1, 1, dtype)
        self.add_norm(0, 16)
        cin, bi = 16, 0
        # the per-client names: BasicBlock_<i> / Bottleneck_<i>
        self.block_name = block.__name__.replace("Fused", "")
        for stage, planes in enumerate((16, 32, 64)):
            for i in range(n_blocks):
                stride = 2 if (stage > 0 and i == 0) else 1
                self.add_module(f"{self.block_name}_{bi}",
                                block(k, cin, planes, stride, dtype, norm))
                cin = planes * block.expansion
                bi += 1
        self.num_blocks = bi
        self.Dense_0 = FusedDense(k, cin, num_classes_of(dataset))

    def forward(self, x):
        """x: [k, B, H, W, C] -> logits [k, B, classes] (float32)."""
        k, B = x.shape[:2]
        x = pack_clients(x.to(self.dtype))
        x = F.relu(norm_f32(self.nrm(0), self.Conv_0(x)))
        x = self._blocks(x).mean(dim=(2, 3)).reshape(B, k, -1)
        # classifier head in f32 for logit fidelity
        return self.Dense_0(x.to(torch.float32)).transpose(0, 1)


def build_fused_resnet(arch: str, dataset: str, num_clients: int,
                       norm: str = "bn", dtype: torch.dtype = torch.float32,
                       remat: bool = False):
    """Client-fused counterpart of :func:`build_resnet`: None where no
    fused form exists (the ImageNet variant, a norm other than 'bn'), and
    the fusion gate then keeps the per-client execution."""
    if norm != "bn":
        return None
    size = int(arch.replace("resnet", ""))
    if _cifar_family(dataset):
        return FusedResNetCifar(dataset, size, num_clients, dtype, norm,
                                remat)
    return None
