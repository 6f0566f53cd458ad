"""LeNet-style CNN (port of ``fedtorch_tpu/models/cnn.py``; ref:
nonconvex/cnn.py:9-69).

conv(20, 5x5, valid, bias) -> ReLU -> 2x2 max pool -> conv(50, 5x5,
valid, bias) -> ReLU -> 2x2 max pool -> fc 512 -> ReLU -> fc classes.
The convs and ``Dense_0`` run in the compute dtype, the head in float32.
The public ``forward`` takes NHWC batches like the JAX package; inside,
activations are NCHW views of that memory, as in ``resnet.py``.

The JAX model flattens its NHWC activations in (H, W, C) order, so the
port flattens the channels-last view in that order too: ``Dense_0``'s
bridged weight then multiplies the features it was trained on. The
convs are XLA code in the JAX package, not Pallas, so they stay
``F.conv2d`` here. :class:`FusedCNN` is the client-fused variant
(``cfg.mesh.client_fusion='fused'``): the k online clients' stacked
batches through grouped convs and batched dense layers, with the stacked
``CNN`` params.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from fedtorch_tpu_torch.models.common import (
    Dense, FusedConv, FusedDense, conv_of, fused_max_pool, num_classes_of,
    pack_clients,
)


def _flat_features(h: int, w: int) -> int:
    """The flattened width after two VALID 5x5 convs, each followed by a
    2x2 pool, at 50 channels."""
    return ((h - 4) // 2 - 4) // 2 * (((w - 4) // 2 - 4) // 2) * 50


class CNN(nn.Module):
    def __init__(self, dataset: str, in_shape,
                 dtype: torch.dtype = torch.float32, conv_impl: str = "conv"):
        """``in_shape``: the NHWC sample shape (H, W, C); ``conv_impl``
        'matmul' takes the im2col conv (same params)."""
        super().__init__()
        h, w, c = in_shape
        Conv = conv_of(conv_impl)
        self.Conv_0 = Conv(c, 20, 5, dtype=dtype, bias=True)
        self.Conv_1 = Conv(20, 50, 5, dtype=dtype, bias=True)
        flat = _flat_features(h, w)
        self.Dense_0 = Dense(flat, 512, dtype=dtype)
        self.Dense_1 = Dense(512, num_classes_of(dataset))
        self.dtype = dtype

    def forward(self, x):
        """x: [N, H, W, C] -> logits [N, classes] (float32)."""
        x = x.to(self.dtype).permute(0, 3, 1, 2)  # NCHW view of NHWC
        x = F.max_pool2d(F.relu(self.Conv_0(x)), 2)
        x = F.max_pool2d(F.relu(self.Conv_1(x)), 2)
        # flatten in the JAX package's (H, W, C) order
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        x = F.relu(self.Dense_0(x))
        return self.Dense_1(x.to(torch.float32))


class FusedCNN(nn.Module):
    """Client-fused :class:`CNN`: ``[k, B, H, W, C]`` stacked inputs ->
    ``[k, B, classes]`` logits, each conv one grouped convolution over
    the clients' packed channels (``models/common.py`` "client-fused
    layers"), with the stacked ``CNN`` params."""

    def __init__(self, dataset: str, in_shape, num_clients: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        h, w, c = in_shape
        k = num_clients
        self.Conv_0 = FusedConv(k, c, 20, 5, dtype=dtype, bias=True)
        self.Conv_1 = FusedConv(k, 20, 50, 5, dtype=dtype, bias=True)
        self.Dense_0 = FusedDense(k, _flat_features(h, w), 512, dtype=dtype)
        self.Dense_1 = FusedDense(k, 512, num_classes_of(dataset))
        self.dtype, self.num_clients = dtype, k

    def forward(self, x):
        """x: [k, B, H, W, C] -> logits [k, B, classes] (float32)."""
        k = self.num_clients
        x = pack_clients(x.to(self.dtype))
        x = fused_max_pool(F.relu(self.Conv_0(x)), 2, 2)
        x = fused_max_pool(F.relu(self.Conv_1(x)), 2, 2)
        # each client flattened in the per-client (H, W, C) order
        B, _, h, w = x.shape
        x = x.permute(0, 2, 3, 1).reshape(B, h, w, k, -1).permute(
            0, 3, 1, 2, 4).reshape(B, k, -1)
        x = F.relu(self.Dense_0(x))
        return self.Dense_1(x.to(torch.float32)).transpose(0, 1)
