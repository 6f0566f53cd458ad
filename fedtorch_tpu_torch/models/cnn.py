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
``F.conv2d`` here. The client-fused ``FusedCNN`` is not ported.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from fedtorch_tpu_torch.models.common import Dense, conv_of, num_classes_of


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
        # two VALID 5x5 convs, each followed by a 2x2 pool
        flat = ((h - 4) // 2 - 4) // 2 * (((w - 4) // 2 - 4) // 2) * 50
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
