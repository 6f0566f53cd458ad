"""Adaptive affine quantization, plain PyTorch (port of
``fedtorch_tpu/ops/quantize.py`` — the reference's
``flow_utils.py:169-212`` ``quantize_tensor`` / ``dequantize_tensor``).

The readable reference of the scheme the Hopper kernel
(``ops/cuda/quant_kernel.py``) fuses:

* symmetric integer range ``[-2^(b-1), 2^(b-1)-1]``;
* ``scale = (max-min)/(qmax-qmin)`` with a 0.001 floor when the tensor
  is constant, a zero point clipped into the integer range and truncated
  toward zero, centered on the mean;
* dequantize: ``scale*(q - zero_point) + mean``.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch


class QuantInfo(NamedTuple):
    """The [scale, zero_point, mean] triple sent beside the payload."""
    scale: torch.Tensor
    zero_point: torch.Tensor
    mean: torch.Tensor


def _int_dtype(num_bits: int):
    if num_bits == 8:
        return torch.int8
    if num_bits == 16:
        return torch.int16
    raise ValueError(f"Unsupported quantization bits: {num_bits}")


def quantize(x: torch.Tensor,
             num_bits: int = 8) -> Tuple[torch.Tensor, QuantInfo]:
    """Adaptive affine quantization of ``x``: (int payload, QuantInfo)."""
    qmin = -(2.0 ** (num_bits - 1))
    qmax = 2.0 ** (num_bits - 1) - 1.0
    mn, mx, mean = x.min(), x.max(), x.mean()
    scale = (mx - mn) / (qmax - qmin)
    scale = torch.where(scale == 0.0, 0.001, scale)
    zero_point = torch.trunc(torch.clamp(qmin - (mn - mean) / scale,
                                         qmin, qmax))
    q = torch.clamp(torch.round(zero_point + (x - mean) / scale),
                    qmin, qmax).to(_int_dtype(num_bits))
    return q, QuantInfo(scale=scale, zero_point=zero_point, mean=mean)


def dequantize(q: torch.Tensor, info: QuantInfo) -> torch.Tensor:
    """Inverse transform (flow_utils.py:208-212)."""
    return info.scale * (q.to(torch.float32) - info.zero_point) + info.mean


def quantize_dequantize(x: torch.Tensor, num_bits: int = 8) -> torch.Tensor:
    """Round-trip, i.e. the value the receiver reconstructs."""
    q, info = quantize(x, num_bits)
    return dequantize(q, info)
