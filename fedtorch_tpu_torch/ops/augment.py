"""Image augmentation (port of ``augment_image_batch`` in
``fedtorch_tpu/ops/augment.py``): random horizontal flip plus
pad-4-and-crop per sample, the reference's CIFAR train transform
(prepare_data.py:29-35), applied on the device inside the local loop.

Split in two so tests can inject the JAX package's draws: a plain
function of the draws (:func:`augment_image_batch`) and a drawer on a
``torch.Generator`` (:func:`draw_augment`).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def draw_augment(generator: torch.Generator, shape, pad: int = 4):
    """Per-sample draws for :func:`augment_image_batch`, CPU tensors of
    ``shape`` (e.g. ``[k, K, B]``): flip ~ Bernoulli(0.5), crop offsets
    top/left ~ U{0..2*pad}."""
    flip = torch.rand(shape, generator=generator) < 0.5
    tops = torch.randint(0, 2 * pad + 1, shape, generator=generator)
    lefts = torch.randint(0, 2 * pad + 1, shape, generator=generator)
    return flip, tops, lefts


def augment_image_batch(x: torch.Tensor, flip: torch.Tensor,
                        tops: torch.Tensor, lefts: torch.Tensor,
                        pad: int = 4) -> torch.Tensor:
    """Flip then zero-pad and crop, per sample. x: [B, H, W, C] (NHWC);
    flip [B] bool, tops/lefts [B] ints in [0, 2*pad]."""
    b, h, w, _ = x.shape
    x = torch.where(flip.view(b, 1, 1, 1), x.flip(2), x)
    xp = F.pad(x, (0, 0, pad, pad, pad, pad))  # pads W, then H
    rows = tops.view(b, 1) + torch.arange(h, device=x.device)
    cols = lefts.view(b, 1) + torch.arange(w, device=x.device)
    bidx = torch.arange(b, device=x.device).view(b, 1, 1)
    return xp[bidx, rows.view(b, h, 1), cols.view(b, 1, w)]
