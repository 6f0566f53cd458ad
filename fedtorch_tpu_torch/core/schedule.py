"""LR schedule compiler (port of ``fedtorch_tpu/core/schedule.py``).

The reference's scheme compiler (``optimizers/learning.py``) compiles
``strict`` / ``custom_one_cycle`` / ``custom_multistep`` /
``custom_convex_decay`` into piecewise epoch-indexed fields, each scaled
``linear`` / ``poly`` / ``convex``. The compiled schedule is a tuple of
tensors evaluated with tensor ops, so the LR at a client's (device)
fractional epoch never leaves the device.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from fedtorch_tpu_torch.config import LRConfig, OptimConfig

_LINEAR, _POLY, _CONVEX = 0, 1, 2
_KIND_NAMES = {"0": _LINEAR, "1": _POLY, "2": _CONVEX}


class LRSchedule(NamedTuple):
    """Compiled piecewise schedule; all fields are tensors of shape [F]."""
    starts: torch.Tensor
    ends: torch.Tensor
    kinds: torch.Tensor     # int: 0 linear, 1 poly, 2 convex
    lr_left: torch.Tensor
    lr_right: torch.Tensor
    gamma: torch.Tensor     # convex-scale gamma/(mu*(alpha+t))
    mu: torch.Tensor
    alpha: torch.Tensor

    def to(self, device) -> "LRSchedule":
        return LRSchedule(*(t.to(device) for t in self))


def lr_at(sched: LRSchedule, epoch) -> torch.Tensor:
    """The schedule at a fractional epoch (0-d tensor or float)."""
    epoch = torch.as_tensor(epoch, dtype=torch.float32,
                            device=sched.starts.device)
    n_steps = torch.clamp(sched.ends - sched.starts, min=1e-8)
    t = epoch - sched.starts
    linear = sched.lr_left + t * (sched.lr_right - sched.lr_left) / n_steps
    poly = sched.lr_left * torch.square(1.0 - t / n_steps)
    convex = sched.gamma / (sched.mu * (sched.alpha + epoch))
    per_field = torch.where(sched.kinds == _LINEAR, linear,
                            torch.where(sched.kinds == _POLY, poly, convex))
    # fall_in: left <= e < right; epochs past the last edge saturate into
    # the final field; the FIRST matching field wins (learning.py:62-70)
    n = sched.starts.shape[0]
    last = torch.arange(n, device=epoch.device) == n - 1
    in_field = ((sched.starts <= epoch) & (epoch < sched.ends)) \
        | (last & (epoch >= sched.ends[-1]))
    return per_field[torch.argmax(in_field.to(torch.int32))]


def _parse_fields(lr_fields: str):
    return [tuple(float(x) for x in f.split(","))
            for f in lr_fields.split("/")]


def _parse_epochs(lr_change_epochs: str):
    edges = [int(x) for x in lr_change_epochs.split(",")]
    return list(zip(edges[:-1], edges[1:]))


def _scaled_init_lr(lr: float, cfg: LRConfig, world_size: int) -> float:
    """LR scale-up rules (components/scheduler.py:40-55)."""
    if not cfg.scaleup:
        return lr
    if cfg.scaleup_factor is not None:
        factor = cfg.scaleup_factor
    elif cfg.scaleup_type == "sqrt":
        factor = float(np.sqrt(world_size))
    else:  # 'linear'
        factor = float(world_size)
    return lr * factor


def compile_schedule(lr_cfg: LRConfig, optim_cfg: OptimConfig,
                     num_epochs: int, world_size: int = 1) -> LRSchedule:
    """Compile config into an :class:`LRSchedule` (on the CPU; move it
    with :meth:`LRSchedule.to`). ``None`` scheme = constant LR."""
    base_lr = _scaled_init_lr(optim_cfg.lr, lr_cfg, world_size)
    scheme = lr_cfg.schedule_scheme

    if scheme is None or scheme == "constant":
        fields = [(base_lr, base_lr)]
        epochs = [(0, max(num_epochs, 1))]
        kinds = ["0"]
    elif scheme == "strict":
        if not (lr_cfg.lr_change_epochs and lr_cfg.lr_fields
                and lr_cfg.lr_scale_indicators):
            raise ValueError("the 'strict' scheme needs lr_change_epochs, "
                             "lr_fields and lr_scale_indicators")
        change = f"0,{lr_cfg.lr_change_epochs},{num_epochs}"
        fields = _parse_fields(lr_cfg.lr_fields)
        epochs = _parse_epochs(change)
        kinds = lr_cfg.lr_scale_indicators.split(",")
    elif scheme == "custom_one_cycle":
        half = lr_cfg.onecycle_num_epoch // 2
        fields = [(lr_cfg.onecycle_low, lr_cfg.onecycle_high),
                  (lr_cfg.onecycle_high, lr_cfg.onecycle_low),
                  (lr_cfg.onecycle_low, lr_cfg.onecycle_extra_low)]
        epochs = _parse_epochs(
            f"0,{half},{lr_cfg.onecycle_num_epoch},{num_epochs}")
        kinds = ["0", "0", "0"]
    elif scheme == "custom_multistep":
        if lr_cfg.lr_change_epochs is not None:
            change_list = lr_cfg.lr_change_epochs.split(",")
            lrs = [base_lr * ((1.0 / lr_cfg.decay) ** i)
                   for i in range(len(change_list) + 1)]
            edges = [0] + [int(x) for x in change_list] + [num_epochs]
        else:
            lrs = [base_lr]
            edges = [0, num_epochs]
        fields = [(lr, lr) for lr in lrs]
        if lr_cfg.warmup:
            # the warmup field (unscaled lr -> scaled base lr) is
            # prepended (learning.py:139-141, 152-154)
            fields = [(optim_cfg.lr, base_lr)] + fields
            edges = [0, lr_cfg.warmup_epochs] + edges[1:]
        epochs = list(zip(edges[:-1], edges[1:]))
        kinds = ["0"] * len(fields)
    elif scheme == "custom_convex_decay":
        if lr_cfg.gamma is None or lr_cfg.mu is None \
                or lr_cfg.alpha is None:
            raise ValueError("the 'custom_convex_decay' scheme needs "
                             "gamma, mu and alpha")
        fields = [(base_lr, 0.0)]
        epochs = [(0, max(num_epochs, 1))]
        kinds = ["2"]
    else:
        raise NotImplementedError(f"Unknown lr scheme {scheme!r}")

    f = len(fields)
    g = lr_cfg.gamma if lr_cfg.gamma is not None else 1.0
    m = lr_cfg.mu if lr_cfg.mu is not None else 1.0
    a = lr_cfg.alpha if lr_cfg.alpha is not None else 1.0
    f32 = dict(dtype=torch.float32)
    return LRSchedule(
        starts=torch.tensor([e[0] for e in epochs], **f32),
        ends=torch.tensor([e[1] for e in epochs], **f32),
        kinds=torch.tensor([_KIND_NAMES[k] for k in kinds],
                           dtype=torch.int32),
        lr_left=torch.tensor([x[0] for x in fields], **f32),
        lr_right=torch.tensor([x[1] for x in fields], **f32),
        gamma=torch.full((f,), g, **f32),
        mu=torch.full((f,), m, **f32),
        alpha=torch.full((f,), a, **f32),
    )
