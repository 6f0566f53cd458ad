"""Synchronization-frequency scheme (the port's copy of
``fedtorch_tpu/core/sync.py``, numpy only; its user is local-SGD mode,
``parallel/local_sgd.py``, in one process or on several ranks).

Rebuild of the reference sync scheduler (its ``comms/algorithms/
distributed.py:17-106``): a per-epoch list of local-step counts
supporting warmup schedules (``exp`` / ``linear`` / ``constant``) and
on/off epochs gated by the LR change points, computed on the host (it is
static config; the reference's ``flow_utils.py:17-23``
``get_current_local_step`` reads it).
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np


def define_sync_freq(num_epochs: int,
                     local_step: int,
                     local_step_warmup_type: Optional[str] = None,
                     local_step_warmup_period: Optional[int] = None,
                     turn_on_local_step_from: Optional[int] = None,
                     turn_off_local_step_from: Optional[int] = None,
                     warmup_per_intervals: bool = False,
                     lr_change_epochs: Optional[str] = None) -> List[int]:
    """Per-epoch local-step counts; semantics of distributed.py:28-106.

    The returned list has ``num_epochs + 2`` entries (the reference pads by
    two so the lookup never runs off the end mid-final-epoch)."""
    num_epochs = num_epochs + 2
    if local_step_warmup_period is None:
        local_step_warmup_period = local_step

    # Warmup prefix: how local_step ramps in over the warmup period.
    if local_step_warmup_type is None:
        warm = [local_step] * local_step_warmup_period
    elif "exp" in local_step_warmup_type:
        log_ls = int(np.log2(max(local_step_warmup_period, 1)))
        warm = [2 ** int(i * log_ls / local_step_warmup_period)
                for i in range(1, 1 + local_step_warmup_period)]
    elif "linear" in local_step_warmup_type:
        warm = [max(1, int(i * local_step / local_step_warmup_period))
                for i in range(1, 1 + local_step_warmup_period)]
    elif "constant" in local_step_warmup_type:
        warm = [1] * local_step_warmup_period
    else:
        raise NotImplementedError(
            f"Unknown warmup type {local_step_warmup_type!r}")
    warm = warm[:num_epochs]

    intervals = None
    if lr_change_epochs is not None:
        edges = [0] + [int(x) for x in lr_change_epochs.split(",")] \
            + [num_epochs]
        intervals = list(zip(edges[:-1], edges[1:]))

    if not warmup_per_intervals:
        if intervals is None or (turn_on_local_step_from is None
                                 and turn_off_local_step_from is None):
            return warm + [local_step] * (num_epochs - len(warm))
        steps: List[int] = []
        for lo, hi in intervals:
            if turn_on_local_step_from is not None \
                    and turn_off_local_step_from is not None:
                raise NotImplementedError(
                    "Simultaneous turn_on/turn_off is not supported "
                    "(matches reference distributed.py:97-98).")
            if turn_off_local_step_from is not None:
                steps += ([1] if lo >= turn_off_local_step_from
                          else [local_step]) * (hi - lo)
            else:  # turn_on_local_step_from is not None
                steps += ([local_step] if lo >= turn_on_local_step_from
                          else [1]) * (hi - lo)
        return steps
    else:
        if intervals is None:
            raise ValueError(
                "warmup_per_intervals requires lr_change_epochs")
        steps = []
        for lo, hi in intervals:
            steps += warm + [local_step] * (hi - lo - len(warm))
        return steps


def local_steps_from_config(cfg) -> List[int]:
    """configure_sync_scheme equivalent (distributed.py:17-26) from an
    :class:`fedtorch_tpu_torch.config.ExperimentConfig`."""
    t = cfg.train
    return define_sync_freq(
        num_epochs=t.num_epochs if t.num_epochs is not None else 1,
        local_step=t.local_step,
        local_step_warmup_type=t.local_step_warmup_type,
        local_step_warmup_period=t.local_step_warmup_period,
        turn_on_local_step_from=t.turn_on_local_step_from,
        turn_off_local_step_from=t.turn_off_local_step_from,
        warmup_per_intervals=t.local_step_warmup_per_interval,
        lr_change_epochs=cfg.lr_schedule.lr_change_epochs)
