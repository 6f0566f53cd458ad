"""Meters & phase timers (the port's copy of
``fedtorch_tpu/utils/meters.py``).

Parity with ``logs/meter.py``: :class:`AverageMeter` (:30-48) and the
tracker dicts for training (computing_time / sync_time / load_time /
global_time, :5-8) and validation (:11-12). The reference hand-times every
phase around its MPI calls; here whole-round wall-clock is measured
around the round call, after the device has finished it (per-kernel
attribution comes from ``torch.profiler``), and communication *volume*
is accounted exactly via the payload bytes the engine reports.
"""
from __future__ import annotations

import time
from typing import Dict


class AverageMeter:
    """Computes and stores the average and current value
    (meter.py:30-48)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0.0
        self.max = -float("inf")
        self.min = float("inf")

    def update(self, val, n=1):
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / self.count
        self.max = max(self.max, val)
        self.min = min(self.min, val)


TRAIN_TRACKER_KEYS = ("computing_time", "global_time", "load_time",
                      "sync_time", "losses", "top1", "top5")
VAL_TRACKER_KEYS = ("losses", "top1", "top5")


def define_local_training_tracker() -> Dict[str, AverageMeter]:
    """meter.py:5-8."""
    return {k: AverageMeter() for k in TRAIN_TRACKER_KEYS}


def define_val_tracker() -> Dict[str, AverageMeter]:
    """meter.py:11-12."""
    return {k: AverageMeter() for k in VAL_TRACKER_KEYS}


class PhaseTimer:
    """Wall-clock phase accounting: round compute, eval, checkpoint IO,
    and the per-round comm-time/volume ledger (the reference accumulates
    args.comm_time per round, init_config.py:20, printed at
    federated/main.py:208)."""

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.comm_time = [0.0]
        self.comm_bytes = [0.0]
        self._start = {}

    def start(self, phase: str):
        self._start[phase] = time.time()

    def stop(self, phase: str) -> float:
        dt = time.time() - self._start.pop(phase)
        self.totals[phase] = self.totals.get(phase, 0.0) + dt
        return dt

    def new_round(self):
        self.comm_time.append(0.0)
        self.comm_bytes.append(0.0)

    def add_comm(self, seconds: float = 0.0, num_bytes: float = 0.0):
        self.comm_time[-1] += seconds
        self.comm_bytes[-1] += num_bytes

    def summary(self) -> Dict[str, float]:
        out = dict(self.totals)
        out["comm_time_total"] = sum(self.comm_time)
        out["comm_bytes_total"] = sum(self.comm_bytes)
        return out
