"""Structured run logging (the port's copy of
``fedtorch_tpu/utils/logging.py``: the same train and val line
formats, so one parser reads the logs of both packages).

Parity with ``logs/logging.py``: timestamped print + append to a per-rank
record file (:16-31; here one ``record0`` file per run — there is a single
process), argument dump (:49-56), and parseable train/val line formats
(:83-117) that the JAX package's ``tools`` regex-parse back into tables the
same way the reference's ``tools/load_console_records.py`` does.
"""
from __future__ import annotations

import os
import time
from typing import Optional


class RunLogger:
    def __init__(self, log_dir: Optional[str] = None, debug: bool = True,
                 rank: int = 0):
        self.debug = debug
        self.path = None
        if log_dir is not None:
            os.makedirs(log_dir, exist_ok=True)
            self.path = os.path.join(log_dir, f"record{rank}")

    def log(self, message: str, display: Optional[bool] = None):
        """logging.py:16-31: timestamped console + file append."""
        line = "{} {}".format(
            time.strftime("%Y-%m-%d %H:%M:%S"), message)
        if display if display is not None else self.debug:
            print(line, flush=True)
        if self.path is not None:
            with open(self.path, "a") as f:
                f.write(line + "\n")

    def log_args(self, cfg):
        """Argument dump (logging.py:49-56)."""
        import dataclasses
        import json
        self.log("arguments: {}".format(
            json.dumps(dataclasses.asdict(cfg), default=str)))

    def log_train(self, round_idx: int, epoch: float, loss: float,
                  top1: float, lr: float, comm_bytes: float = 0.0,
                  round_time: float = 0.0):
        """Train line (format shaped like logging.py:83-97)."""
        self.log(
            f"Round: {round_idx}. Epoch: {epoch:.3f}. "
            f"Local index: {round_idx}. Load: 0.0s | Computing: "
            f"{round_time:.4f}s | Sync: 0.0s | Global: {round_time:.4f}s | "
            f"Loss: {loss:.6f} | top1: {top1:.4f} | lr: {lr:.6f} | "
            f"CommBytes: {comm_bytes:.0f}")

    def log_val(self, round_idx: int, mode: str, loss: float, top1: float,
                top5: float = 0.0, best: Optional[float] = None):
        """Validation line (format shaped like logging.py:99-117)."""
        suffix = f" | best: {best:.4f}" if best is not None else ""
        self.log(
            f"Round: {round_idx}. Mode: {mode}. Loss: {loss:.6f} | "
            f"top1: {top1:.4f} | top5: {top5:.4f}{suffix}")

    def log_comm_time(self, round_idx: int, seconds: float):
        """federated/main.py:208."""
        self.log(f"This round communication time is: {seconds}")
