"""Federated data layout and batch order (port of
``fedtorch_tpu/data/batching.py``).

The whole federated dataset lives on the device as ``[C, N_max, ...]``
tensors padded per client (padding repeats the client's own samples
cyclically) with an explicit size vector. A round's batch order per
client is one random permutation of its real samples, indexed with
wraparound by the flattened (step, row) counter — the same law as the
JAX package's ``round_row_plan``, drawn from a ``torch.Generator``
instead of threefry (the two give different numbers for one seed, so
the tests inject the JAX package's plan).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch


class ClientData(NamedTuple):
    """Per-client padded tensors. ``x: [C, N_max, ...]``, ``y: [C,
    N_max]``, ``sizes: [C]`` true sample counts."""
    x: torch.Tensor
    y: torch.Tensor
    sizes: torch.Tensor

    @property
    def num_clients(self) -> int:
        return self.x.shape[0]

    @property
    def n_max(self) -> int:
        return self.x.shape[1]

    def to(self, device) -> "ClientData":
        return ClientData(*(t.to(device) for t in self))


def stack_partitions(features: np.ndarray, labels: np.ndarray,
                     partitions: Sequence[np.ndarray],
                     n_max: Optional[int] = None) -> ClientData:
    """Stack per-client index lists into padded CPU tensors (the trainer
    moves them to its device). Padding repeats each client's own samples
    cyclically, so a padded row is always a valid sample of that
    client."""
    sizes = np.asarray([len(p) for p in partitions])
    if np.any(sizes == 0):
        raise ValueError("Every client needs at least one sample; got a "
                         f"zero-sized partition (sizes={sizes.tolist()})")
    if n_max is None:
        n_max = int(sizes.max())
    idx_all = np.concatenate([
        np.tile(np.asarray(p, np.int64), -(-n_max // len(p)))[:n_max]
        for p in partitions])
    C = len(partitions)
    x = np.ascontiguousarray(features[idx_all])
    y = np.ascontiguousarray(labels[idx_all])
    return ClientData(
        x=torch.from_numpy(x.reshape((C, n_max) + x.shape[1:])),
        y=torch.from_numpy(y.reshape((C, n_max)).astype(np.int64)),
        sizes=torch.from_numpy(sizes.astype(np.int32)))


def epoch_permutation(generator: torch.Generator, size: int,
                      n_max: int) -> torch.Tensor:
    """A random permutation of [0, size) followed by the padding rows
    [size, n_max) — the law of the JAX package's sort-key draw (real
    samples first in random order)."""
    return torch.cat([torch.randperm(size, generator=generator),
                      torch.arange(size, n_max)])


def round_row_plan(generator: torch.Generator, size: int, n_max: int,
                   num_rows: int) -> torch.Tensor:
    """One client's rows for a whole round: ``perm[(step*B + j) %
    size]`` for all ``num_rows = K*B`` (step, j) pairs."""
    perm = epoch_permutation(generator, size, n_max)
    return perm[torch.arange(num_rows) % max(size, 1)]


def take_batch(data_x: torch.Tensor, data_y: torch.Tensor,
               perm: torch.Tensor, size: int, step_in_epoch: int,
               batch_size: int):
    """Batch ``step_in_epoch`` of one client's permuted epoch (indices
    wrap modulo the true client size)."""
    offsets = step_in_epoch * batch_size + torch.arange(batch_size)
    idx = perm[offsets % max(size, 1)].to(data_x.device)
    return data_x[idx], data_y[idx]
