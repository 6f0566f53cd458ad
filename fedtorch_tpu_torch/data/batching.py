"""Federated data layout and batch order (port of
``fedtorch_tpu/data/batching.py``).

The whole federated dataset lives on the device as ``[C, N_max, ...]``
tensors padded per client (padding repeats the client's own samples
cyclically) with an explicit size vector. A round's batch order per
client is one random permutation of its real samples, indexed with
wraparound by the flattened (step, row) counter — the same law as the
JAX package's ``round_row_plan``, drawn from a ``torch.Generator``
instead of threefry (the two give different numbers for one seed, so
the tests inject the JAX package's plan). Also here, as numpy copies of
the JAX package's: the per-client train/val split of personalization
(``train_val_split``) and local-SGD mode's growing-minibatch schedule
(``growing_batch_schedule``).
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence

import numpy as np
import torch


class ClientData(NamedTuple):
    """Per-client padded tensors. ``x: [C, N_max, ...]``, ``y: [C,
    N_max, ...]`` (``[C, N_max, T]`` next-token labels for a sequence
    model), ``sizes: [C]`` true sample counts."""
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
    # class ids as int64; regression targets stay float32
    y = y.astype(np.float32 if np.issubdtype(y.dtype, np.floating)
                 else np.int64)
    return ClientData(
        x=torch.from_numpy(x.reshape((C, n_max) + x.shape[1:])),
        y=torch.from_numpy(y.reshape((C, n_max) + y.shape[1:])),
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


def sample_batch(generator: torch.Generator, size: int,
                 batch_size: int) -> torch.Tensor:
    """Uniform-with-replacement draw of ``batch_size`` storage rows of a
    client of ``size`` samples (where the reference samples one random
    batch: DRFA's loss probe). Returns the rows; index the client's data
    with them."""
    return torch.randint(0, max(int(size), 1), (batch_size,),
                         generator=generator)


def train_val_split(partitions: Sequence[np.ndarray], val_fraction: float,
                    seed: int = 0):
    """Per-client train/val random split for personalization
    (components/dataset.py:168-211): one ``RandomState(seed)`` permutes
    each partition in turn; ``max(int(n * val_fraction), 1)`` val rows,
    none for a client of one sample. Returns (train parts, val parts)."""
    rng = np.random.RandomState(seed)
    train_parts, val_parts = [], []
    for p in partitions:
        p = np.asarray(p)
        perm = rng.permutation(len(p))
        n_val = max(int(len(p) * val_fraction), 1) if len(p) > 1 else 0
        val_parts.append(p[perm[:n_val]])
        train_parts.append(p[perm[n_val:]])
    return train_parts, val_parts


def growing_batch_schedule(base_batch_size: int = 2,
                           max_batch_size: int = 0,
                           num_samples_per_epoch: int = 0,
                           num_epochs: Optional[int] = None,
                           num_iterations: Optional[int] = None,
                           rho: float = 1.01) -> List[int]:
    """The per-step batch sizes of growing-minibatch mode
    (GrowingMinibatchSampler, components/dataset.py:276-317):
    ``int(base * rho^i) + 1``, the step count from ``num_epochs`` by the
    geometric sum (or ``num_iterations``); sizes past ``max_batch_size``
    become max-size batches over the same samples, then the remainder
    (omitted when zero)."""
    if num_epochs is None:
        if num_iterations is None:
            raise ValueError(
                "One of num_epochs or num_iterations must be provided.")
    else:
        num_iterations = int(
            np.log(num_samples_per_epoch * num_epochs * (rho - 1)
                   / base_batch_size + 1) / np.log(rho)) + 1
    batch_sizes = [int(base_batch_size * rho ** i) + 1
                   for i in range(num_iterations)]
    if max_batch_size:
        b = np.asarray(batch_sizes)
        over = np.flatnonzero(b > max_batch_size)
        if len(over) >= 1:
            overflow = int(np.sum(b[over]))
            batch_sizes = batch_sizes[:over[0]] \
                + [max_batch_size] * (overflow // max_batch_size)
            if overflow % max_batch_size:
                batch_sizes += [overflow % max_batch_size]
    return batch_sizes
