"""Dataset partitioners (the port's copy of
``fedtorch_tpu/data/partition.py``, numpy only: the same calls in the
same order, so the ``np.random.RandomState`` draws, and the partitions,
are bitwise those of the JAX package).

The reference's ``components/datasets/partition.py``, with one
structural change: the reference makes partitions consistent
across MPI ranks by having rank 0 shuffle and broadcast the index list
(``partition.py:25-33``); here all partitioning is driven by an explicit
shared seed, so every host derives identical partitions with no collective
(SURVEY.md §7 phase 5 'deterministic shared-seed index generation').

Schemes (FederatedPartitioner, partition.py:106-220):
* IID equal slices (DataPartitioner :42-68)
* label-sorted, ``num_class_per_client`` classes per client, optional
  unbalanced random sizes (:144-183)
* Dirichlet allocation (:184-203) — note the reference's exact scheme:
  ``probs ~ Dirichlet([0.1/K]*K)`` per client (NOT Dir(0.1) per class),
  then allocations with expected size < 10 samples are zeroed, then probs
  are renormalized per class against the true class sample counts.
* natural federation (emnist/shakespeare/synthetic: each client's file is
  its partition, :117-130)
* adult split by sensitive-feature groups (:131-143)
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np


def iid_partition(num_samples: int, num_parts: int,
                  seed: int = 0,
                  fractions: Optional[Sequence[float]] = None,
                  shuffle: bool = True) -> List[np.ndarray]:
    """Equal (or fraction-sized) slices of a shuffled index list."""
    rng = np.random.RandomState(seed)
    indices = np.arange(num_samples)
    if shuffle:
        rng.shuffle(indices)
    if fractions is None:
        fractions = [1.0 / num_parts] * num_parts
    parts, start = [], 0
    for frac in fractions:
        stop = start + int(frac * num_samples)
        parts.append(indices[start:stop])
        start = stop
    return parts


def label_sorted_partition(labels: np.ndarray, num_clients: int,
                           num_class_per_client: int = 1,
                           unbalanced: bool = False,
                           seed: int = 1122) -> List[np.ndarray]:
    """Label-sorted non-IID scheme (partition.py:144-183).

    Sorts indices by label, then hands out ``num_class_per_client``
    consecutive slices to each client. Balanced mode gives every slice
    ``N/(clients*classes_per_client)`` samples; unbalanced mode sizes the
    slices by random cuts (the reference seeds this with 1122)."""
    labels = np.asarray(labels)
    data_size = len(labels)
    classes = np.unique(labels)
    if unbalanced:
        rng = np.random.RandomState(seed)
        min_size = int(data_size / (len(classes) * num_clients))
        slice_sizes = min_size * np.ones(
            (num_class_per_client, num_clients), dtype=int)
        for i in range(num_class_per_client):
            total_remainder = int(data_size / num_class_per_client) \
                - min_size * num_clients
            cut = np.sort(rng.choice(np.arange(0, total_remainder),
                                     num_clients - 1, replace=False))
            cut = np.concatenate([[0], cut, [total_remainder]])
            slice_sizes[i, :] += cut[1:] - cut[:-1]
    else:
        slice_size = int(data_size / (num_clients * num_class_per_client))
        slice_sizes = np.full((num_class_per_client, num_clients),
                              slice_size, dtype=int)

    # sort_labels (partition.py:211-215): concatenate per-class index lists.
    sorted_ind = np.concatenate(
        [np.flatnonzero(labels == c) for c in classes])

    parts: List[List[int]] = [[] for _ in range(num_clients)]
    from_index = 0
    for n_class in range(num_class_per_client):
        for client in range(num_clients):
            to_index = from_index + slice_sizes[n_class, client]
            parts[client].extend(sorted_ind[from_index:to_index])
            from_index = to_index
    return [np.asarray(p) for p in parts]


def dirichlet_partition(labels: np.ndarray, num_clients: int,
                        concentration: float = 0.1,
                        seed: int = 0) -> List[np.ndarray]:
    """The reference's exact Dirichlet scheme (partition.py:184-203).

    per-client probs ~ Dirichlet([concentration/K]*K); zero out entries
    whose expected client allocation is < 10 samples; renormalize each
    class column against the true class sample count; take consecutive
    slices from the per-class sorted index lists."""
    labels = np.asarray(labels)
    rng = np.random.RandomState(seed)
    data_size = len(labels)
    classes = np.unique(labels)
    num_classes = len(classes)
    client_data_size = int(data_size / num_clients)
    class_ind_list = [np.flatnonzero(labels == c) for c in classes]
    class_sample_size = np.asarray([len(x) for x in class_ind_list])

    probs = rng.dirichlet(num_classes * [concentration / num_classes],
                          num_clients)
    probs[probs * client_data_size < 10] = 0
    col_sum = np.sum(probs, axis=0)
    col_sum[col_sum == 0] = 1.0  # guard empty classes (no client draws it)
    probs = probs * class_sample_size / col_sum
    sample_sizes = probs.astype(int)

    ptr = np.zeros(num_classes, dtype=int)
    parts: List[np.ndarray] = []
    for client in range(num_clients):
        chunks = []
        for c in np.flatnonzero(sample_sizes[client, :] > 0):
            to_index = ptr[c] + sample_sizes[client, c]
            chunks.append(class_ind_list[c][ptr[c]:to_index])
            ptr[c] = to_index
        parts.append(np.concatenate(chunks) if chunks
                     else np.zeros((0,), dtype=int))
    return parts


def sensitive_group_partition(sensitive_values: np.ndarray,
                              num_clients: int) -> List[np.ndarray]:
    """Adult split: clients grouped by a sensitive feature's categories
    (partition.py:131-143). num_clients must be a multiple of the number
    of groups."""
    groups = np.unique(sensitive_values)
    if num_clients % len(groups):
        raise ValueError(
            "Number of nodes should be a multiple of the number of "
            "sensitive groups")
    per_group = num_clients // len(groups)
    parts: List[np.ndarray] = [None] * num_clients
    for gi, g in enumerate(groups):
        g_inds = np.flatnonzero(sensitive_values == g)
        n = len(g_inds) // per_group
        start = 0
        for j in range(per_group):
            stop = start + n if j != per_group - 1 else len(g_inds)
            parts[gi * per_group + j] = g_inds[start:stop]
            start = stop
    return parts


def growing_batch_partition(num_samples: int, num_epochs: int,
                            num_parts: int,
                            fractions: Sequence[float] = (0.7, 0.2, 0.1),
                            reshuffle_per_epoch: bool = False,
                            seed: int = 0) -> List[np.ndarray]:
    """Per-epoch index pools for growing batch size
    (GrowingBatchPartitioner, partition.py:71-104)."""
    rng = np.random.RandomState(seed)
    parts: List[List[int]] = [[] for _ in fractions]
    for _ in range(num_epochs):
        epoch_ind = np.arange(num_samples)
        if reshuffle_per_epoch:
            rng.shuffle(epoch_ind)
        start = 0
        for i, frac in enumerate(fractions):
            stop = start + int(frac * num_samples)
            parts[i].extend(epoch_ind[start:stop])
            start = stop
    return [np.asarray(p) for p in parts]


def partition_sizes(parts: Sequence[np.ndarray]) -> np.ndarray:
    return np.asarray([len(p) for p in parts])
