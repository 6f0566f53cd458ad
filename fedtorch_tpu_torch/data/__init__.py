"""Data layer (port of ``fedtorch_tpu/data/__init__.py``): datasets,
partitioners and the padded per-client layout.

``build_federated_data`` loads a dataset, partitions it (the scheme is
chosen as the JAX package chooses it) and stacks the partitions into
padded ``[clients, N, ...]`` CPU tensors (``stack_partitions``); the
trainer moves them to its device. With personalization
(``cfg.federated.personal``, forced on for APFL, PerFedMe and
PerFedAvg) each client's partition is split into train and val rows
first (``train_val_split``) and ``FederatedData.val`` is stacked like
``train``.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np

from fedtorch_tpu_torch.config import ExperimentConfig
from fedtorch_tpu_torch.data.batching import (
    ClientData, stack_partitions, train_val_split,
)
from fedtorch_tpu_torch.data.datasets import DatasetSplits, get_dataset
from fedtorch_tpu_torch.data.partition import (
    dirichlet_partition, iid_partition, label_sorted_partition,
    sensitive_group_partition,
)


class FederatedData(NamedTuple):
    train: ClientData
    val: Optional[ClientData]      # per-client validation (fed_personal)
    test_x: np.ndarray             # server-side test set
    test_y: np.ndarray
    num_clients: int


def choose_partitions(splits: DatasetSplits, cfg: ExperimentConfig,
                      num_clients: int):
    """Partition-scheme dispatch (partition.py:106-220)."""
    d = cfg.data
    if splits.client_partitions is not None:
        # naturally-federated (emnist/shakespeare/synthetic): client i's
        # file is its partition; when there are more natural clients than requested,
        # take the first num_clients
        parts = splits.client_partitions
        if len(parts) < num_clients:
            raise ValueError(
                f"dataset provides {len(parts)} natural clients < "
                f"requested {num_clients}")
        return parts[:num_clients]
    if d.dataset == "adult" and splits.sensitive_values is not None \
            and not d.iid:
        return sensitive_group_partition(splits.sensitive_values,
                                         num_clients)
    if d.iid:
        return iid_partition(len(splits.train_y), num_clients,
                             seed=cfg.train.manual_seed)
    if d.dirichlet:
        return dirichlet_partition(splits.train_y, num_clients,
                                   concentration=d.dirichlet_alpha,
                                   seed=cfg.train.manual_seed)
    return label_sorted_partition(splits.train_y, num_clients,
                                  num_class_per_client=d.num_class_per_client,
                                  unbalanced=d.unbalanced)


def build_federated_data(cfg: ExperimentConfig,
                         download: bool = False) -> FederatedData:
    num_clients = cfg.federated.num_clients
    splits = get_dataset(cfg.data, num_clients, download=download,
                         seq_len=cfg.model.rnn_seq_len)
    parts = choose_partitions(splits, cfg, num_clients)
    val = None
    if cfg.federated.personal:
        parts, val_parts = train_val_split(parts, cfg.data.val_fraction,
                                           seed=cfg.train.manual_seed)
        val = stack_partitions(splits.train_x, splits.train_y, val_parts)
    train = stack_partitions(splits.train_x, splits.train_y, parts)
    return FederatedData(train=train, val=val, test_x=splits.test_x,
                         test_y=splits.test_y, num_clients=num_clients)
