"""Local-SGD mode, the non-federated runs (port of
``fedtorch_tpu/parallel/local_sgd.py``; the reference's
``train_and_validate``, comms/trainings/distributed.py:23-134, and
``aggregate_gradients``, comms/algorithms/distributed.py:108-142).

Every worker trains on its own shard and the model deltas are averaged
every ``local_steps[epoch]`` steps, the per-epoch counts of the sync
scheme with its warm-up (``core/sync.local_steps_from_config``). It runs
on the federated engine with:

* every worker online (``online_client_rate`` forced to 1.0);
* weights exactly 1/n with ``avg_model``, else 1 (the sum-only mode,
  distributed.py:124-126), without the federated rank-0 denominator;
* each round's K (and, with ``growing_batch_size``, its batch size, in
  power-of-two buckets) set on the trainer for that round and restored
  after it; the JAX package compiles one program per (K, B), the port
  needs none;
* with ``reshuffle_per_epoch`` the data re-partitioned IID across the
  workers at each new epoch (distributed.py:129-134).

On several ranks (``mesh.client_shards`` 0, the JAX package's 1-D mesh)
it is the engine's round with k = C: the workers' state and shards are
sharded over the ranks by the owner rule (``parallel/mesh.py``
``owned_client_rows``), each rank runs its ``ceil(C/W)`` workers of the
round, and the cohort gather brings every rank every worker's rows
before the average (``parallel/federated.py``). A reshuffle keeps this
rank's workers' rows of the new partition, as the JAX package's
re-shards it. The loop control reads the replicated ``[C]`` epochs and
local indices, which hold the real workers only, so the stop counts no
padding row.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from fedtorch_tpu_torch.algorithms.fedavg import FedAvg
from fedtorch_tpu_torch.config import ExperimentConfig
from fedtorch_tpu_torch.core.sync import local_steps_from_config
from fedtorch_tpu_torch.data.batching import (
    ClientData, growing_batch_schedule, stack_partitions,
)
from fedtorch_tpu_torch.data.partition import iid_partition
from fedtorch_tpu_torch.models.common import ModelDef
from fedtorch_tpu_torch.parallel.federated import FederatedTrainer, RoundPlan


class LocalSGDAggregation(FedAvg):
    """aggregate_gradients' weighting (distributed.py:124-126)."""

    name = "localsgd"

    def client_weights(self, server_aux, online_idx, num_online_eff,
                       sizes):
        n = self.cfg.federated.num_clients
        w = 1.0 / n if self.cfg.train.avg_model else 1.0
        return torch.full((online_idx.shape[0],), w)


class LocalSGDTrainer(FederatedTrainer):
    """Local SGD over the workers (the engine's clients), on ``device``
    (``cuda`` unless the caller asks for another)."""

    def __init__(self, cfg: ExperimentConfig, model: ModelDef,
                 data: ClientData, raw_splits=None, device=None):
        if cfg.data.data_plane != "device":
            raise ValueError("local-SGD mode runs on the device data "
                             "plane; data_plane='stream' is for "
                             "federated runs")
        if cfg.federated.online_client_rate != 1.0:
            cfg = dataclasses.replace(cfg, federated=dataclasses.replace(
                cfg.federated, online_client_rate=1.0))
        super().__init__(cfg, model, LocalSGDAggregation(cfg), data,
                         device=device)
        self.steps_schedule = local_steps_from_config(cfg)
        self._raw_splits = raw_splits  # (features, labels) for reshuffles
        # growing minibatches (GrowingMinibatchSampler,
        # dataset.py:276-317) over each worker's shard
        self._batch_schedule = None
        if cfg.data.growing_batch_size:
            iteration_mode = (cfg.train.stop_criteria == "iteration"
                              and cfg.train.num_iterations is not None)
            self._batch_schedule = growing_batch_schedule(
                base_batch_size=cfg.data.base_batch_size or 1,
                max_batch_size=cfg.data.max_batch_size,
                num_samples_per_epoch=int(np.asarray(data.sizes).mean()),
                num_epochs=None if iteration_mode
                else (cfg.train.num_epochs or 1),
                num_iterations=cfg.train.num_iterations
                if iteration_mode else None)

    def _bucketed_batch(self, step: int) -> int:
        """The power-of-two bucket of the scheduled batch size, never
        above ``max_batch_size`` or a worker's padded shard (runs that
        outlive the schedule keep its largest size)."""
        sched = self._batch_schedule
        b = sched[step] if step < len(sched) else max(sched)
        p = 1
        while p < b:
            p *= 2
        cap = self.cfg.data.max_batch_size or p
        return max(min(p, cap, max(int(self.data.n_max), 1)), 1)

    def _round_with_steps(self, K: int, B: Optional[int] = None):
        """One round of K local steps (and batch B): the trainer's step
        count, batch size and the algorithm's round length are set for
        the round and restored after it, as the JAX package's cached
        program for (K, B) does. The returned function takes
        ``(server, clients, plan=None)``."""
        def fn(server, clients, plan: Optional[RoundPlan] = None):
            old = (self.local_steps, self.batch_size,
                   self.algorithm.local_steps_per_round)
            self.local_steps = K
            self.algorithm.local_steps_per_round = K
            if B is not None:
                self.batch_size = B
            try:
                return self.round_fn(server, clients, plan)
            finally:
                (self.local_steps, self.batch_size,
                 self.algorithm.local_steps_per_round) = old
        return fn

    def _reshuffle(self, epoch_seed: int) -> None:
        """reshuffle_per_epoch: a new IID partition across the workers
        (distributed.py:129-134); this rank keeps its workers' rows."""
        feats, labels = self._raw_splits
        parts = iid_partition(len(labels), self.num_clients, seed=epoch_seed)
        data = stack_partitions(feats, labels, parts)
        self.sizes = [int(s) for s in data.sizes]
        self.data = self._owned_population(data).to(self.device)

    def fit(self, rng, callback=None):
        """Rounds until the stop criterion (distributed.py:107-120): the
        epoch count, or the iteration count in iteration mode. ``rng`` as
        for :meth:`init_state`; ``callback(server, clients, metrics)``
        after each round. Returns (server, clients, per-round metrics)."""
        server, clients = self.init_state(rng)
        cfg = self.cfg
        num_epochs = cfg.train.num_epochs or 1
        history = []
        last_epoch_int = 0
        while True:
            # the two loop-control scalars in one transfer (the [C]
            # epochs and local indices are every real worker's, on every
            # rank)
            epoch, it = torch.stack([
                clients.epoch.mean(),
                clients.local_index.max().to(torch.float32)]).tolist()
            it = int(it)
            if cfg.train.stop_criteria == "iteration" \
                    and cfg.train.num_iterations is not None:
                if it >= cfg.train.num_iterations:
                    break
            elif epoch >= num_epochs:
                break
            epoch_idx = min(int(epoch), len(self.steps_schedule) - 1)
            if cfg.data.reshuffle_per_epoch \
                    and self._raw_splits is not None \
                    and int(epoch) > last_epoch_int:
                last_epoch_int = int(epoch)
                self._reshuffle(cfg.train.manual_seed + last_epoch_int)
            K = max(self.steps_schedule[epoch_idx], 1)
            B = self._bucketed_batch(it) if self._batch_schedule else None
            server, clients, metrics = self._round_with_steps(K, B)(
                server, clients)
            if callback is not None:
                callback(server, clients, metrics)
            history.append(metrics)
        return server, clients, history


def build_local_sgd(cfg: ExperimentConfig, model: ModelDef,
                    features: np.ndarray, labels: np.ndarray,
                    device=None) -> LocalSGDTrainer:
    """Partition a dataset IID across the workers and build the trainer
    (the define_dataset path of the non-federated mode)."""
    parts = iid_partition(len(labels), cfg.federated.num_clients,
                          seed=cfg.train.manual_seed)
    return LocalSGDTrainer(cfg, model, stack_partitions(features, labels,
                                                        parts),
                           raw_splits=(features, labels), device=device)
