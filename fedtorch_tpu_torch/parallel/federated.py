"""The federated round engine (port of the synchronous, device-data,
per-client path of ``fedtorch_tpu/parallel/federated.py``).

One round: draw (or take) the round plan — the k online clients and
each one's K*B storage rows —, run each online client's K local steps
from the server model, weight and stack the payloads, apply the uplink
wire format on the stacked ``[k]`` axis, sum, apply the downlink wire
format, take the server step, and write the online clients' state back.

What differs from the JAX package, and why:

* The k clients run one after another in a Python loop over one shared
  module (``torch.func.functional_call`` with each client's params); the
  JAX package vmaps them. A batched or grouped-conv client axis is later
  performance work.
* The round plan is drawn from the server's ``torch.Generator``, not
  threefry, so the two packages pick other cohorts and rows from one
  seed; :meth:`FederatedTrainer.round_fn` takes an injected
  :class:`RoundPlan` so tests can feed both the same cohort.
* The JAX package's 'batch' and 'shard' gather modes select the same
  rows (the flattened ``round_row_plan`` equals per-step ``take_batch``
  over the epoch permutation), so the port has one gather and no
  ``gather_mode``: each client's K*B rows.
* Epoch-sync clients skip the steps past their own budget instead of
  running them masked; state and metrics come out the same.
* Client state is updated in place (see ``core/state.py``).

Everything of ``_round_core`` that is off on this path — chaos, guards,
robust rules, DP, availability, pod-scale sharding, cohort stats, the
async and stream planes, client fusion — is refused by name at
construction.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from fedtorch_tpu_torch.algorithms.base import (
    FedAlgorithm, num_online_effective,
)
from fedtorch_tpu_torch.config import ExperimentConfig
from fedtorch_tpu_torch.core import optim
from fedtorch_tpu_torch.core.losses import make_criterion
from fedtorch_tpu_torch.core.schedule import compile_schedule, lr_at
from fedtorch_tpu_torch.core.state import (
    ClientState, RoundMetrics, ServerState, tree_broadcast_clients,
    tree_bytes, tree_put, tree_stack, tree_sub, tree_take,
)
from fedtorch_tpu_torch.data.batching import ClientData, round_row_plan
from fedtorch_tpu_torch.models.common import ModelDef
from fedtorch_tpu_torch.ops.augment import augment_image_batch, draw_augment
from fedtorch_tpu_torch.utils import resolve_device


class RoundPlan(NamedTuple):
    """What a round consumes of randomness, as CPU tensors: the online
    client ids, each one's K*B storage rows, and (augmentation on) the
    per-step flip/crop draws."""
    idx: torch.Tensor                     # [k] int64 online client ids
    rows: torch.Tensor                    # [k, K*B] int64 storage rows
    flip: Optional[torch.Tensor] = None   # [k, K, B] bool
    tops: Optional[torch.Tensor] = None   # [k, K, B] int64 in [0, 8]
    lefts: Optional[torch.Tensor] = None  # [k, K, B] int64 in [0, 8]


def participation_indices(generator: torch.Generator, num_clients: int,
                          k: int, round_idx: int) -> torch.Tensor:
    """k online clients uniformly without replacement (misc.py:10-19);
    round 0 forces client 0 online by replacing the last slot
    (main.py:62-63)."""
    idx = torch.randperm(num_clients, generator=generator)[:k]
    if round_idx == 0 and not bool((idx == 0).any()):
        idx[k - 1] = 0
    return idx


def unported_features(cfg: ExperimentConfig, has_val: bool) -> list:
    """Names of the requested features this port does not have yet."""
    fed, flt, mesh = cfg.federated, cfg.fault, cfg.mesh
    checks = [
        (flt.chaos_enabled, "chaos (client_drop/straggler/nan_inject/"
                            "byzantine rates)"),
        (flt.guard_updates, "guards (guard_updates)"),
        (flt.robust_agg != "mean", f"robust_agg={flt.robust_agg!r}"),
        (flt.dp_armed, "DP (dp_noise_multiplier)"),
        (flt.avail_armed, "availability (avail_* / over_select_frac)"),
        (mesh.client_shards != 0, "client_shards"),
        (cfg.telemetry.cohort_stats, "cohort stats"),
        (fed.sync_mode == "async", "the async plane (sync_mode='async')"),
        (cfg.data.data_plane == "stream",
         "the stream data plane (data_plane='stream')"),
        (mesh.client_fusion == "fused", "client_fusion='fused'"),
        (fed.compressed, "compressed"),
        (fed.participation_mode != "perm",
         f"participation_mode={fed.participation_mode!r}"),
        (fed.personal, "personalization (personal)"),
        (fed.drfa, "drfa"),
        (fed.algorithm not in ("fedavg", "fedprox", "fedadam"),
         f"algorithm {fed.algorithm!r}"),
        (has_val, "per-client validation data"),
    ]
    return [name for bad, name in checks if bad]


class FederatedTrainer:
    """Runs the round program on ``device`` (``cuda`` unless the caller
    asks for another)."""

    def __init__(self, cfg: ExperimentConfig, model: ModelDef,
                 algorithm: FedAlgorithm, data: ClientData,
                 val_data: Optional[ClientData] = None, device=None):
        refused = unported_features(cfg, val_data is not None)
        if refused:
            raise ValueError(f"{', '.join(refused)}: not yet ported")
        self.device = resolve_device(device)
        if model.sample_input.device != self.device:
            raise ValueError(f"the model lives on "
                             f"{model.sample_input.device}, the trainer "
                             f"on {self.device}")
        self.cfg = cfg
        self.model = model
        self.algorithm = algorithm
        self.num_clients = data.num_clients
        self.batch_size = cfg.data.batch_size
        self.k_online = max(
            int(cfg.federated.online_client_rate * self.num_clients), 1)
        self.epoch_sync = cfg.federated.sync_type == "epoch"
        if self.epoch_sync:
            nb_max = math.ceil(data.n_max / self.batch_size)
            self.local_steps = nb_max * cfg.federated.num_epochs_per_comm
        else:
            self.local_steps = max(cfg.train.local_step, 1)
        # train-time flip+crop for image batches ([C, N, H, W, C] data)
        self.augment = bool(cfg.data.augment) and data.x.dim() == 5
        self.schedule = compile_schedule(
            cfg.lr_schedule, cfg.optim, cfg.train.num_epochs or 1,
            world_size=self.num_clients).to(self.device)
        self.criterion = make_criterion(model.is_regression)
        algorithm.bind(model, self.criterion)
        self.sizes = [int(s) for s in data.sizes]
        self.data = data.to(self.device)

    # -- state ----------------------------------------------------------
    def init_state(self, rng):
        """Fresh (server, clients). ``rng`` is a ``torch.Generator`` or
        an int seed; the server keeps the generator and draws the round
        plans from it."""
        gen = rng if isinstance(rng, torch.Generator) \
            else torch.Generator().manual_seed(int(rng))
        params = self.model.init(gen)
        ocfg = self.cfg.optim
        server = ServerState(
            params=params, opt=optim.init_opt_state(params, ocfg),
            aux=self.algorithm.init_server_aux(params, self.num_clients),
            round=0, rng=gen)
        C = self.num_clients
        cparams = tree_broadcast_clients(params, C)
        copt = optim.init_opt_state(cparams, ocfg)
        if isinstance(copt, optim.AdamState):
            copt = copt._replace(step=torch.zeros(
                C, dtype=torch.int32, device=self.device))
        clients = ClientState(
            params=cparams, opt=copt,
            aux=self.algorithm.init_client_aux(cparams),
            epoch=torch.zeros(C, device=self.device),
            local_index=torch.zeros(C, dtype=torch.int32,
                                    device=self.device))
        return server, clients

    def draw_plan(self, server: ServerState) -> RoundPlan:
        """This round's plan from the server's generator."""
        K, B, k = self.local_steps, self.batch_size, self.k_online
        gen = server.rng
        idx = participation_indices(gen, self.num_clients, k, server.round)
        rows = torch.stack([
            round_row_plan(gen, self.sizes[c], self.data.n_max, K * B)
            for c in idx.tolist()])
        if not self.augment:
            return RoundPlan(idx, rows)
        return RoundPlan(idx, rows, *draw_augment(gen, (k, K, B)))

    # -- one communication round -----------------------------------------
    def round_fn(self, server: ServerState, clients: ClientState,
                 plan: Optional[RoundPlan] = None):
        """One round: returns (server', clients, metrics). ``clients`` is
        updated in place and returned. ``plan`` (default: drawn from
        ``server.rng``) fixes the cohort, rows and augmentation draws."""
        if plan is None:
            plan = self.draw_plan(server)
        alg, dev = self.algorithm, self.device
        K, B, C = self.local_steps, self.batch_size, self.num_clients
        idx = plan.idx.to(torch.int64)
        k = idx.shape[0]
        num_online_eff = num_online_effective(idx)
        weights = alg.client_weights(
            server.aux, idx, num_online_eff,
            torch.tensor([self.sizes[c] for c in idx.tolist()])).to(dev)
        rows = plan.rows.to(dev)
        if self.augment:
            draws = [t.to(dev) for t in (plan.flip, plan.tops, plan.lefts)]

        payloads, client_opts, client_aux = [], [], []
        epochs, local_index, losses, accs = [], [], [], []
        for j, c in enumerate(idx.tolist()):
            size = self.sizes[c]
            nb = math.ceil(size / B)  # batches per local epoch
            # epoch-sync clients stop after their own budget
            budget = min(nb * self.cfg.federated.num_epochs_per_comm, K) \
                if self.epoch_sync else K
            x = self.data.x[c][rows[j]]
            y = self.data.y[c][rows[j]]
            params, aux = server.params, tree_take(clients.aux, c)
            opt = tree_take(clients.opt, c)
            epoch, li = clients.epoch[c], clients.local_index[c]
            step_loss, step_acc = [], []
            for s in range(budget):
                lr = lr_at(self.schedule, epoch)
                bx, by = x[s * B:(s + 1) * B], y[s * B:(s + 1) * B]
                if self.augment:
                    bx = augment_image_batch(bx, *(d[j, s] for d in draws))
                params, opt, aux, loss, acc = alg.local_step(
                    params=params, opt=opt, client_aux=aux,
                    server_params=server.params, server_aux=server.aux,
                    bx=bx, by=by, lr=lr)
                epoch = epoch + 1.0 / nb
                li = li + 1
                step_loss.append(loss)
                step_acc.append(acc)
            delta = tree_sub(server.params, params)
            payload, aux = alg.client_payload(
                delta=delta, client_aux=aux, params=params,
                server_params=server.params, server_aux=server.aux,
                lr=lr_at(self.schedule, epoch), local_steps=budget,
                weight=weights[j])
            payloads.append(payload)
            client_opts.append(opt)
            client_aux.append(aux)
            epochs.append(epoch)
            local_index.append(li)
            losses.append(torch.stack(step_loss).sum() / budget)
            accs.append(torch.stack(step_acc).sum() / budget)

        with torch.no_grad():
            # uplink wire format on the stacked [k] axis, sum, downlink
            stacked = alg.payload_batch_transform(tree_stack(payloads))
            payload_sum = {n: p.sum(dim=0) for n, p in stacked.items()}
            payload_sum = alg.aggregate_transform(payload_sum)
            losses, accs = torch.stack(losses), torch.stack(accs)
            new_params, new_opt, new_saux = alg.server_update(
                server.params, server.opt, server.aux, payload_sum,
                online_idx=idx, num_online_eff=num_online_eff,
                client_losses=losses)

            # online clients leave holding the aggregated server model
            # (model_server = deepcopy(model_client), fedavg.py:97)
            rows_dev = idx.to(dev)
            for n, p in clients.params.items():
                p[rows_dev] = new_params[n]
            tree_put(clients.opt, rows_dev, _stack_state(client_opts))
            tree_put(clients.aux, rows_dev, _stack_state(client_aux))
            clients.epoch[rows_dev] = torch.stack(epochs)
            clients.local_index[rows_dev] = torch.stack(local_index)

            online = torch.zeros(C, device=dev)
            online[rows_dev] = 1.0
            metrics = RoundMetrics(
                train_loss=torch.zeros(C, device=dev).index_put(
                    (rows_dev,), losses),
                train_acc=torch.zeros(C, device=dev).index_put(
                    (rows_dev,), accs),
                online_mask=online,
                comm_bytes=torch.tensor(
                    tree_bytes(server.params) * k * alg.payload_scale(),
                    dtype=torch.float32, device=dev))
        new_server = ServerState(params=new_params, opt=new_opt,
                                 aux=new_saux, round=server.round + 1,
                                 rng=server.rng)
        return new_server, clients, metrics

    # -- host-side round loop ---------------------------------------------
    def run_rounds(self, server, clients, num_rounds: int):
        """``num_rounds`` rounds; metrics come back with a leading
        [num_rounds] axis, as the JAX package's scanned round program returns
        them."""
        if num_rounds < 1:
            raise ValueError(
                f"run_rounds needs num_rounds >= 1, got {num_rounds}")
        history = []
        for _ in range(num_rounds):
            server, clients, metrics = self.round_fn(server, clients)
            history.append(metrics)
        return server, clients, RoundMetrics(
            *(torch.stack(f) for f in zip(*history)))


def _stack_state(per_client: list):
    """Stack per-client states (dicts, NamedTuples of dicts, 0-d tensors
    or ()) on a new leading axis."""
    first = per_client[0]
    if isinstance(first, dict):
        return tree_stack(per_client)
    if isinstance(first, tuple) and hasattr(first, "_fields"):
        return type(first)(*(_stack_state(list(f))
                             for f in zip(*per_client)))
    if isinstance(first, torch.Tensor):
        return torch.stack(per_client)
    return first
