"""The federated round engine (port of the synchronous, device-data,
per-client path of ``fedtorch_tpu/parallel/federated.py``).

One round: draw (or take) the round plan — the k online clients, each
one's K*B storage rows (and K*B validation rows when the algorithm
takes a validation batch a step) and the algorithm's own draws —, run
the algorithm's ``pre_round`` on the online clients' aux and first
batches, run each online
client's local steps from the server model (after its full-data loss
probe, for qFFL), weight and stack the payloads, apply the uplink wire
format on the stacked ``[k]`` axis, sum, apply the downlink wire
format, take the server step, run ``client_post`` per client on the
transformed sum, write the online clients' state back, then the
algorithm's ``post_round_global`` (DRFA's dual update). These are the
hooks and the order of the JAX package's ``_round_core``.

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
  ``gather_mode``: each client's K*B rows, and as many validation rows
  (the JAX package's ``VAL_FOLD`` stream, in either of its val modes).
* Epoch-sync clients skip the steps past their own budget instead of
  running them masked; state and metrics come out the same, and every
  step-indexed hook anchors on the budget (DRFA's snapshot step).
* Where the JAX package folds PRNG keys for an algorithm (DRFA's
  snapshot step and probe), the port draws from the server's generator
  into the plan (``FedAlgorithm.plan_draws``).
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
from fedtorch_tpu_torch.core.losses import make_criterion, per_sample_loss
from fedtorch_tpu_torch.core.schedule import compile_schedule, lr_at
from fedtorch_tpu_torch.core.state import (
    ClientState, RoundMetrics, ServerState, tree_broadcast_clients,
    tree_bytes, tree_map, tree_put, tree_stack, tree_sub, tree_take,
)
from fedtorch_tpu_torch.data.batching import ClientData, round_row_plan
from fedtorch_tpu_torch.models.common import ModelDef
from fedtorch_tpu_torch.ops.augment import augment_image_batch, draw_augment
from fedtorch_tpu_torch.utils import resolve_device


class RoundPlan(NamedTuple):
    """What a round consumes of randomness, as CPU tensors: the online
    client ids, each one's K*B storage rows, (augmentation on) the
    per-step flip/crop draws, (DRFA) the shared snapshot step and the
    second phase's cohort and rows, and (``needs_val_batch``) each online
    client's K*B validation storage rows."""
    idx: torch.Tensor                     # [k] int64 online client ids
    rows: torch.Tensor                    # [k, K*B] int64 storage rows
    flip: Optional[torch.Tensor] = None   # [k, K, B] bool
    tops: Optional[torch.Tensor] = None   # [k, K, B] int64 in [0, 8]
    lefts: Optional[torch.Tensor] = None  # [k, K, B] int64 in [0, 8]
    k_rand: Optional[int] = None          # DRFA's snapshot step, [1, K)
    probe_idx: Optional[torch.Tensor] = None   # [k] int64 probe cohort
    probe_rows: Optional[torch.Tensor] = None  # [k, B] int64 its rows
    vrows: Optional[torch.Tensor] = None  # [k, K*B] int64 validation rows


def participation_indices(generator: torch.Generator, num_clients: int,
                          k: int, round_idx: int) -> torch.Tensor:
    """k online clients uniformly without replacement (misc.py:10-19);
    round 0 forces client 0 online by replacing the last slot
    (main.py:62-63)."""
    idx = torch.randperm(num_clients, generator=generator)[:k]
    if round_idx == 0 and not bool((idx == 0).any()):
        idx[k - 1] = 0
    return idx


def unported_features(cfg: ExperimentConfig) -> list:
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
        (fed.participation_mode != "perm",
         f"participation_mode={fed.participation_mode!r}"),
    ]
    return [name for bad, name in checks if bad]


class FederatedTrainer:
    """Runs the round program on ``device`` (``cuda`` unless the caller
    asks for another)."""

    def __init__(self, cfg: ExperimentConfig, model: ModelDef,
                 algorithm: FedAlgorithm, data: ClientData,
                 val_data: Optional[ClientData] = None, device=None):
        refused = unported_features(cfg)
        if refused:
            raise ValueError(f"{', '.join(refused)}: not yet ported")
        if algorithm.needs_val_batch and val_data is None:
            raise ValueError(
                f"{algorithm.name} needs per-client validation batches; "
                "pass FederatedData.val (cfg.federated.personal builds it)")
        if val_data is not None and val_data.num_clients != data.num_clients:
            raise ValueError(f"val_data has {val_data.num_clients} clients, "
                             f"data {data.num_clients}")
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
        algorithm.setup(data)
        algorithm.bind(model, self.criterion)
        algorithm.local_steps_per_round = self.local_steps
        algorithm.k_online = self.k_online
        # hooks left at identity are not called (client_post: nothing
        # of the round is kept for it)
        self._pre_round, self._client_post = (
            getattr(type(algorithm), h) is not getattr(FedAlgorithm, h)
            for h in ("pre_round", "client_post"))
        self.sizes = [int(s) for s in data.sizes]
        self.data = data.to(self.device)
        self.val_data = val_data.to(self.device) \
            if val_data is not None else None
        self.vsizes = [int(s) for s in val_data.sizes] \
            if val_data is not None else None

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
        copt = optim.init_client_opt_state(cparams, ocfg)
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
        idx = self.algorithm.participation(gen, self.num_clients, k,
                                           server.round, server.aux)
        if idx is None:
            idx = participation_indices(gen, self.num_clients, k,
                                        server.round)
        rows = torch.stack([
            round_row_plan(gen, self.sizes[c], self.data.n_max, K * B)
            for c in idx.tolist()])
        plan = RoundPlan(idx, rows, *(draw_augment(gen, (k, K, B))
                                      if self.augment else ()))
        if self.algorithm.needs_val_batch:
            plan = plan._replace(vrows=torch.stack([
                round_row_plan(gen, self.vsizes[c], self.val_data.n_max,
                               K * B) for c in idx.tolist()]))
        return plan._replace(**self.algorithm.plan_draws(gen, self.sizes))

    # -- one communication round -----------------------------------------
    def round_fn(self, server: ServerState, clients: ClientState,
                 plan: Optional[RoundPlan] = None):
        """One round: returns (server', clients, metrics). ``clients`` is
        updated in place and returned. ``plan`` (default: drawn from
        ``server.rng``) fixes the cohort, rows, augmentation draws and
        the algorithm's own draws."""
        if plan is None:
            plan = self.draw_plan(server)
        alg, dev = self.algorithm, self.device
        K, B, C = self.local_steps, self.batch_size, self.num_clients
        idx = plan.idx.to(torch.int64)
        k = idx.shape[0]
        num_online_eff = num_online_effective(idx)
        on_sizes = torch.tensor([self.sizes[c] for c in idx.tolist()])
        weights = alg.client_weights(server.aux, idx, num_online_eff,
                                     on_sizes).to(dev)
        rows = plan.rows.to(dev)
        rows_dev = idx.to(dev)
        if self.augment:
            draws = [t.to(dev) for t in (plan.flip, plan.tops, plan.lefts)]

        if alg.needs_val_batch:
            vrows = plan.vrows.to(dev)

        # the cross-client hook on the online clients' gathered aux and
        # first B storage rows (the JAX package clamps rows past n_max)
        on_aux = tree_take(clients.aux, rows_dev)
        if self._pre_round:
            on_lrs = torch.stack([lr_at(self.schedule, clients.epoch[c])
                                  for c in idx.tolist()])
            first = (rows_dev[:, None], torch.arange(B, device=dev)
                     .clamp_max(self.data.n_max - 1)[None, :])
            on_aux = alg.pre_round(
                on_aux, server=server, x=self.data.x[first],
                y=self.data.y[first], sizes=on_sizes, lr=on_lrs, plan=plan)

        payloads, client_opts, client_aux, budgets = [], [], [], []
        epochs, local_index, losses, accs = [], [], [], []
        kept = []  # (delta, round-end params) for client_post
        for j, c in enumerate(idx.tolist()):
            size = self.sizes[c]
            nb = math.ceil(size / B)  # batches per local epoch
            # epoch-sync clients stop after their own budget
            budget = min(nb * self.cfg.federated.num_epochs_per_comm, K) \
                if self.epoch_sync else K
            full_loss = self._full_loss(server.params, c) \
                if alg.needs_full_loss else None
            x = self.data.x[c][rows[j]]
            y = self.data.y[c][rows[j]]
            if alg.needs_val_batch:
                vx = self.val_data.x[c][vrows[j]]
                vy = self.val_data.y[c][vrows[j]]
            params, aux = server.params, tree_take(on_aux, j)
            opt = tree_take(clients.opt, c)
            epoch, li = clients.epoch[c], clients.local_index[c]
            step_loss, step_acc = [], []
            for s in range(budget):
                lr = lr_at(self.schedule, epoch)
                bx, by = x[s * B:(s + 1) * B], y[s * B:(s + 1) * B]
                if self.augment:
                    bx = augment_image_batch(bx, *(d[j, s] for d in draws))
                bvx = bvy = None
                if alg.needs_val_batch:
                    bvx, bvy = vx[s * B:(s + 1) * B], vy[s * B:(s + 1) * B]
                params, opt, aux, loss, acc = alg.local_step(
                    params=params, opt=opt, client_aux=aux,
                    server_params=server.params, server_aux=server.aux,
                    bx=bx, by=by, bval_x=bvx, bval_y=bvy, lr=lr,
                    step_idx=s, local_index=li, step_budget=budget)
                epoch = epoch + 1.0 / nb
                li = li + 1
                step_loss.append(loss)
                step_acc.append(acc)
            with torch.no_grad():
                delta = tree_sub(server.params, params)
                payload, aux = alg.client_payload(
                    delta=delta, client_aux=aux, params=params,
                    server_params=server.params, server_aux=server.aux,
                    lr=lr_at(self.schedule, epoch), local_steps=budget,
                    weight=weights[j], full_loss=full_loss)
            payloads.append(payload)
            client_opts.append(opt)
            client_aux.append(aux)
            budgets.append(budget)
            epochs.append(epoch)
            local_index.append(li)
            losses.append(torch.stack(step_loss).sum() / budget)
            accs.append(torch.stack(step_acc).sum() / budget)
            if self._client_post:
                kept.append((delta, params))

        with torch.no_grad():
            # uplink wire format on the stacked [k] axis, sum, downlink
            stacked = alg.payload_batch_transform(tree_stack(payloads))
            payload_sum = alg.aggregate_transform(
                tree_map(lambda p: p.sum(dim=0), stacked))
            losses, accs = torch.stack(losses), torch.stack(accs)
            new_params, new_opt, new_saux = alg.server_update(
                server.params, server.opt, server.aux, payload_sum,
                online_idx=idx, num_online_eff=num_online_eff,
                client_losses=losses)
            if self._client_post:
                # aux updates that need the transformed sum, each with
                # the client's round-end LR and step budget
                client_aux = [alg.client_post(
                    delta=d, client_aux=a, payload_sum=payload_sum,
                    lr=lr_at(self.schedule, e), local_steps=ks,
                    server_params=server.params, params=p, weight=weights[j])
                    for j, ((d, p), a, e, ks) in enumerate(
                        zip(kept, client_aux, epochs, budgets))]

            # online clients leave holding the aggregated server model
            # (model_server = deepcopy(model_client), fedavg.py:97)
            for n, p in clients.params.items():
                p[rows_dev] = new_params[n]
            tree_put(clients.opt, rows_dev, tree_stack(client_opts))
            tree_put(clients.aux, rows_dev, tree_stack(client_aux))
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
        # the second global phase (DRFA's dual update)
        new_server = alg.post_round_global(new_server, self.data, plan)
        return new_server, clients, metrics

    def _full_loss(self, params, c: int) -> torch.Tensor:
        """qFFL's F_k: the SUM of the per-batch mean losses over client
        ``c``'s whole shard on ``params``, batch by batch in storage
        order, the last batch's rows past its size masked out."""
        B, size = self.batch_size, self.sizes[c]
        x, y = self.data.x[c], self.data.y[c]
        n_max = x.shape[0]
        means = []
        with torch.no_grad():
            for r0 in range(0, size, B):
                # a whole batch of B storage rows (wrapping), as the JAX
                # package forwards it: batch statistics see all B
                frows = torch.arange(r0, r0 + B, device=x.device)
                logits = self.model.apply(params, x[frows % n_max])
                per = per_sample_loss(logits, y[frows % n_max],
                                      self.model.is_regression)
                means.append(per[:min(B, size - r0)].mean())
        return torch.stack(means).sum()

    def round_host_scalars(self, clients: ClientState,
                           metrics: RoundMetrics) -> dict:
        """Everything the CLI's round loop logs, in one transfer (which
        waits for the round): the mean training epoch over the clients,
        the learning rate at it, the online count, the online clients'
        loss and accuracy sums and the uplink bytes (the fault-free
        fields of the JAX package's ``round_scalars_dev``)."""
        mean_epoch = clients.epoch.mean()
        vals = torch.stack([
            mean_epoch, lr_at(self.schedule, mean_epoch),
            metrics.online_mask.sum(), metrics.train_loss.sum(),
            metrics.train_acc.sum(), metrics.comm_bytes]).tolist()
        return dict(zip(("mean_epoch", "lr", "n_online", "loss_sum",
                         "acc_sum", "comm_bytes"), vals))

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
