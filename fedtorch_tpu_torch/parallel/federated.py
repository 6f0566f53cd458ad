"""The federated round engine (port of the synchronous, per-client
path of ``fedtorch_tpu/parallel/federated.py``), on the device data plane
and on the stream plane.

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
hooks and the order of the JAX package's ``_round_core``. With the
update guards on (``guard_updates``), the stacked payloads are screened
on the clients' raw deltas after the uplink wire format; a robust rule
(``robust_agg`` other than 'mean') then takes the place of the sum, and
the guards' (or the rule's) accept mask renormalizes the sum to the full
round weight before the downlink wire format (``robustness/``).
``norm_bound`` keeps its momentum in the server aux, wrapped as the JAX
package wraps it (``{'alg': ..., 'norm_bound_m': ...}``).

Two data planes feed :meth:`FederatedTrainer._round_core`:
``round_fn`` gathers the round's rows from the population on the
device (``data_plane='device'``); ``round_stream_fn`` takes them from a
feed that a background producer packed on the host and copied over
(``data_plane='stream'``, ``data/streaming.py``). The same rows give the
same round. :class:`~fedtorch_tpu_torch.parallel.round_program.
RoundProgramBuilder` decides which cells a trainer serves.

What differs from the JAX package, and why:

* The k clients run one after another in a Python loop over one shared
  module (``torch.func.functional_call`` with each client's params); the
  JAX package vmaps them. A batched or grouped-conv client axis is later
  performance work.
* The round plan is drawn from the server's ``torch.Generator``, not
  threefry, so the two packages pick other cohorts and rows from one
  seed; :meth:`FederatedTrainer.round_fn` takes an injected
  :class:`RoundPlan` so tests can feed both the same cohort. The stream
  plane draws the same plans ahead on a clone of the generator
  (``data/streaming.py`` ``RoundSchedule``).
* The JAX package's 'batch' and 'shard' gather modes select the same
  rows (the flattened ``round_row_plan`` equals per-step ``take_batch``
  over the epoch permutation), so the port has one gather and no
  ``gather_mode``: each client's K*B rows, and as many validation rows
  (the JAX package's ``VAL_FOLD`` stream, in either of its val modes).
  On the stream plane qFFL's feed carries whole shards instead.
* Epoch-sync clients skip the steps past their own budget instead of
  running them masked; state and metrics come out the same, and every
  step-indexed hook anchors on the budget (DRFA's snapshot step).
* Where the JAX package folds PRNG keys for an algorithm (DRFA's
  snapshot step and probe), the port draws from the server's generator
  into the plan (``FedAlgorithm.plan_draws``). So for dropout: where the
  JAX package folds a key per client and step (``fold_in(rng_c, k +
  1)``), the plan holds a ``[k, K]`` int64 dropout key drawn from the
  server's generator, and each step's training forward reseeds a device
  generator with its key (``models/common.py`` ``drop_source``).
* Client state is updated in place (see ``core/state.py``).

Everything of ``_round_core`` that is off on this path — chaos, DP,
availability, pod-scale sharding, cohort stats, client fusion, the async
plane — is refused by name at construction (with no chaos or
availability plane every online client reports: the guards' ``survive``
mask is all ones); so are
the JAX package's bounded retry of a failed gather, its host-fault
seams and its producer rebuild (ROADMAP A7): a gather error reaches the
caller as itself.
"""
from __future__ import annotations

import bisect
import math
import weakref
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
from fedtorch_tpu_torch.data.streaming import (
    HostClientStore, MmapClientStore, RoundFeed, RoundSchedule,
    StreamFeedProducer, StreamItem, np_dtype, window_round,
)
from fedtorch_tpu_torch.models.common import ModelDef
from fedtorch_tpu_torch.ops.augment import augment_image_batch, draw_augment
from fedtorch_tpu_torch.parallel.round_program import (
    RoundProgramBuilder, feed_layout,
)
from fedtorch_tpu_torch.robustness.aggregators import (
    robust_aggregate, unwrap_norm_bound, wrap_norm_bound,
)
from fedtorch_tpu_torch.robustness.guards import (
    renormalize_accepted, screen_payloads,
)
from fedtorch_tpu_torch.utils import resolve_device


class RoundPlan(NamedTuple):
    """What a round consumes of randomness, as CPU tensors: the online
    client ids, each one's K*B storage rows, (augmentation on) the
    per-step flip/crop draws, (DRFA) the shared snapshot step and the
    second phase's cohort and rows, (``needs_val_batch``) each online
    client's K*B validation storage rows, and (a model with dropout) each
    online client's dropout key a step."""
    idx: torch.Tensor                     # [k] int64 online client ids
    rows: torch.Tensor                    # [k, K*B] int64 storage rows
    flip: Optional[torch.Tensor] = None   # [k, K, B] bool
    tops: Optional[torch.Tensor] = None   # [k, K, B] int64 in [0, 8]
    lefts: Optional[torch.Tensor] = None  # [k, K, B] int64 in [0, 8]
    k_rand: Optional[int] = None          # DRFA's snapshot step, [1, K)
    probe_idx: Optional[torch.Tensor] = None   # [k] int64 probe cohort
    probe_rows: Optional[torch.Tensor] = None  # [k, B] int64 its rows
    vrows: Optional[torch.Tensor] = None  # [k, K*B] int64 validation rows
    drop_keys: Optional[torch.Tensor] = None  # [k, K] int64 dropout keys


def sparse_participation(generator: torch.Generator, num_clients: int,
                         k: int) -> torch.Tensor:
    """k ids drawn uniformly without replacement from [0, C) in O(k)
    memory (no [C] permutation): draw i picks a rank ``j ~ U[0, C-i)``
    among the ids not yet chosen and maps it to an id by walking the
    chosen ones in ascending order (``j += 1`` for each chosen id <= j).
    The law of ``randperm(C)[:k]``, another stream (as in the JAX
    package's 'sparse' mode)."""
    chosen, idx = [], []
    for i in range(k):
        j = int(torch.randint(0, num_clients - i, (), generator=generator))
        for s in chosen:
            if j < s:
                break
            j += 1
        bisect.insort(chosen, j)
        idx.append(j)
    return torch.tensor(idx, dtype=torch.int64)


def participation_indices(generator: torch.Generator, num_clients: int,
                          k: int, round_idx: int,
                          mode: str = "perm") -> torch.Tensor:
    """k online clients uniformly without replacement (misc.py:10-19):
    ``mode`` 'perm' takes the first k of a permutation, 'sparse' the
    O(k)-memory draw; round 0 forces client 0 online by replacing the
    last slot (main.py:62-63)."""
    if mode == "sparse":
        idx = sparse_participation(generator, num_clients, k)
    else:
        idx = torch.randperm(num_clients, generator=generator)[:k]
    if round_idx == 0 and not bool((idx == 0).any()):
        idx[k - 1] = 0
    return idx


class PlanDrawer:
    """Draws a round's :class:`RoundPlan` from a generator, in one fixed
    order: the cohort, each online client's rows, the augmentation draws,
    the dropout keys (``dropout``: the model drops), the validation rows,
    the algorithm's own draws. The trainer's
    ``draw_plan`` and the stream plane's host schedule both call it, so
    the two planes draw the same plans. It holds no reference to the
    trainer (the producer thread keeps it)."""

    def __init__(self, algorithm: FedAlgorithm, sizes, n_max: int,
                 k_online: int, local_steps: int, batch_size: int,
                 augment: bool, participation_mode: str = "perm",
                 vsizes=None, v_n_max: Optional[int] = None,
                 dropout: bool = False):
        self.algorithm = algorithm
        self.sizes = list(sizes)
        self.n_max = n_max
        self.k_online = k_online
        self.local_steps = local_steps
        self.batch_size = batch_size
        self.augment = augment
        self.participation_mode = participation_mode
        self.vsizes, self.v_n_max = vsizes, v_n_max
        self.dropout = dropout

    def __call__(self, generator: torch.Generator, round_idx: int,
                 server_aux=None) -> RoundPlan:
        K, B, k = self.local_steps, self.batch_size, self.k_online
        alg, C = self.algorithm, len(self.sizes)
        idx = alg.participation(generator, C, k, round_idx, server_aux)
        if idx is None:
            idx = participation_indices(generator, C, k, round_idx,
                                        self.participation_mode)
        rows = torch.stack([
            round_row_plan(generator, self.sizes[c], self.n_max, K * B)
            for c in idx.tolist()])
        plan = RoundPlan(idx, rows, *(draw_augment(generator, (k, K, B))
                                      if self.augment else ()))
        if self.dropout:
            plan = plan._replace(drop_keys=torch.randint(
                0, 2 ** 62, (k, K), generator=generator))
        if alg.needs_val_batch:
            plan = plan._replace(vrows=torch.stack([
                round_row_plan(generator, self.vsizes[c], self.v_n_max,
                               K * B) for c in idx.tolist()]))
        return plan._replace(**alg.plan_draws(generator, self.sizes))


def unported_features(cfg: ExperimentConfig) -> list:
    """Names of the requested features this port does not have yet (the
    async plane and client fusion are refused by the round-program
    builder, as cells)."""
    fed, flt, mesh = cfg.federated, cfg.fault, cfg.mesh
    checks = [
        (flt.chaos_enabled, "chaos (client_drop/straggler/nan_inject/"
                            "byzantine rates)"),
        (flt.dp_armed, "DP (dp_noise_multiplier)"),
        (flt.avail_armed, "availability (avail_* / over_select_frac)"),
        (mesh.client_shards != 0, "client_shards"),
        (cfg.telemetry.cohort_stats, "cohort stats"),
    ]
    return [name for bad, name in checks if bad]


class FederatedTrainer:
    """Runs the round program on ``device`` (``cuda`` unless the caller
    asks for another).

    With ``cfg.data.data_plane == 'stream'`` the population stays on the
    host — ``data`` in RAM (``data.store == 'ram'``) or the on-disk store
    at ``cfg.data.store_dir`` (``'mmap'``; ``data`` then gives only its
    shape and sizes) — and :meth:`run_round` / :meth:`run_rounds` consume
    feeds from a background producer, started on first use from the live
    (generator, round) and up to ``stream_depth`` feeds ahead. Call
    :meth:`invalidate_stream` after replaying or rewriting the server
    state, and :meth:`close` at the end (a dropped trainer closes its
    producer too)."""

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
        self.cfg = cfg
        self.algorithm = algorithm
        self.data_plane = cfg.data.data_plane
        self.has_val = val_data is not None
        self.programs = RoundProgramBuilder(self)
        self.programs.validate(
            "commit" if cfg.federated.sync_mode == "async" else "round")
        self.device = resolve_device(device)
        if model.sample_input.device != self.device:
            raise ValueError(f"the model lives on "
                             f"{model.sample_input.device}, the trainer "
                             f"on {self.device}")
        self.model = model
        self.num_clients = data.num_clients
        self.batch_size = cfg.data.batch_size
        self.k_online = max(
            int(cfg.federated.online_client_rate * self.num_clients), 1)
        self.participation_mode = cfg.federated.participation_mode
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
        self.fault = cfg.fault
        self.guard_on = cfg.fault.guard_updates
        self.robust_rule = cfg.fault.robust_agg
        self.robust_momentum = self.robust_rule == "norm_bound"
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
        self.vsizes = [int(s) for s in val_data.sizes] \
            if val_data is not None else None
        if self.data_plane == "stream":
            # the device never holds the population: each round gets
            # its feed, and only client state is [C]-sized on the device
            self.host_store = self._open_store(cfg, data)
            self.data = self.val_data = None
        else:
            self.host_store = None
            self.data = data.to(self.device)
            self.val_data = val_data.to(self.device) \
                if val_data is not None else None
        self.feed_layout = feed_layout(algorithm)
        # the stream plane's producer: feeds queued ahead, and how long
        # a consumer waits for one before it raises
        self.stream_depth = 2
        self.stream_timeout_s = 120.0
        self._stream: Optional[StreamFeedProducer] = None
        self._stream_finalizer = None

    @staticmethod
    def _open_store(cfg, data: ClientData):
        if cfg.data.store != "mmap":
            return HostClientStore(data)
        store = MmapClientStore(cfg.data.store_dir)
        if (store.num_clients != data.num_clients
                or store.n_max != data.n_max):
            raise ValueError(
                f"mmap client store at {cfg.data.store_dir!r} "
                f"holds [{store.num_clients}, {store.n_max}] "
                "clients x rows but the run's data is "
                f"[{data.num_clients}, {data.n_max}]")
        for name, t in (("x", data.x), ("y", data.y)):
            want = (tuple(t.shape[2:]), np_dtype(t.dtype))
            if (store.feat(name), store.dtype(name)) != want:
                raise ValueError(
                    f"mmap client store at {cfg.data.store_dir!r} holds "
                    f"{name} rows of {store.feat(name)} "
                    f"{store.dtype(name)} but the run's are {want[0]} "
                    f"{want[1]}")
        return store

    # -- state ----------------------------------------------------------
    def init_state(self, rng):
        """Fresh (server, clients). ``rng`` is a ``torch.Generator`` or
        an int seed; the server keeps the generator and draws the round
        plans from it."""
        gen = rng if isinstance(rng, torch.Generator) \
            else torch.Generator().manual_seed(int(rng))
        params = self.model.init(gen)
        ocfg = self.cfg.optim
        aux = self.algorithm.init_server_aux(params, self.num_clients)
        if self.robust_momentum:
            aux = wrap_norm_bound(aux, params)
        server = ServerState(
            params=params, opt=optim.init_opt_state(params, ocfg),
            aux=aux, round=0, rng=gen)
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

    def plan_drawer(self) -> PlanDrawer:
        """The plan drawer for the trainer's current sizes, steps and
        batch size."""
        rows_of = self.data if self.data is not None else self.host_store
        return PlanDrawer(
            self.algorithm, self.sizes, rows_of.n_max, self.k_online,
            self.local_steps, self.batch_size, self.augment,
            self.participation_mode, self.vsizes,
            self.val_data.n_max if self.val_data is not None else None,
            self.model.has_dropout)

    def _alg_aux(self, aux):
        """The algorithm's server aux (``norm_bound`` wraps it)."""
        return unwrap_norm_bound(aux)[0] if self.robust_momentum else aux

    def draw_plan(self, server: ServerState) -> RoundPlan:
        """This round's plan from the server's generator."""
        return self.plan_drawer()(server.rng, server.round,
                                  self._alg_aux(server.aux))

    # -- one communication round -----------------------------------------
    def round_fn(self, server: ServerState, clients: ClientState,
                 plan: Optional[RoundPlan] = None):
        """One round on the device plane: returns (server', clients,
        metrics). ``clients`` is updated in place and returned. ``plan``
        (default: drawn from ``server.rng``) fixes the cohort, rows,
        augmentation draws and the algorithm's own draws."""
        if plan is None:
            plan = self.draw_plan(server)
        data, dev = self.data, self.device
        idx = plan.idx.to(torch.int64)
        on = idx.to(dev)[:, None]
        rows = plan.rows.to(dev)
        pre_x = pre_y = None
        if self._pre_round:
            # each online client's first B storage rows (the JAX
            # package clamps rows past n_max)
            first = torch.arange(self.batch_size, device=dev).clamp_max(
                data.n_max - 1)[None, :]
            pre_x, pre_y = data.x[on, first], data.y[on, first]
        shards = [(data.x[c], data.y[c]) for c in idx.tolist()] \
            if self.algorithm.needs_full_loss else None
        return self._round_core(server, clients, plan, data.x[on, rows],
                                data.y[on, rows], pre_x, pre_y, shards)

    def round_stream_fn(self, server: ServerState, clients: ClientState,
                        feed: RoundFeed):
        """One round on the stream plane, from a packed feed (rows and
        plan on the host, tensors on the device): the round core of
        :meth:`round_fn` on the feed's rows. ``server.rng`` is left as
        it is; :meth:`run_round` advances it."""
        dev = self.device
        plan = RoundPlan(
            feed.idx.to(torch.int64), feed.rows, feed.flip, feed.tops,
            feed.lefts,
            None if feed.k_rand is None else int(feed.k_rand),
            None if feed.probe_idx is None else feed.probe_idx.long(),
            feed.probe_rows, drop_keys=feed.drop_keys)
        x, y, shards = feed.x, feed.y, None
        if self.feed_layout == "shard":
            # whole shards: the round's rows are selected here
            on = torch.arange(plan.idx.shape[0], device=dev)[:, None]
            rows = plan.rows.to(dev)
            x, y = feed.x[on, rows], feed.y[on, rows]
            shards = list(zip(feed.x, feed.y))
        return self._round_core(
            server, clients, plan, x, y, feed.pre_x, feed.pre_y, shards,
            probe=feed if feed.probe_idx is not None else None)

    def _round_core(self, server: ServerState, clients: ClientState,
                    plan: RoundPlan, x, y, pre_x, pre_y, shards=None,
                    probe: Optional[RoundFeed] = None):
        """The round on gathered rows: ``x``/``y`` [k, K*B, ...] in plan
        order, ``pre_x``/``pre_y`` [k, B, ...] (when ``pre_round`` runs),
        ``shards`` each online client's (x, y) shard (qFFL's full loss),
        ``probe`` the feed whose probe batches DRFA's dual update takes
        (None: ``post_round_global`` on the resident data)."""
        alg, dev = self.algorithm, self.device
        K, B, C = self.local_steps, self.batch_size, self.num_clients
        robust_m = None
        if self.robust_momentum:
            # every algorithm hook reads the unwrapped aux
            alg_aux, robust_m = unwrap_norm_bound(server.aux)
            server = server._replace(aux=alg_aux)
        idx = plan.idx.to(torch.int64)
        k = idx.shape[0]
        num_online_eff = num_online_effective(idx)
        on_sizes = torch.tensor([self.sizes[c] for c in idx.tolist()])
        weights = alg.client_weights(server.aux, idx, num_online_eff,
                                     on_sizes).to(dev)
        rows_dev = idx.to(dev)
        if self.augment:
            draws = [t.to(dev) for t in (plan.flip, plan.tops, plan.lefts)]

        if alg.needs_val_batch:
            vrows = plan.vrows.to(dev)

        # the cross-client hook on the online clients' gathered aux and
        # first B storage rows
        on_aux = tree_take(clients.aux, rows_dev)
        if self._pre_round:
            on_lrs = torch.stack([lr_at(self.schedule, clients.epoch[c])
                                  for c in idx.tolist()])
            on_aux = alg.pre_round(
                on_aux, server=server, x=pre_x, y=pre_y, sizes=on_sizes,
                lr=on_lrs, plan=plan)

        payloads, client_opts, client_aux, budgets = [], [], [], []
        epochs, local_index, losses, accs = [], [], [], []
        kept = []  # (delta, round-end params) for client_post
        deltas = []  # the raw deltas the guards judge
        for j, c in enumerate(idx.tolist()):
            size = self.sizes[c]
            nb = math.ceil(size / B)  # batches per local epoch
            # epoch-sync clients stop after their own budget
            budget = min(nb * self.cfg.federated.num_epochs_per_comm, K) \
                if self.epoch_sync else K
            full_loss = self._full_loss(server.params, *shards[j], size) \
                if alg.needs_full_loss else None
            xj, yj = x[j], y[j]
            if alg.needs_val_batch:
                vx = self.val_data.x[c][vrows[j]]
                vy = self.val_data.y[c][vrows[j]]
            params, aux = server.params, tree_take(on_aux, j)
            opt = tree_take(clients.opt, c)
            epoch, li = clients.epoch[c], clients.local_index[c]
            # a recurrent model's hidden state: fresh each round, carried
            # through this client's steps
            carry = self.model.init_carry(B)
            step_loss, step_acc = [], []
            for s in range(budget):
                lr = lr_at(self.schedule, epoch)
                bx, by = xj[s * B:(s + 1) * B], yj[s * B:(s + 1) * B]
                if self.augment:
                    bx = augment_image_batch(bx, *(d[j, s] for d in draws))
                bvx = bvy = None
                if alg.needs_val_batch:
                    bvx, bvy = vx[s * B:(s + 1) * B], vy[s * B:(s + 1) * B]
                rng = None if plan.drop_keys is None \
                    else int(plan.drop_keys[j, s])
                params, opt, aux, carry, loss, acc = alg.local_step(
                    params=params, opt=opt, client_aux=aux, rnn_carry=carry,
                    server_params=server.params, server_aux=server.aux,
                    bx=bx, by=by, bval_x=bvx, bval_y=bvy, lr=lr,
                    step_idx=s, local_index=li, step_budget=budget,
                    rng=rng)
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
            if self.guard_on:
                deltas.append(delta)

        with torch.no_grad():
            # uplink wire format on the stacked [k] axis
            stacked = alg.payload_batch_transform(tree_stack(payloads))
            payload_sum, new_robust_m, fault_counts = self._aggregate(
                stacked, deltas, weights, robust_m)
            # the downlink wire format, once, whatever the rule
            payload_sum = alg.aggregate_transform(payload_sum)
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

            # per-client metric leaves: 'perm' scatters into [C],
            # 'sparse' keeps the cohort-aligned [k] rows (every client of
            # the cohort reports: no chaos or availability plane here)
            if self.participation_mode == "sparse":
                online = torch.ones(k, device=dev)
                loss_m, acc_m = losses, accs
            else:
                online = torch.zeros(C, device=dev)
                online[rows_dev] = 1.0
                loss_m = torch.zeros(C, device=dev).index_put(
                    (rows_dev,), losses)
                acc_m = torch.zeros(C, device=dev).index_put(
                    (rows_dev,), accs)
            metrics = RoundMetrics(
                train_loss=loss_m, train_acc=acc_m, online_mask=online,
                comm_bytes=torch.tensor(
                    tree_bytes(server.params) * k * alg.payload_scale(),
                    dtype=torch.float32, device=dev),
                **dict(zip(("rejected_updates", "clipped_updates",
                            "robust_selected", "robust_trimmed"),
                           fault_counts.unbind())))
        new_server = ServerState(params=new_params, opt=new_opt,
                                 aux=new_saux, round=server.round + 1,
                                 rng=server.rng)
        # the second global phase (DRFA's dual update)
        if probe is not None:
            new_server = alg.post_round_global_feed(new_server, probe)
        else:
            new_server = alg.post_round_global(new_server, self.data, plan)
        if self.robust_momentum:
            # the updated center rides the server aux
            new_server = new_server._replace(aux={
                "alg": new_server.aux, "norm_bound_m": new_robust_m})
        return new_server, clients, metrics

    def _aggregate(self, stacked, deltas, weights, robust_m):
        """The aggregation seam on the stacked [k] wire payloads: with
        the guards on, screen them on the raw ``deltas`` (every online
        client reports: ``survive`` is all ones); then the robust rule,
        or the plain sum renormalized over the accepted clients. Returns
        (sum, the new ``norm_bound`` momentum or None, the [4] counts
        rejected, clipped, selected, trimmed)."""
        k = weights.shape[0]
        counts = torch.zeros(4, device=weights.device)
        accept = None
        if self.guard_on:
            stacked, report = screen_payloads(
                tree_stack(deltas), stacked,
                torch.ones(k, device=weights.device), self.fault)
            accept = report.accept
            counts[0], counts[1] = report.rejected, report.clipped
        if self.robust_rule != "mean":
            payload_sum, new_m, rep = robust_aggregate(
                self.robust_rule, stacked, weights,
                accept if accept is not None else torch.ones_like(weights),
                self.fault, momentum=robust_m)
            counts[2], counts[3] = rep.selected, rep.trimmed
            return payload_sum, new_m, counts
        payload_sum = tree_map(lambda p: p.sum(dim=0), stacked)
        if accept is not None:
            # rejected weight redistributed over the accepted clients;
            # an all-rejected round sums to 0 and the server holds
            payload_sum = renormalize_accepted(payload_sum, weights, accept)
        return payload_sum, None, counts

    def _full_loss(self, params, x, y, size: int) -> torch.Tensor:
        """qFFL's F_k: the SUM of the per-batch mean losses over one
        client's whole shard (``x``/``y`` [n_max, ...]) on ``params``,
        batch by batch in storage order, the last batch's rows past its
        ``size`` masked out; a recurrent model from a fresh carry each
        batch."""
        B = self.batch_size
        n_max = x.shape[0]
        means = []
        with torch.no_grad():
            for r0 in range(0, size, B):
                # a whole batch of B storage rows (wrapping), as the JAX
                # package forwards it: batch statistics see all B
                frows = torch.arange(r0, r0 + B, device=x.device)
                logits = self.model.forward(params, x[frows % n_max])
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
            metrics.train_acc.sum(), metrics.comm_bytes,
            metrics.rejected_updates, metrics.clipped_updates,
            metrics.robust_selected, metrics.robust_trimmed]).tolist()
        # no chaos plane: nothing drops
        return dict(zip(("mean_epoch", "lr", "n_online", "loss_sum",
                         "acc_sum", "comm_bytes", "rejected", "clipped",
                         "robust_selected", "robust_trimmed"), vals),
                    dropped=0.0)

    @property
    def metrics_width(self) -> int:
        """Leading dim of the per-client :class:`RoundMetrics` leaves:
        [C] in 'perm' mode, the cohort-aligned [k] in 'sparse' mode (the
        JAX package's ``metrics_width``)."""
        return self.k_online if self.participation_mode == "sparse" \
            else self.num_clients

    # -- the stream plane's feeds ------------------------------------------
    def next_stream_item(self, server: ServerState,
                         window: int = 0) -> StreamItem:
        """The producer's next feed (``window == 0``, one round) or feed
        window (``window`` rounds). The producer is (re)started from the
        live generator and round on first use, after
        :meth:`invalidate_stream`, and when the window changes (feeds
        are sequential per producer)."""
        if self._stream is not None and self._stream.window != window:
            self.invalidate_stream()
        if self._stream is None:
            self._stream = StreamFeedProducer(
                self.host_store, batch_size=self.batch_size,
                start_round=server.round,
                schedule=RoundSchedule(self.plan_drawer(), server.rng,
                                       server.round),
                depth=self.stream_depth, window=window,
                feed_layout=self.feed_layout, device=self.device,
                timeout_s=self.stream_timeout_s)
            # a trainer dropped without close() must not leave the
            # producer thread running (the producer holds no reference
            # back to the trainer)
            self._stream_finalizer = weakref.finalize(
                self, StreamFeedProducer.close, self._stream)
        return self._stream.next_feed()

    def consume_stream_round(self, server: ServerState,
                             clients: ClientState, item: StreamItem,
                             r: Optional[int] = None):
        """Round ``r`` of a feed window (``r`` None: a one-round feed):
        check that the feed is this round's and that the server's
        generator stands where the schedule's stood before the round's
        draws, set it to where the draws left it, and run the round."""
        before, after = item.rng[0 if r is None else r]
        label = item.label + (r or 0)
        if label != server.round or not torch.equal(
                before, server.rng.get_state()):
            self.invalidate_stream()
            raise RuntimeError(
                f"stream feed for round {label} does not match the server "
                f"state at round {server.round}: the round or the "
                "generator moved outside the producer's schedule (call "
                "invalidate_stream after replaying or rewriting state)")
        server.rng.set_state(after)
        feed = item.feed if r is None else window_round(item.feed, r)
        return self.round_stream_fn(server, clients, feed)

    def invalidate_stream(self) -> None:
        """Drop the producer and every prefetched feed; the next streamed
        round restarts it from the live state. Call after replaying a
        round on saved state or rewriting the server's round or
        generator. No-op on the device plane."""
        if self._stream is not None:
            self._stream_finalizer.detach()
            self._stream_finalizer = None
            self._stream.close()
            self._stream = None

    def close(self) -> None:
        """Stop the stream plane's producer (no-op on the device
        plane)."""
        self.invalidate_stream()

    def stream_stats(self) -> Optional[dict]:
        """The producer's host counters (``StreamFeedProducer.stats``),
        or None on the device plane and before the first streamed
        round."""
        return self._stream.stats() if self._stream is not None else None

    # -- host-side round loop ---------------------------------------------
    def run_round(self, server, clients):
        """One communication round on the trainer's data plane. On the
        stream plane each call consumes the producer's next feed, so
        calls must advance the state round by round; replaying a round
        on saved state needs :meth:`invalidate_stream` first."""
        if self.data_plane == "stream":
            item = self.next_stream_item(server)
            return self.consume_stream_round(server, clients, item)
        return self.round_fn(server, clients)

    def run_rounds(self, server, clients, num_rounds: int):
        """``num_rounds`` rounds through the scan cell of the round
        program (on the stream plane: one feed window of
        ``num_rounds`` rounds); metrics come back with a leading
        [num_rounds] axis, as the JAX package's scanned round program
        returns them."""
        if num_rounds < 1:
            # refused before a feed is consumed
            raise ValueError(
                f"run_rounds needs num_rounds >= 1, got {num_rounds}")
        fn = self.programs.build("scan", scan_length=num_rounds)
        return fn(server, clients)
