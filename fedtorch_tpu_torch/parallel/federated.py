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
package wraps it (``{'alg': ..., 'norm_bound_m': ...}``). The fault
planes compose at the wire and the aggregation seam in the JAX order:
chaos (crashes, straggler step cuts, nan poison, byzantine uploads),
the availability lifecycle (over-selection to ``k'`` dispatched
clients, dropouts, the deadline on the first ``k_online`` arrivals, the
quorum flag) and DP-FedAvg (accept mask -> DP clip -> robust rule ->
DP noise).

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

* The fault planes (``robustness/{chaos,availability,privacy}.py``):
  where the JAX package folds the round key (``chaos_salt``,
  ``AVAIL_SYNC_SALT``, ``AVAIL_DROP_SALT``, ``DP_SALT``), the plan holds
  uniforms and seeds drawn from the server's generator after everything
  above, each only when its knob is armed, in this order: the chaos
  uniforms (``u_crash``, ``u_strag``, ``u_nan``, [k'] each, a class only
  when its rate is above 0), the availability uniforms (``u_avail``
  [k', 2] and, where the model draws it, ``u_drop`` [k']), the gauss
  attack's seed (``byzantine_mode='gauss'``) and the DP noise's seed. A
  disarmed ``FaultConfig()`` draws nothing more, so its plans are the
  fault-free plans. What is fixed for a run (the byzantine cohort, each
  client's device class and diurnal phase) is hashed off one int64
  fault key that ``init_state`` draws after the params (only when
  ``byzantine_rate > 0`` or ``avail_model == 'trace'``) and keeps in the
  server aux, wrapped as the JAX package wraps its ``norm_bound``
  momentum and DP noise scale: ``{'alg': ..., 'norm_bound_m': ...,
  'dp_noise_scale': ..., 'fault_key': ...}``, each member only when
  armed. The per-leaf normals of the DP noise and the gauss attack are
  drawn on the round's device from the plan's seed, or taken from the
  plan's ``noise`` (tests inject the JAX package's).
* Every dispatched client trains, also one that crashes or drops out,
  as the JAX package's vmap does; only the clients that keep their
  round (not crashed, not dropped out) have their state written back.

Pod-scale sharding, cohort stats, client fusion and the async plane are
refused by name at construction. On the stream plane a producer that
died (its gather exhausted the ``stream.gather`` retries, it wedged past
``stream_timeout_s``, or it desynced) is rebuilt from the live
(generator, round) up to ``fault.host_retry_max`` times a pop
(:meth:`FederatedTrainer._pop_stream_with_rebuild`, the JAX package's
``federated.py:1617-1644``); the rebuilt producer replays the same plans,
which :meth:`FederatedTrainer.consume_stream_round` checks against the
generator, so recovery is bitwise.
"""
from __future__ import annotations

import bisect
import math
import weakref
from typing import NamedTuple, Optional

import numpy as np
import torch

from fedtorch_tpu_torch import telemetry
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
    FAULT_SEEDS, FAULT_TENSORS, HostClientStore, MmapClientStore, RoundFeed,
    RoundSchedule, StreamFeedProducer, StreamItem, np_dtype, window_round,
)
from fedtorch_tpu_torch.models.common import ModelDef
from fedtorch_tpu_torch.ops.augment import augment_image_batch, draw_augment
from fedtorch_tpu_torch.parallel.round_program import (
    RoundProgramBuilder, feed_layout,
)
from fedtorch_tpu_torch.robustness import (
    availability, chaos, host_recovery,
)
from fedtorch_tpu_torch.robustness.aggregators import robust_aggregate
from fedtorch_tpu_torch.robustness.guards import (
    mask_bcast, renormalize_accepted, screen_payloads,
)
from fedtorch_tpu_torch.robustness.privacy import (
    dp_add_noise, dp_clip_payloads, dp_noise_stddev,
)
from fedtorch_tpu_torch.utils import resolve_device


class RoundPlan(NamedTuple):
    """What a round consumes of randomness, as CPU tensors: the
    dispatched client ids (k' of them: ``k_online``, or more under
    over-selection), each one's K*B storage rows, (augmentation on) the
    per-step flip/crop draws, (DRFA) the shared snapshot step and the
    second phase's cohort and rows, (``needs_val_batch``) each client's
    K*B validation storage rows, (a model with dropout) each client's
    dropout key a step, and the armed fault planes' uniforms and seeds
    (the module docstring gives their order). ``noise`` is never drawn:
    it injects standard normals, by the port's leaf names, in place of
    those the seeds would draw (``{"dp": {...}}``, and for the gauss
    attack ``{"deltas": {...}, "payloads": {...}}``)."""
    idx: torch.Tensor                     # [k'] int64 dispatched client ids
    rows: torch.Tensor                    # [k', K*B] int64 storage rows
    flip: Optional[torch.Tensor] = None   # [k', K, B] bool
    tops: Optional[torch.Tensor] = None   # [k', K, B] int64 in [0, 8]
    lefts: Optional[torch.Tensor] = None  # [k', K, B] int64 in [0, 8]
    k_rand: Optional[int] = None          # DRFA's snapshot step, [1, K)
    probe_idx: Optional[torch.Tensor] = None   # [k] int64 probe cohort
    probe_rows: Optional[torch.Tensor] = None  # [k, B] int64 its rows
    vrows: Optional[torch.Tensor] = None  # [k', K*B] int64 validation rows
    drop_keys: Optional[torch.Tensor] = None  # [k', K] int64 dropout keys
    u_crash: Optional[torch.Tensor] = None  # [k'] float32 crash uniforms
    u_strag: Optional[torch.Tensor] = None  # [k'] float32 straggler
    u_nan: Optional[torch.Tensor] = None    # [k'] float32 nan poison
    u_avail: Optional[torch.Tensor] = None  # [k', 2] float32 arrival
    u_drop: Optional[torch.Tensor] = None   # [k'] float32 dropout
    byz_seed: Optional[int] = None        # the gauss attack's noise seed
    dp_seed: Optional[int] = None         # the DP noise's seed
    noise: Optional[dict] = None          # injected standard normals



def draw_fault_plan(generator: torch.Generator, k: int, fault,
                    avail_sync: bool) -> dict:
    """The armed fault planes' draws of one round as :class:`RoundPlan`
    fields, in the order of the fields, each only when its knob is
    armed: nothing at all for a disarmed ``FaultConfig()``."""
    out = {}
    for name, rate in (("u_crash", fault.client_drop_rate),
                       ("u_strag", fault.straggler_rate),
                       ("u_nan", fault.nan_inject_rate)):
        if rate > 0.0:
            out[name] = torch.rand(k, generator=generator)
    if avail_sync:
        out["u_avail"] = torch.rand(k, 2, generator=generator)
        if fault.avail_model == "trace" or fault.avail_dropout_rate > 0.0:
            out["u_drop"] = torch.rand(k, generator=generator)
    if fault.byzantine_rate > 0.0 and fault.byzantine_mode == "gauss":
        out["byz_seed"] = int(torch.randint(0, 2 ** 62, (),
                                            generator=generator))
    if fault.dp_armed:
        out["dp_seed"] = int(torch.randint(0, 2 ** 62, (),
                                           generator=generator))
    return out


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
    order: the cohort of ``k`` dispatched clients, each one's rows, the
    augmentation draws, the dropout keys (``dropout``: the model drops),
    the validation rows, the algorithm's own draws, then the armed fault
    planes' (:func:`draw_fault_plan`; ``fault`` None: none). The
    trainer's ``draw_plan`` and the stream plane's host schedule both
    call it, so the two planes draw the same plans. It holds no reference
    to the trainer (the producer thread keeps it)."""

    def __init__(self, algorithm: FedAlgorithm, sizes, n_max: int,
                 k: int, local_steps: int, batch_size: int,
                 augment: bool, participation_mode: str = "perm",
                 vsizes=None, v_n_max: Optional[int] = None,
                 dropout: bool = False, fault=None,
                 avail_sync: bool = False):
        self.algorithm = algorithm
        self.sizes = list(sizes)
        self.n_max = n_max
        self.k = k
        self.local_steps = local_steps
        self.batch_size = batch_size
        self.augment = augment
        self.participation_mode = participation_mode
        self.vsizes, self.v_n_max = vsizes, v_n_max
        self.dropout = dropout
        self.fault, self.avail_sync = fault, avail_sync

    def __call__(self, generator: torch.Generator, round_idx: int,
                 server_aux=None) -> RoundPlan:
        K, B, k = self.local_steps, self.batch_size, self.k
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
        plan = plan._replace(**alg.plan_draws(generator, self.sizes))
        if self.fault is not None:
            plan = plan._replace(**draw_fault_plan(
                generator, k, self.fault, self.avail_sync))
        return plan


def unported_features(cfg: ExperimentConfig) -> list:
    """Names of the requested features this port does not have yet (the
    async plane and client fusion are refused by the round-program
    builder, as cells)."""
    mesh = cfg.mesh
    checks = [
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
        # the availability lifecycle (robustness/availability.py): the
        # round dispatches k' = ceil(over_select_frac * k_online)
        # clients and closes on the first k_online arrivals
        flt = cfg.fault
        self.avail_sync = flt.avail_armed
        self.k_dispatch = max(math.ceil(
            flt.over_select_frac * self.k_online), self.k_online) \
            if self.avail_sync else self.k_online
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
        self.fault = flt
        self.chaos_on = flt.chaos_enabled
        self.guard_on = flt.guard_updates
        self.robust_rule = flt.robust_agg
        self.robust_momentum = self.robust_rule == "norm_bound"
        self.dp_on = flt.dp_armed
        # what is fixed for a run (the byzantine cohort, the trace
        # model's device classes) is hashed off a fault key in the
        # server aux
        self.fault_keyed = flt.byzantine_rate > 0.0 \
            or (self.avail_sync and flt.avail_model == "trace")
        # the server aux is wrapped ({'alg': aux, ...}) when it carries
        # any of the norm_bound momentum, the DP noise scale or the key
        self.aux_wrapped = self.robust_momentum or self.dp_on \
            or self.fault_keyed
        self._cohort = None  # (fault key, [C] byzantine mask), cached
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
        self._stream_rebuilds = 0

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
        if self.aux_wrapped:
            aux = {"alg": aux}
            if self.robust_momentum:
                # the first round clips toward the origin at the
                # median-update radius
                aux["norm_bound_m"] = tree_map(torch.zeros_like, params)
            if self.dp_on:
                # 1.0 armed; the budget's 'degrade' sets 0.0
                # (dp_set_noise_scale)
                aux["dp_noise_scale"] = torch.tensor(
                    1.0, dtype=torch.float32, device=self.device)
            if self.fault_keyed:
                aux["fault_key"] = torch.randint(0, 2 ** 62, (),
                                                 generator=gen)
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
            self.algorithm, self.sizes, rows_of.n_max, self.k_dispatch,
            self.local_steps, self.batch_size, self.augment,
            self.participation_mode, self.vsizes,
            self.val_data.n_max if self.val_data is not None else None,
            self.model.has_dropout, self.fault, self.avail_sync)

    def _alg_aux(self, aux):
        """The algorithm's server aux (unwrapped)."""
        return aux["alg"] if self.aux_wrapped else aux

    def _byzantine_cohort(self, fault_key: int) -> torch.Tensor:
        """[C] float32 mask of the run's byzantine cohort, from its fault
        key (cached: the key is fixed for a run)."""
        if self._cohort is None or self._cohort[0] != fault_key:
            u = chaos.cohort_uniforms(fault_key, self.num_clients)
            self._cohort = (fault_key, chaos.byzantine_cohort_mask(
                u, self.fault.byzantine_rate))
        return self._cohort[1]

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
            feed.probe_rows, drop_keys=feed.drop_keys,
            **{f: getattr(feed, f) for f in FAULT_TENSORS},
            **{f: None if getattr(feed, f) is None
               else int(getattr(feed, f)) for f in FAULT_SEEDS})
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
        """The round on gathered rows: ``x``/``y`` [k', K*B, ...] in plan
        order, ``pre_x``/``pre_y`` [k', B, ...] (when ``pre_round``
        runs), ``shards`` each dispatched client's (x, y) shard (qFFL's
        full loss), ``probe`` the feed whose probe batches DRFA's dual
        update takes (None: ``post_round_global`` on the resident
        data)."""
        alg, dev, flt = self.algorithm, self.device, self.fault
        K, B, C = self.local_steps, self.batch_size, self.num_clients
        extras = {}
        if self.aux_wrapped:
            # every algorithm hook reads the unwrapped aux
            extras = {n: v for n, v in server.aux.items() if n != "alg"}
            server = server._replace(aux=server.aux["alg"])
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

        # the fault planes' decisions, on the host from the plan's
        # uniforms (robustness/chaos.py, availability.py)
        cplan = chaos.draw_chaos_plan(k, flt, plan.u_crash, plan.u_strag,
                                      plan.u_nan) \
            if self.chaos_on else chaos.no_chaos_plan(k)
        if flt.byzantine_rate > 0.0:
            # the run's fixed cohort; the plan carries its online slice
            cplan = cplan._replace(byzantine=self._byzantine_cohort(
                int(extras["fault_key"]))[idx])
        avail = None
        if self.avail_sync:
            class_u = availability.class_uniforms(
                int(extras["fault_key"]), idx) \
                if flt.avail_model == "trace" else None
            avail = availability.sync_lifecycle(
                plan.u_avail, plan.u_drop, class_u, server.round, flt,
                self.k_online)
        # reporters: not crashed, and (availability armed) arrived by
        # the deadline; a crash or a dropout leaves the client's state
        # as it was at round start, a deadline miss keeps what it
        # trained
        survive = cplan.survive if avail is None \
            else cplan.survive * avail[0].to(torch.float32)
        keep = cplan.survive.bool() if avail is None \
            else cplan.survive.bool() & ~avail[1]
        budget_scale = cplan.budget_scale.tolist()

        # the cross-client hook on the dispatched clients' gathered aux
        # and first B storage rows
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
            if flt.straggler_rate > 0.0:
                # a straggler's cut, in float32 as the JAX package's
                budget = max(math.ceil(float(
                    np.float32(budget) * np.float32(budget_scale[j]))), 1)
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
            stacked = tree_stack(payloads)
            # what the guards judge: the deltas as the server saw them
            wire_deltas = tree_stack(deltas) if self.guard_on else None
            if flt.byzantine_rate > 0.0:
                # an adversary crafts what it sends, before the wire
                # format; its local state stays honest
                wire_deltas, stacked = chaos.apply_byzantine(
                    chaos.ChaosPlan(*(t.to(dev) for t in cplan)),
                    wire_deltas, stacked, weights, flt, seed=plan.byz_seed,
                    noise=plan.noise)
            nan_dev = cplan.nan_inject.to(dev) \
                if flt.nan_inject_rate > 0.0 else None
            if nan_dev is not None and wire_deltas is not None:
                wire_deltas = chaos.poison_tree(wire_deltas, nan_dev)
            # uplink wire format on the stacked [k'] axis
            stacked = alg.payload_batch_transform(stacked)
            if nan_dev is not None:
                # a fried wire trumps whatever was on it
                stacked = chaos.poison_tree(stacked, nan_dev)
            survive_dev = survive.to(dev) \
                if self.chaos_on or self.avail_sync else None
            payload_sum, new_robust_m, fault_counts, accept, dp_frac = \
                self._aggregate(stacked, wire_deltas, weights,
                                extras.get("norm_bound_m"), survive_dev)
            # the downlink wire format, once, whatever the rule
            payload_sum = alg.aggregate_transform(payload_sum)
            dp_sigma = None
            if self.dp_on:
                # noise on the released estimate, at the round's real
                # width k_online
                scale = extras["dp_noise_scale"]
                sigma = dp_noise_stddev(self.fault.dp_noise_multiplier,
                                        self.fault.dp_clip_norm,
                                        self.k_online)
                payload_sum = dp_add_noise(
                    payload_sum, plan.dp_seed, weights, sigma, scale,
                    noise=(plan.noise or {}).get("dp"))
                dp_sigma = (sigma * scale).to(torch.float32)
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

            # the clients that keep their round leave holding the
            # aggregated server model (model_server =
            # deepcopy(model_client), fedavg.py:97); a crashed or
            # dropped-out client's rows are not written
            js = [j for j in range(k) if keep[j]]
            if js:
                rows_keep = rows_dev if len(js) == k \
                    else idx[js].to(dev)

                def kept_rows(items):
                    return items if len(js) == k else [items[j] for j in js]
                for n, p in clients.params.items():
                    p[rows_keep] = new_params[n]
                tree_put(clients.opt, rows_keep,
                         tree_stack(kept_rows(client_opts)))
                tree_put(clients.aux, rows_keep,
                         tree_stack(kept_rows(client_aux)))
                clients.epoch[rows_keep] = torch.stack(kept_rows(epochs))
                clients.local_index[rows_keep] = torch.stack(
                    kept_rows(local_index))

            metrics = self._round_metrics(
                server, k, rows_dev, losses, accs, cplan, survive, avail,
                accept, fault_counts, dp_frac, dp_sigma)
        new_server = ServerState(params=new_params, opt=new_opt,
                                 aux=new_saux, round=server.round + 1,
                                 rng=server.rng)
        # the second global phase (DRFA's dual update)
        if probe is not None:
            new_server = alg.post_round_global_feed(new_server, probe)
        else:
            new_server = alg.post_round_global(new_server, self.data, plan)
        if self.aux_wrapped:
            # the updated norm_bound center, the noise scale and the
            # fault key ride the server aux
            if self.robust_momentum:
                extras["norm_bound_m"] = new_robust_m
            new_server = new_server._replace(
                aux={"alg": new_server.aux, **extras})
        return new_server, clients, metrics

    def _round_metrics(self, server, k, rows_dev, losses, accs, cplan,
                       survive, avail, accept, fault_counts, dp_frac,
                       dp_sigma) -> RoundMetrics:
        """The round's :class:`RoundMetrics`: per-client leaves of the
        reporters ('perm': scattered into [C]; 'sparse': the [k']
        rows), the uplink bytes of the reporters, and the fault
        planes' counts (the chaos and availability counts known on the
        host, moved in one copy)."""
        dev, flt, C = self.device, self.fault, self.num_clients
        if self.chaos_on or self.avail_sync:
            online = torch.ones(k)
            if flt.client_drop_rate > 0.0:
                online = cplan.survive
            if avail is not None:
                online = online * avail[0].to(torch.float32)
            online_k = online.to(dev)
            loss_k, acc_k = losses * online_k, accs * online_k
        else:
            online = None
            online_k = torch.ones(k, device=dev)
            loss_k, acc_k = losses, accs
        if self.participation_mode == "sparse":
            mask_m, loss_m, acc_m = online_k, loss_k, acc_k
        else:
            mask_m, loss_m, acc_m = (
                torch.zeros(C, device=dev).index_put((rows_dev,), v)
                for v in (online_k, loss_k, acc_k))
        comm_bytes = torch.tensor(
            tree_bytes(server.params) * k * self.algorithm.payload_scale(),
            dtype=torch.float32, device=dev)
        if flt.client_drop_rate > 0.0 or avail is not None:
            # the uploads that never reached the server
            comm_bytes = comm_bytes * online_k.sum() / k
        if online is None:
            host = torch.zeros(6, device=dev)
        else:
            byz = cplan.byzantine * (survive if avail is not None
                                     else cplan.survive)
            # 'dropped' counts chaos crashes; the availability plane
            # reports its own counts
            dropped = (1.0 - cplan.survive).sum() if avail is not None \
                else k - online.sum()
            host = torch.tensor([
                float(dropped), float((cplan.budget_scale < 1.0).sum()),
                0.0, float(byz.sum()),
                float(avail[1].sum()) if avail is not None else 0.0,
                float(avail[2].sum()) if avail is not None else 0.0],
                dtype=torch.float32).to(dev)
        quorum = torch.zeros((), device=dev)
        if avail is not None and flt.avail_quorum_frac > 0.0:
            need = math.ceil(flt.avail_quorum_frac * self.k_online)
            quorum = (accept.sum() < need).to(torch.float32)
        dropped, stragglers, staleness, byz, avail_dropped, missed = \
            host.unbind()
        rejected, clipped, selected, trimmed = fault_counts.unbind()
        return RoundMetrics(
            train_loss=loss_m, train_acc=acc_m, online_mask=mask_m,
            comm_bytes=comm_bytes, dropped_clients=dropped,
            straggler_clients=stragglers, rejected_updates=rejected,
            clipped_updates=clipped, staleness_mean=staleness,
            byzantine_clients=byz, robust_selected=selected,
            robust_trimmed=trimmed, avail_dropped=avail_dropped,
            deadline_missed=missed, quorum_degraded=quorum,
            dp_clipped_frac=None if dp_frac is None
            else dp_frac.to(torch.float32),
            dp_noise_sigma=dp_sigma)

    def _aggregate(self, stacked, wire_deltas, weights, robust_m, survive):
        """The aggregation seam on the stacked [k'] wire payloads:
        ``survive`` [k'] the reporters (None: every client reports, no
        chaos or availability plane). With the guards on, screen the
        payloads on ``wire_deltas``; else zero the payloads that did not
        report. Then the DP clip, then the robust rule, or the plain sum
        renormalized over the accepted clients. Returns (sum, the new
        ``norm_bound`` momentum or None, the [4] counts rejected,
        clipped, selected, trimmed, the accept mask or None, the DP
        clip's share or None)."""
        k = weights.shape[0]
        counts = torch.zeros(4, device=weights.device)
        accept = None
        if self.guard_on:
            stacked, report = screen_payloads(
                wire_deltas, stacked, survive if survive is not None
                else torch.ones(k, device=weights.device), self.fault)
            accept = report.accept
            counts[0], counts[1] = report.rejected, report.clipped
        elif survive is not None:
            accept = survive
            stacked = tree_map(lambda p: torch.where(
                mask_bcast(accept.bool(), p), p, torch.zeros_like(p)),
                stacked)
        dp_frac = None
        if self.dp_on:
            # every reporter's sensitivity bounded before any rule
            stacked, dp_frac = dp_clip_payloads(
                stacked, weights, accept, self.fault.dp_clip_norm)
        if self.robust_rule != "mean":
            payload_sum, new_m, rep = robust_aggregate(
                self.robust_rule, stacked, weights,
                accept if accept is not None else torch.ones_like(weights),
                self.fault, momentum=robust_m)
            counts[2], counts[3] = rep.selected, rep.trimmed
            return payload_sum, new_m, counts, accept, dp_frac
        payload_sum = tree_map(lambda p: p.sum(dim=0), stacked)
        if accept is not None:
            # rejected weight redistributed over the accepted clients;
            # an all-rejected round sums to 0 and the server holds
            payload_sum = renormalize_accepted(payload_sum, weights, accept)
        return payload_sum, None, counts, accept, dp_frac

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
                           metrics: RoundMetrics,
                           extra: Optional[dict] = None) -> dict:
        """Everything the CLI's round loop logs, in one transfer (which
        waits for the round): the mean training epoch over the clients,
        the learning rate at it, the reporters' count, loss and accuracy
        sums, the uplink bytes and the fault planes' counts (the JAX
        package's ``round_scalars_dev``), with DP armed the clip's share
        and the applied noise stddev, and ``extra``'s 0-d tensors by
        name (the supervisor's finite flag rides the same transfer)."""
        mean_epoch = clients.epoch.mean()
        names = ["mean_epoch", "lr", "n_online", "loss_sum", "acc_sum",
                 "comm_bytes", "dropped", "stragglers", "rejected",
                 "clipped", "staleness", "byzantine", "robust_selected",
                 "robust_trimmed", "avail_dropped", "deadline_missed",
                 "quorum_degraded"]
        vals = [mean_epoch, lr_at(self.schedule, mean_epoch),
                metrics.online_mask.sum(), metrics.train_loss.sum(),
                metrics.train_acc.sum(), metrics.comm_bytes,
                metrics.dropped_clients, metrics.straggler_clients,
                metrics.rejected_updates, metrics.clipped_updates,
                metrics.staleness_mean, metrics.byzantine_clients,
                metrics.robust_selected, metrics.robust_trimmed,
                metrics.avail_dropped, metrics.deadline_missed,
                metrics.quorum_degraded]
        if metrics.dp_clipped_frac is not None:
            names += ["dp_clipped_frac", "dp_noise_sigma"]
            vals += [metrics.dp_clipped_frac, metrics.dp_noise_sigma]
        for name, v in (extra or {}).items():
            names.append(name)
            vals.append(v.to(mean_epoch.device))
        return dict(zip(names, torch.stack(
            [v.to(torch.float32) for v in vals]).tolist()))

    @property
    def metrics_width(self) -> int:
        """Leading dim of the per-client :class:`RoundMetrics` leaves:
        [C] in 'perm' mode, the cohort-aligned [k'] in 'sparse' mode:
        the dispatched clients, ``k_dispatch`` (the JAX package's
        ``metrics_width`` names ``k_online``, but its round emits
        ``k_dispatch`` rows under over-selection)."""
        return self.k_dispatch if self.participation_mode == "sparse" \
            else self.num_clients

    def dp_set_noise_scale(self, server: ServerState,
                           value: float) -> ServerState:
        """The server with its DP noise scale set to ``value`` (the
        budget's 'degrade' sets 0.0: the round keeps clipping and stops
        noising)."""
        if not self.dp_on:
            raise ValueError(
                "dp_set_noise_scale on a trainer without DP armed "
                "(fault.dp_noise_multiplier == 0)")
        leaf = server.aux["dp_noise_scale"]
        aux = dict(server.aux, dp_noise_scale=torch.tensor(
            value, dtype=torch.float32, device=leaf.device))
        return server._replace(aux=aux)

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

    def telemetry_gauges(self) -> dict:
        """Host-side gauges for the telemetry round row, by the JAX
        package's catalog names: the stream producer's counters (since
        its last (re)start) and the rebuild count. Host counters only:
        reading them costs no device sync."""
        out = {}
        ss = self.stream_stats()
        if ss is not None:
            out.update(
                stream_depth=float(ss["depth"]),
                stream_wait_s=ss["wait_s"], stream_gather_s=ss["gather_s"],
                stream_h2d_s=ss["h2d_s"],
                stream_produced=float(ss["rounds_produced"]),
                stream_store_resident_mb=ss["store_resident_mb"],
                stream_store_mapped_mb=ss["store_mapped_mb"])
        if self.data_plane == "stream":
            out["stream_rebuilds"] = float(self._stream_rebuilds)
        return out

    def _pop_stream_with_rebuild(self, pop):
        """Self-healing feed pop: when the producer fails — its thread
        died on an exhausted gather retry, wedged past
        ``stream_timeout_s``, or desynced — tear it down and rebuild it
        through :meth:`invalidate_stream` instead of aborting the run.
        ``pop`` restarts the producer from the live (generator, round),
        so the rebuilt one draws the same plans (bitwise recovery).
        Bounded by ``fault.host_retry_max`` rebuilds per pop; exhaustion
        raises a ``HostSeamError`` naming ``stream.producer``."""
        limit = self.cfg.fault.host_retry_max
        for attempt in range(limit + 1):
            try:
                return pop()
            except Exception as e:
                self.invalidate_stream()
                if attempt >= limit:
                    raise host_recovery.HostSeamError(
                        "stream.producer",
                        f"stream feed producer failed {limit + 1} "
                        f"consecutive pops; last error: {e!r}") from e
                self._stream_rebuilds += 1
                host_recovery.get_active().note_retry("stream.producer")
                telemetry.event("stream.producer_rebuilt",
                                attempt=attempt + 1, error=repr(e))

    # -- host-side round loop ---------------------------------------------
    def run_round(self, server, clients):
        """One communication round on the trainer's data plane. On the
        stream plane each call consumes the producer's next feed, so
        calls must advance the state round by round; replaying a round
        on saved state needs :meth:`invalidate_stream` first."""
        if self.data_plane == "stream":
            item = self._pop_stream_with_rebuild(
                lambda: self.next_stream_item(server))
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
