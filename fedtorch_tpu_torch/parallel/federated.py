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

* With ``client_fusion`` 'vmap' (and 'auto') the k clients run one after
  another in a Python loop over one shared module
  (``torch.func.functional_call`` with each client's params); the JAX
  package vmaps them. With 'fused' (``parallel/fusion.py``) all k run
  each local step as one forward and backward of the client-fused
  module, the hooks under ``torch.func.vmap``, as the JAX package's
  fused round (:meth:`FederatedTrainer._fused_client_round`).
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
* On the per-client execution, epoch-sync clients skip the steps past
  their own budget instead of running them masked; state and metrics
  come out the same, and every step-indexed hook anchors on the budget
  (DRFA's snapshot step). The fused execution masks them, as the JAX
  package does.
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
  ``byzantine_rate > 0``, ``avail_model == 'trace'`` or under
  ``sync_mode='async'``, whose event schedule hangs off it) and keeps in the
  server aux, wrapped as the JAX package wraps its ``norm_bound``
  momentum and DP noise scale: ``{'alg': ..., 'norm_bound_m': ...,
  'dp_noise_scale': ..., 'fault_key': ...}``, each member only when
  armed. The per-leaf normals of the DP noise and the gauss attack are
  drawn on the round's device from the plan's seed, or taken from the
  plan's ``noise`` (tests inject the JAX package's).
* Every dispatched client trains, also one that crashes or drops out,
  as the JAX package's vmap does; only the clients that keep their
  round (not crashed, not dropped out) have their state written back.

With ``telemetry.cohort_stats`` the aggregation seam keeps the per-client
evidence (the accept and selection masks, the robust rule's suspicion)
and the cohort's heterogeneity gauges in the ``cohort_*`` fields of
:class:`RoundMetrics`, riding the round's one fetch
(:meth:`FederatedTrainer.round_host_scalars` with ``ledger=True``); off,
the round runs exactly as before. The async plane's commit
(``async_plane/``) re-dispatches :meth:`FederatedTrainer._round_core`
through its commit seam.

Pod-scale client sharding (``mesh.client_shards`` S, the JAX package's
``federated.py:341-371``; ``parallel/podscale.py``, ``parallel/mesh.py``):
one process a rank, each holding the whole replicated server state and
its own rows of the client state (the params, optimizer and aux trees)
and, on the device data plane, of the population, placed as the JAX
package's ``client_sharding`` places them (``parallel/mesh.py``
``owned_client_rows``: ``C_pad/W`` contiguous rows a rank of W, whatever
S); the per-client ``epoch`` and ``local_index`` ([C]) stay replicated.
Every rank draws the whole :class:`RoundPlan` from the server's
generator (so every draw is S-invariant) and runs only its contiguous
block of the cohort's rows through the local loops (the stream plane's
producer packs only those rows). Before the loops one exchange
(``podscale.exchange_rows``, an ``all_to_all_single`` over every rank)
brings the block's optimizer and aux rows, and on the device plane its
data rows, from the ranks that own them; for the algorithms that read
the population outside the loops it also brings every dispatched
client's aux rows and first B storage rows (``pre_round``: APFL's
adaptive alpha is the cohort's mean, so every rank runs the hook on the
whole cohort and keeps its block's rows), each block client's whole
shard (qFFL's full loss) and every probe client's batch (DRFA's dual
update). The validation split stays replicated on every rank (it is
read a client at a time, by PerFedAvg's steps), so it needs no
exchange. At ``client_shards`` 0 on W > 1 ranks (the JAX package's 1-D
mesh, where GSPMD places every cross-client sum) rank r runs the
``ceil(k/W)`` cohort rows from ``r*ceil(k/W)`` (``parallel/mesh.py``
``cohort_block``; the last ranks' blocks shorter or empty), and after
the local loops one ``all_gather`` (``podscale.gather_cohort``, the
cohort gather) brings every rank every client's payload, raw delta,
optimizer and aux rows, epoch, local index, loss and accuracy (and the
round-end params ``client_post`` reads); every rank then runs the rest
of the round (the byzantine step, the wire format, the guards, DP, the
robust rule or the plain sum, the cohort statistics, the server step,
``client_post``, the metrics, the write-back of its own rows) on the
whole cohort, as one rank does: each client's loop depends on the plan
alone, so the round is bitwise the one-rank round. With the guards on, each
rank's ``[k/S]`` update norms are gathered before the screen
(``podscale.gather_row_stats``). The aggregation seam's grouped sum,
whose association depends on k alone, issues the round's one
``all_gather``, which also brings every rank the per-client rows the
replicated rest of the round reads (metrics, client state, DP clip
flags); each rank writes back the rows it owns. S = 1 (armed) runs the
same sum with no collective, the twin the sharded rounds are bitwise
equal to. On the stream plane a producer that
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
from torch.func import functional_call, vmap

from fedtorch_tpu_torch import telemetry
from fedtorch_tpu_torch.algorithms.base import (
    FedAlgorithm, num_online_effective,
)
from fedtorch_tpu_torch.config import ExperimentConfig
from fedtorch_tpu_torch.core import optim
from fedtorch_tpu_torch.core.losses import (
    make_criterion, per_sample_loss, topk_indices,
)
from fedtorch_tpu_torch.core.schedule import compile_schedule, lr_at
from fedtorch_tpu_torch.core.state import (
    ClientState, RoundMetrics, ServerState, tree_broadcast_clients,
    tree_bytes, tree_fill, tree_leaves, tree_map, tree_put, tree_stack,
    tree_sub, tree_take,
)
from fedtorch_tpu_torch.data.batching import ClientData, round_row_plan
from fedtorch_tpu_torch.data.streaming import (
    FAULT_SEEDS, FAULT_TENSORS, HostClientStore, MmapClientStore, RoundFeed,
    RoundSchedule, StreamFeedProducer, StreamItem, np_dtype, window_round,
)
from fedtorch_tpu_torch.models.common import ModelDef
from fedtorch_tpu_torch.ops.augment import augment_image_batch, draw_augment
from fedtorch_tpu_torch.parallel.fusion import resolve_client_fusion
from fedtorch_tpu_torch.parallel.mesh import (
    client_owner, cohort_block, cohort_sharding, make_mesh,
    mesh_client_shards, owned_client_rows, rank, world_size,
)
from fedtorch_tpu_torch.parallel.podscale import (
    bytes_as_rows, cohort_allreduce_bytes, cohort_hierarchical_sum,
    cohort_layout, exchange_rows, gather_cohort, gather_row_stats,
    gathered_bytes, row_bytes, rows_as_bytes,
)
from fedtorch_tpu_torch.parallel.round_program import (
    RoundProgramBuilder, feed_layout,
)
from fedtorch_tpu_torch.robustness import (
    availability, chaos, host_recovery,
)
from fedtorch_tpu_torch.robustness.aggregators import (
    cohort_statistics, robust_aggregate,
)
from fedtorch_tpu_torch.robustness.guards import (
    mask_bcast, renormalize_accepted, screen_payloads,
)
from fedtorch_tpu_torch.robustness.privacy import (
    dp_add_noise, dp_clip_rows, dp_clip_share, dp_noise_stddev,
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
    attack ``{"deltas": {...}, "payloads": {...}}``). ``jobs`` is the
    async plane's :class:`~fedtorch_tpu_torch.parallel.round_program.
    CommitJobs` (the cohort's snapshot versions, dispatch ids and
    straggler flags; None on the sync planes)."""
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
    jobs: Optional[tuple] = None          # the commit's CommitJobs (async)


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
                 server_aux=None, idx: Optional[torch.Tensor] = None
                 ) -> RoundPlan:
        """The plan; ``idx`` (the async commit's buffered clients, [k])
        takes the place of the cohort draw."""
        K, B, k = self.local_steps, self.batch_size, self.k
        alg, C = self.algorithm, len(self.sizes)
        if idx is None:
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


class CohortProbe(NamedTuple):
    """DRFA's probe batches as the exchange brings them: what
    ``post_round_global_feed`` reads of a feed."""
    probe_idx: torch.Tensor  # [k] int64 probe cohort
    probe_x: torch.Tensor    # [k, B, ...]
    probe_y: torch.Tensor


class CohortBlock(NamedTuple):
    """What a rank's block of the cohort reads of the client state and
    the population (:meth:`FederatedTrainer._cohort_block`)."""
    opt: list                      # each block client's optimizer rows
    aux: object                    # stacked aux rows ([k] with pre_round)
    x: Optional[torch.Tensor] = None      # [n, K*B, ...] the block's rows
    y: Optional[torch.Tensor] = None
    pre_x: Optional[torch.Tensor] = None  # [k, B, ...] pre_round's rows
    pre_y: Optional[torch.Tensor] = None
    shards: Optional[list] = None  # each block client's (x, y) shard
    probe: Optional[CohortProbe] = None


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

    # the async plane's trainer (async_plane/commit.py) serves the
    # commit dispatch; this class serves rounds
    supports_async = False
    construction_dispatch = "round"

    def __init__(self, cfg: ExperimentConfig, model: ModelDef,
                 algorithm: FedAlgorithm, data: ClientData,
                 val_data: Optional[ClientData] = None, device=None):
        if cfg.federated.sync_mode == "async" and not self.supports_async:
            raise ValueError(
                "sync_mode='async' is unsupported here: the base "
                "FederatedTrainer is round-synchronous — build the "
                "trainer through the CLI or fedtorch_tpu_torch."
                "async_plane.AsyncFederatedTrainer; use --sync_mode sync "
                "for this class")
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
        # the async plane's arrivals come from its event scheduler, not
        # the sync lifecycle
        self.avail_sync = flt.avail_armed and not self.supports_async
        self.k_dispatch = max(math.ceil(
            flt.over_select_frac * self.k_online), self.k_online) \
            if self.avail_sync else self.k_online
        # the client execution (parallel/fusion.py): 'fused' runs each
        # local step of all k' clients as one forward and backward of the
        # client-fused module; the builder refuses what it cannot serve
        # the ranks the round spreads over (parallel/mesh.py): the
        # validator refuses what the client-shard seam cannot serve
        # before the mesh is built
        self.mesh_devices = world_size()
        self.client_fusion, self.fused_module = resolve_client_fusion(
            cfg, model, algorithm, self.mesh_devices, self.k_dispatch)
        self.programs = RoundProgramBuilder(self)
        self.programs.validate(self.construction_dispatch)
        self.mesh = make_mesh(cfg.mesh)
        # pod-scale client sharding (parallel/podscale.py): S, the
        # effective shard count (1 without a 2-D mesh); armed also at
        # mesh.client_shards == 1, the unsharded twin that runs the same
        # grouped sum with no collective. Disarmed (0) the round is the
        # plain one.
        self.client_shards = mesh_client_shards(self.mesh)
        self.podscale_armed = self.client_shards > 1 \
            or cfg.mesh.client_shards >= 1
        # client_shards 0 on several ranks (the JAX package's 1-D mesh):
        # each rank runs its ceil(k/W) rows of the cohort, and one
        # gather after the local loops brings every rank the whole
        # cohort (parallel/podscale.py gather_cohort); the gather's
        # bytes a round (set by the first round), and the rows' layout
        # for a rank whose block is empty (sent once by rank 0)
        self.flat_ranks = self.mesh is not None and self.mesh.ndim == 1
        self._cohort_bytes: Optional[float] = None
        self._cohort_layout = None
        # the [G, P] bytes the seam's gather moves a round, and the
        # bytes of its whole buffer (the partials and the riders; 0
        # without a gather): set by the first armed round, telemetry
        # gauges
        self._allreduce_bytes: Optional[float] = None
        self._gather_bytes: Optional[float] = None
        # the client state (and on the device plane the population)
        # sharded over the ranks by the JAX package's placement
        # (parallel/mesh.py): this rank's [lo, hi) of the padded client
        # axis; the exchange's and the guards' norm gather's bytes a
        # round (set by the first round that issues them)
        self.state_sharded = self.mesh_devices > 1
        self.client_rows = owned_client_rows(data.num_clients)
        self._exchange_bytes: Optional[float] = None
        self._norm_bytes: Optional[float] = None
        self._client_state_bytes = 0
        self.participation_mode = cfg.federated.participation_mode
        self.epoch_sync = cfg.federated.sync_type == "epoch"
        if self.epoch_sync:
            nb_max = math.ceil(data.n_max / self.batch_size)
            self.local_steps = nb_max * cfg.federated.num_epochs_per_comm
        else:
            self.local_steps = max(cfg.train.local_step, 1)
        # the fused round masks the steps past a client's budget
        self.mask_steps = self.epoch_sync or flt.straggler_rate > 0.0
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
            or (self.avail_sync and flt.avail_model == "trace") \
            or self.supports_async
        # the federation plane's cohort statistics: per-client evidence
        # at the aggregation seam and the heterogeneity gauges, riding
        # the round's one batched fetch (off: the round is unchanged)
        self.cohort_stats = bool(cfg.telemetry.cohort_stats)
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
            self.data = self._owned_population(data).to(self.device)
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

    def _owned_population(self, data: ClientData) -> ClientData:
        """This rank's clients of the population: the real rows of its
        ``[lo, hi)`` (the pad rows are never read, so not held); all of
        them unsharded."""
        if not self.state_sharded:
            return data
        lo, hi = self.client_rows
        hi = min(hi, data.num_clients)
        return ClientData(*(t[lo:hi] for t in data))

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
        plans from it. The clients' params, optimizer and aux trees hold
        this rank's rows of the padded client axis (``client_rows``:
        every client on one rank); ``epoch`` and ``local_index`` (8 B a
        client) hold every client's on every rank, so the round's mean
        epoch is the one-rank twin's, bit for bit."""
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
        # the params, optimizer and aux trees: this rank's C_pad/W rows
        # of the padded client axis (all C unsharded); epoch and
        # local_index: every client's, replicated
        C = self.num_clients
        lo, hi = self.client_rows
        cparams = tree_broadcast_clients(params, hi - lo)
        copt = optim.init_client_opt_state(cparams, ocfg)
        clients = ClientState(
            params=cparams, opt=copt,
            aux=self.algorithm.init_client_aux(cparams),
            epoch=torch.zeros(C, device=self.device),
            local_index=torch.zeros(C, dtype=torch.int32,
                                    device=self.device))
        self._client_state_bytes = sum(
            t.numel() * t.element_size() for t in tree_leaves(clients))
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
        return self._round_core(server, clients, plan,
                                *self.gather_resident(plan))

    def cohort_rows(self, k: int):
        """``[lo, hi)``, the rows of a k-wide cohort this rank runs (all
        of them on one rank; ``parallel/mesh.py`` ``cohort_sharding``)."""
        return cohort_sharding(self.mesh, k)

    def cohort_block_of(self, k: int, r: int):
        """``[lo, hi)``, the rows of a k-wide cohort rank ``r`` runs."""
        return cohort_block(k, self.mesh_devices,
                            0 if self.flat_ranks else self.client_shards, r)

    def seam_rows(self, k: int):
        """``[lo, hi)``, the cohort rows this rank holds at the
        aggregation seam: its shard's under client sharding, all k
        otherwise (on the 1-D mesh the cohort gather brought them)."""
        return self.cohort_rows(k) if self.client_shards > 1 else (0, k)

    def gather_resident(self, plan: RoundPlan):
        """This rank's rows of the plan from the population on the
        device: (x, y, pre_x, pre_y, shards) for :meth:`_round_core`.
        With the population sharded over the ranks all five are None:
        the rows come with the round's exchange
        (:meth:`_cohort_block`)."""
        if self.state_sharded:
            return None, None, None, None, None
        data, dev = self.data, self.device
        lo, hi = self.cohort_rows(plan.idx.shape[0])
        idx = plan.idx[lo:hi].to(torch.int64)
        on = idx.to(dev)[:, None]
        rows = plan.rows[lo:hi].to(dev)
        pre_x = pre_y = None
        if self._pre_round:
            # each online client's first B storage rows (the JAX
            # package clamps rows past n_max)
            first = torch.arange(self.batch_size, device=dev).clamp_max(
                data.n_max - 1)[None, :]
            pre_x, pre_y = data.x[on, first], data.y[on, first]
        shards = [(data.x[c], data.y[c]) for c in idx.tolist()] \
            if self.algorithm.needs_full_loss else None
        return data.x[on, rows], data.y[on, rows], pre_x, pre_y, shards

    @staticmethod
    def feed_plan(feed: RoundFeed) -> RoundPlan:
        """The round plan a packed feed carries."""
        return RoundPlan(
            feed.idx.to(torch.int64), feed.rows, feed.flip, feed.tops,
            feed.lefts,
            None if feed.k_rand is None else int(feed.k_rand),
            None if feed.probe_idx is None else feed.probe_idx.long(),
            feed.probe_rows, drop_keys=feed.drop_keys,
            **{f: getattr(feed, f) for f in FAULT_TENSORS},
            **{f: None if getattr(feed, f) is None
               else int(getattr(feed, f)) for f in FAULT_SEEDS},
            jobs=feed.jobs)

    def gather_feed(self, feed: RoundFeed, plan: RoundPlan):
        """(x, y, shards) of a feed: its rows ('batch' layout), or the
        plan's rows selected from its whole shards ('shard')."""
        if self.feed_layout != "shard":
            return feed.x, feed.y, None
        # the feed holds this rank's rows of the cohort
        lo, hi = self.cohort_rows(plan.idx.shape[0])
        on = torch.arange(hi - lo, device=self.device)[:, None]
        rows = plan.rows[lo:hi].to(self.device)
        return feed.x[on, rows], feed.y[on, rows], list(zip(feed.x, feed.y))

    def round_stream_fn(self, server: ServerState, clients: ClientState,
                        feed: RoundFeed):
        """One round on the stream plane, from a packed feed (rows and
        plan on the host, tensors on the device): the round core of
        :meth:`round_fn` on the feed's rows. ``server.rng`` is left as
        it is; :meth:`run_round` advances it."""
        plan = self.feed_plan(feed)
        x, y, shards = self.gather_feed(feed, plan)
        return self._round_core(
            server, clients, plan, x, y, feed.pre_x, feed.pre_y, shards,
            probe=feed if feed.probe_idx is not None else None)

    def _round_core(self, server: ServerState, clients: ClientState,
                    plan: RoundPlan, x, y, pre_x, pre_y, shards=None,
                    probe: Optional[RoundFeed] = None, base_params=None,
                    base_aux=None, weight_scale=None):
        """The round on gathered rows: ``x``/``y`` [k', K*B, ...] in plan
        order, ``pre_x``/``pre_y`` [k', B, ...] (when ``pre_round``
        runs), ``shards`` each dispatched client's (x, y) shard (qFFL's
        full loss), ``probe`` the feed whose probe batches DRFA's dual
        update takes (None: ``post_round_global`` on the resident
        data). Under client sharding (``client_shards`` S > 1) the
        per-client inputs are this rank's rows of the cohort only
        (:meth:`cohort_rows`): the rank runs those clients' loops, and
        the aggregation seam's one gather brings every rank the rest of
        what the replicated remainder of the round reads. At
        ``client_shards`` 0 on several ranks the rank runs its block's
        loops too, and the cohort gather (:meth:`_gather_cohort`) brings
        every rank the whole cohort's outputs before the remainder.

        The commit seam (``parallel/round_program.py``, the async
        plane's commit): ``base_params``/``base_aux`` give each client
        its own server snapshot (lists of k trees: the params and the
        server aux of the commit version it trained against), read by
        every local hook in place of the live server state;
        ``weight_scale`` [k] (the staleness weights) is composed into the
        aggregation weights before the guards' renormalization; the
        straggler step cut is neutralized (an async straggler arrived
        late instead) and the DP noise is calibrated to the commit's
        width. None, the default, runs the synchronous round."""
        alg, dev, flt = self.algorithm, self.device, self.fault
        commit = base_params is not None
        extras = {}
        if self.aux_wrapped:
            # every algorithm hook reads the unwrapped aux
            extras = {n: v for n, v in server.aux.items() if n != "alg"}
            server = server._replace(aux=server.aux["alg"])
            if base_aux is not None:
                base_aux = [a["alg"] for a in base_aux]
        idx = plan.idx.to(torch.int64)
        k = idx.shape[0]
        num_online_eff = num_online_effective(idx)
        on_sizes = torch.tensor([self.sizes[c] for c in idx.tolist()])
        weights = alg.client_weights(server.aux, idx, num_online_eff,
                                     on_sizes).to(dev)
        if weight_scale is not None:
            # the staleness weights, composed into the aggregation
            # weights: the renormalization redistributes the composed
            # weight
            weights = weights * weight_scale.to(dev)
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
        if commit:
            # an async straggler already arrived late: no step cut too
            cplan = cplan._replace(budget_scale=torch.ones(k))
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

        # this rank's rows of the cohort (all of them unless sharded):
        # every per-client input below is cut to them
        lo, hi = self.cohort_rows(k)
        mine = idx[lo:hi]

        # this rank's block of the cohort's optimizer and aux rows (and,
        # the population sharded, its data rows, pre_round's rows and
        # DRFA's probe batches): the round's one exchange
        blk = self._cohort_block(clients, plan, lo, hi, with_data=x is None)
        on_aux = blk.aux
        if blk.x is not None:
            x, y, shards = blk.x, blk.y, blk.shards
        if blk.pre_x is not None:
            pre_x, pre_y = blk.pre_x, blk.pre_y
        if blk.probe is not None:
            probe = blk.probe
        # the cross-client hook on the dispatched clients' gathered aux
        # and first B storage rows: every client's on every rank, each
        # rank keeping its block's rows
        if self._pre_round:
            on_lrs = torch.stack([lr_at(self.schedule, clients.epoch[c])
                                  for c in idx.tolist()])
            on_aux = alg.pre_round(
                on_aux, server=server, x=pre_x, y=pre_y, sizes=on_sizes,
                lr=on_lrs, plan=plan)
            if (lo, hi) != (0, k):
                on_aux = tree_take(on_aux, slice(lo, hi))

        # each client's steps this round: its epoch-sync budget, cut for a
        # straggler
        budgets = [self._step_budget(self.sizes[c], budget_scale[j])
                   for j, c in enumerate(idx.tolist())]
        if self.augment:
            draws = [d[lo:hi] for d in draws]
        outs = None  # an empty block runs no client
        if self.client_fusion == "fused":
            outs = self._fused_client_round(
                server, clients, idx, x, y, on_aux, weights, budgets,
                draws if self.augment else None)
        elif hi > lo:
            loop_plan = plan if plan.drop_keys is None \
                else plan._replace(drop_keys=plan.drop_keys[lo:hi])
            outs = self._client_loops(
                server, clients, loop_plan, mine, x, y, blk.opt, on_aux,
                weights[lo:hi],
                budgets[lo:hi], shards,
                None if base_params is None else base_params[lo:hi],
                None if base_aux is None else base_aux[lo:hi],
                draws if self.augment else None,
                vrows[lo:hi] if alg.needs_val_batch else None)
        if self.flat_ranks:
            # the 1-D mesh: every client's rows of what the rest of the
            # round reads come to every rank, which then runs that rest
            # on the whole cohort
            outs = self._gather_cohort(outs, k, lo, hi)
            lo, hi = 0, k
        (stacked, wire_deltas, client_opts, client_aux, epochs,
         local_index, losses, accs, kept) = outs

        with torch.no_grad():
            if flt.byzantine_rate > 0.0:
                # an adversary crafts what it sends, before the wire
                # format; its local state stays honest
                wire_deltas, stacked = chaos.apply_byzantine(
                    chaos.ChaosPlan(*(t[lo:hi].to(dev) for t in cplan)),
                    wire_deltas, stacked, weights[lo:hi], flt,
                    seed=plan.byz_seed, noise=plan.noise, rows=(lo, hi, k))
            nan_dev = cplan.nan_inject[lo:hi].to(dev) \
                if flt.nan_inject_rate > 0.0 else None
            if nan_dev is not None and wire_deltas is not None:
                wire_deltas = chaos.poison_tree(wire_deltas, nan_dev)
            # uplink wire format on the stacked [k'] axis (this rank's
            # rows)
            stacked = alg.payload_batch_transform(stacked)
            if nan_dev is not None:
                # a fried wire trumps whatever was on it
                stacked = chaos.poison_tree(stacked, nan_dev)
            survive_dev = survive.to(dev) \
                if self.chaos_on or self.avail_sync else None
            riders = None
            if self.client_shards > 1:
                # what the replicated rest of the round reads of every
                # client rides the seam's one gather
                riders = {"opt": client_opts, "aux": client_aux,
                          "epoch": epochs, "local_index": local_index,
                          "loss": losses, "acc": accs}
            payload_sum, new_robust_m, fault_counts, accept, dp_frac, \
                cohort = self._aggregate(stacked, wire_deltas, weights,
                                         extras.get("norm_bound_m"),
                                         survive_dev, riders)
            if riders is not None:
                client_opts, client_aux, epochs, local_index, losses, \
                    accs = (riders[n] for n in (
                        "opt", "aux", "epoch", "local_index", "loss",
                        "acc"))
            # the downlink wire format, once, whatever the rule
            payload_sum = alg.aggregate_transform(payload_sum)
            dp_sigma = None
            if self.dp_on:
                # noise on the released estimate, at the round's real
                # width: k_online, or the commit's buffer m
                scale = extras["dp_noise_scale"]
                sigma = dp_noise_stddev(self.fault.dp_noise_multiplier,
                                        self.fault.dp_clip_norm,
                                        k if commit else self.k_online)
                payload_sum = dp_add_noise(
                    payload_sum, plan.dp_seed, weights, sigma, scale,
                    noise=(plan.noise or {}).get("dp"))
                dp_sigma = (sigma * scale).to(torch.float32)
            new_params, new_opt, new_saux = alg.server_update(
                server.params, server.opt, server.aux, payload_sum,
                online_idx=idx, num_online_eff=num_online_eff,
                client_losses=losses)
            if self._client_post:
                # aux updates that need the transformed sum, each with
                # the client's round-end LR and step budget
                client_aux = tree_stack([alg.client_post(
                    delta=d, client_aux=tree_take(client_aux, j),
                    payload_sum=payload_sum, lr=lr_at(self.schedule,
                                                      epochs[j]),
                    local_steps=budgets[j], server_params=server.params,
                    params=p, weight=weights[j])
                    for j, (d, p) in enumerate(kept)])

            # the clients that keep their round leave holding the
            # aggregated server model (model_server =
            # deepcopy(model_client), fedavg.py:97); a crashed or
            # dropped-out client's rows are not written, and a rank
            # writes the state trees' rows it holds only
            js = [j for j in range(k) if keep[j]]
            if js:
                whole = len(js) == k
                rows_keep = rows_dev if whole else idx[js].to(dev)
                sel = None if whole else torch.tensor(js, device=dev)

                def kept_rows(tree):
                    return tree if whole else tree_take(tree, sel)
                c_lo, c_hi = self.client_rows
                # lint: disable=FTL001 — the plan's ids lie on the host
                ids = idx.tolist()
                own = [j for j in js if c_lo <= ids[j] < c_hi]
                # lint: disable=FTL005 — a host list of cohort positions
                if own:
                    every = len(own) == k
                    local = (rows_dev if every else idx[own].to(dev)) - c_lo
                    sel_own = None if every \
                        else torch.tensor(own, device=dev)

                    def own_rows(tree):
                        return tree if every else tree_take(tree, sel_own)
                    for n, p in clients.params.items():
                        p[local] = new_params[n]
                    tree_put(clients.opt, local, own_rows(client_opts))
                    tree_put(clients.aux, local, own_rows(client_aux))
                clients.epoch[rows_keep] = kept_rows(epochs)
                clients.local_index[rows_keep] = kept_rows(local_index)

            metrics = self._round_metrics(
                server, k, rows_dev, losses, accs, cplan, survive, avail,
                accept, fault_counts, dp_frac, dp_sigma, cohort)
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

    def _cohort_block(self, clients: ClientState, plan: RoundPlan,
                      lo: int, hi: int, with_data: bool) -> "CohortBlock":
        """What this rank's block ``[lo, hi)`` of the cohort reads of the
        client state and the population (:class:`CohortBlock`). Unsharded
        it is read off the state (each client's optimizer rows a view: a
        stacked copy would hold k clients' optimizer state twice); the
        data rows are the caller's. Sharded, one exchange brings each row
        from the rank that owns it (``podscale.exchange_rows``): every
        rank takes part, each sending the rows it owns of what every rank
        wants. A rank wants

        * its block's optimizer rows, its aux rows and, ``with_data``,
          its data: each client's plan rows, or its whole shard where
          that is fewer rows (``n_max`` <= K*B) or the algorithm reads
          it (qFFL's full loss), indexed by the plan on arrival;
        * with ``pre_round`` (APFL, DRFA), every dispatched client's aux
          rows and, ``with_data``, first B storage rows in place of the
          block's aux: the hook reads the whole cohort (APFL's adaptive
          alpha is the cohort's mean), so every rank runs it on every
          client and keeps its block's rows;
        * with ``with_data`` and a probe in the plan (DRFA's dual
          update), every probe client's batch."""
        idx, dev = plan.idx.to(torch.int64), self.device
        alg = self.algorithm
        if not self.state_sharded:
            # lint: disable=FTL001 — the plan's ids lie on the host
            mine = idx[lo:hi].tolist()
            return CohortBlock([tree_take(clients.opt, c) for c in mine],
                               tree_take(clients.aux, idx[lo:hi].to(dev)))
        W, k = self.mesh_devices, idx.shape[0]
        # lint: disable=FTL001 — the plan's ids lie on the host
        ids = idx.tolist()
        probing = with_data and plan.probe_idx is not None \
            and alg.needs_post_probe
        # lint: disable=FTL001 — the plan's ids lie on the host
        probe_ids = plan.probe_idx.tolist() if probing else []
        c_lo, B = self.client_rows[0], self.batch_size
        data = self.data
        opt_leaves, aux_leaves = (tree_leaves(clients.opt),
                                  tree_leaves(clients.aux))

        def row_likes(ts, n=None):
            return [(((n,) if n is not None else ()) + tuple(
                t.shape[2 if n is not None else 1:]), t.dtype) for t in ts]
        whole = with_data and (data.n_max <= plan.rows.shape[1]
                               or alg.needs_full_loss)
        # the segments of the exchange: (name, the client of each of its
        # positions, the row layout, the positions each rank wants); a
        # key is the segment's offset plus a position
        run = opt_leaves + ([] if self._pre_round else aux_leaves)
        run_likes = row_likes(run)
        if with_data:
            n = data.n_max if whole else plan.rows.shape[1]
            run_likes += row_likes((data.x, data.y), n)
        blocks = [self.cohort_block_of(k, r) for r in range(W)]
        segments = [("run", ids, run_likes,
                     [list(range(a, b)) for a, b in blocks])]
        if self._pre_round:
            pre_likes = row_likes(aux_leaves) + (
                row_likes((data.x, data.y), B) if with_data else [])
            segments.append(("pre", ids, pre_likes, [list(range(k))] * W))
        if probing:
            segments.append(("probe", probe_ids, row_likes(
                (data.x, data.y), plan.probe_rows.shape[1]),
                [list(range(len(probe_ids)))] * W))
        offsets, owner, sizes, want = [], [], [], [[] for _ in range(W)]
        for _, seg_ids, likes, keys in segments:
            offsets.append(len(owner))
            owner += [client_owner(c, self.num_clients, W) for c in seg_ids]
            sizes += [row_bytes(likes)] * len(seg_ids)
            for r in range(W):
                want[r] += [offsets[-1] + j for j in keys[r]]
        first = torch.arange(B, device=dev).clamp_max(
            data.n_max - 1)[None, :] if with_data else None

        def pack_segment(s, pos):
            name, seg_ids = segments[s][:2]
            loc = torch.tensor([seg_ids[j] - c_lo for j in pos],
                               dtype=torch.int64, device=dev)
            # lint: disable=FTL005 — a segment's name, a host string
            if name == "probe":
                r = plan.probe_rows[pos].to(dev)
                rows = [data.x[loc[:, None], r], data.y[loc[:, None], r]]
            # lint: disable=FTL005 — a segment's name, a host string
            elif name == "pre":
                rows = [t[loc] for t in aux_leaves]
                if with_data:
                    rows += [data.x[loc[:, None], first],
                             data.y[loc[:, None], first]]
            else:
                rows = [t[loc] for t in run]
                if whole:
                    rows += [data.x[loc], data.y[loc]]
                elif with_data:
                    r = plan.rows[pos].to(dev)
                    rows += [data.x[loc[:, None], r],
                             data.y[loc[:, None], r]]
            return rows_as_bytes(rows, len(pos)).reshape(-1)

        def pack(keys):
            # runs of one segment's keys, each packed in one gather
            out, s, pos = [], None, []
            for key in keys:
                ks = bisect.bisect_right(offsets, key) - 1
                if ks != s and pos:
                    out.append(pack_segment(s, pos))
                    pos = []
                s = ks
                pos.append(key - offsets[ks])
            out.append(pack_segment(s, pos))
            return torch.cat(out)

        before = gathered_bytes("exchange")
        flat = exchange_rows(pack, sizes, want, owner, rank(), W, dev)
        self._exchange_bytes = float(gathered_bytes("exchange") - before)
        got, off = {}, 0
        for (name, _, likes, keys) in segments:
            n, width = len(keys[rank()]), row_bytes(likes)
            got[name] = iter(bytes_as_rows(
                flat[off:off + n * width].reshape(n, width), likes))
            off += n * width
        block = got["run"]
        opt = tree_fill(clients.opt, block)
        opt = [tree_take(opt, j) for j in range(hi - lo)]
        if self._pre_round:
            aux = tree_fill(clients.aux, got["pre"])
        else:
            aux = tree_fill(clients.aux, block)
        out = CohortBlock(opt, aux)
        if with_data:
            x, y = next(block), next(block)
            if whole:
                if alg.needs_full_loss:
                    out = out._replace(shards=list(zip(x, y)))
                on = torch.arange(hi - lo, device=dev)[:, None]
                r = plan.rows[lo:hi].to(dev)
                x, y = x[on, r], y[on, r]
            out = out._replace(x=x, y=y)
            if self._pre_round:
                out = out._replace(pre_x=next(got["pre"]),
                                   pre_y=next(got["pre"]))
        if probing:
            out = out._replace(probe=CohortProbe(
                plan.probe_idx, next(got["probe"]), next(got["probe"])))
        return out

    def _gather_cohort(self, outs, k: int, lo: int, hi: int):
        """The 1-D mesh's cohort gather: this rank's block ``[lo, hi)``
        of the local loops' outputs (``outs``, as :meth:`_client_loops`
        returns them; None for an empty block) -> the same for all k
        clients, on every rank, through one ``podscale.gather_cohort``.
        What rides: the payloads, the raw deltas (guards on), the
        optimizer and aux rows, the epochs, local indices, losses and
        accuracies and (``client_post`` runs) each client's round-end
        params and delta (the raw deltas' rows where the guards ride
        them)."""
        parts = None
        if outs is not None:
            (stacked, wire_deltas, client_opts, client_aux, epochs,
             local_index, losses, accs, kept) = outs
            parts = {"payload": stacked, "opt": client_opts,
                     "aux": client_aux, "epoch": epochs,
                     "local_index": local_index, "loss": losses,
                     "acc": accs}
            if wire_deltas is not None:
                parts["delta"] = wire_deltas
            if self._client_post:
                parts["kept_params"] = tree_stack([p for _, p in kept])
                if wire_deltas is None:
                    parts["kept_delta"] = tree_stack([d for d, _ in kept])
        blocks = [self.cohort_block_of(k, r) for r in range(self.mesh_devices)]
        if any(b == a for a, b in blocks) and self._cohort_layout is None:
            # a rank runs no client this round: rank 0 sends the rows'
            # layout, once a run
            self._cohort_layout = cohort_layout(parts)
        layout = None
        if parts is None:
            layout = tree_map(lambda t: t.to(self.device)
                              if isinstance(t, torch.Tensor) else t,
                              self._cohort_layout)
        before = gathered_bytes("cohort")
        full = gather_cohort(parts, k, self.device, layout)
        self._cohort_bytes = float(gathered_bytes("cohort") - before)
        kept = []
        if self._client_post:
            deltas = full.get("kept_delta", full.get("delta"))
            kept = [(tree_take(deltas, j), tree_take(full["kept_params"], j))
                    for j in range(k)]
        return (full["payload"], full.get("delta"), full["opt"],
                full["aux"], full["epoch"], full["local_index"],
                full["loss"], full["acc"], kept)

    def _step_budget(self, size: int, scale: float) -> int:
        """A client's local steps this round: ``K``, or under epoch sync
        its own ``ceil(size / B) * E``; a straggler's cut (``scale`` < 1)
        in float32, as the JAX package's."""
        K, B = self.local_steps, self.batch_size
        budget = min(math.ceil(size / B)
                     * self.cfg.federated.num_epochs_per_comm, K) \
            if self.epoch_sync else K
        if self.fault.straggler_rate > 0.0:
            budget = max(math.ceil(float(
                np.float32(budget) * np.float32(scale))), 1)
        return budget

    def _fused_client_round(self, server, clients, idx, x, y, on_aux,
                            weights, budgets, draws):
        """:meth:`_client_loops` for ``client_fusion='fused'``: K steps,
        each ONE forward and backward of the client-fused module
        (``self.fused_module``: a grouped convolution a layer over the k
        clients' packed channels) on all k clients' batches, the loss
        the sum of the per-client batch means, so that each client's
        gradient is its own. ``transform_grads``, the optimizer step and
        ``client_payload`` run per client on the stacked state under
        ``torch.func.vmap``, as the JAX package's fused round runs them
        under ``jax.vmap``. Epoch-sync budgets and straggler cuts mask
        the steps past a client's budget with ``torch.where`` (the JAX
        package's ``mask_steps``) instead of skipping them; epoch, local
        index, loss and accuracy count the active steps only, in the JAX
        package's arithmetic (``epoch + active / nb``). The fusion gate
        (``parallel/fusion.py``) keeps what this step does not thread
        (validation batches, the full-data loss, a carry, dropout, the
        commit's per-client snapshots) off this path."""
        alg, cfg, dev = self.algorithm, self.cfg, self.device
        K, B, k = self.local_steps, self.batch_size, idx.shape[0]
        fused, sp, sa = self.fused_module, server.params, server.aux
        rows = idx.to(dev)
        nb = torch.tensor([float(math.ceil(self.sizes[c] / B))
                           for c in idx.tolist()], device=dev)
        # [K, k]: step s runs for client j while s < its budget
        active = (torch.arange(K)[:, None] < torch.tensor(budgets)[None, :]
                  ).to(dev)
        lrs_of = vmap(lambda e: lr_at(self.schedule, e))
        step_grads = vmap(lambda g, p, a, lr: alg.transform_grads(
            g, params=p, server_params=sp, client_aux=a, server_aux=sa,
            lr=lr))
        step_opt = vmap(lambda p, g, o, lr: optim.local_step(
            p, g, o, lr, cfg.optim))

        params = tree_broadcast_clients(sp, k)
        opt, aux = tree_take(clients.opt, rows), on_aux
        epoch, li = clients.epoch[rows], clients.local_index[rows]
        step_loss, step_acc = [], []
        for s in range(K):
            lr = lrs_of(epoch)  # [k]
            bx, by = x[:, s * B:(s + 1) * B], y[:, s * B:(s + 1) * B]
            if draws is not None:
                # every client's batch at once: the flips and crops are
                # per sample
                bx = augment_image_batch(
                    bx.reshape((k * B,) + tuple(bx.shape[2:])),
                    *(d[:, s].reshape(-1) for d in draws)).reshape(bx.shape)
            leaves = {n: v.detach().requires_grad_(True)
                      for n, v in params.items()}
            logits = functional_call(fused, leaves, (bx,))  # [k, B, V]
            loss_k = per_sample_loss(logits.reshape(k * B, -1),
                                     by.reshape(-1), False).reshape(
                k, B).mean(dim=1)
            # clients are independent: the gradient of the sum is each
            # client's own
            grads = dict(zip(leaves, torch.autograd.grad(
                loss_k.sum(), list(leaves.values()))))
            with torch.no_grad():
                grads = step_grads(grads, params, aux, lr)
                n_params, n_opt = step_opt(params, grads, opt, lr)
                act = active[s]
                if self.mask_steps:
                    def sel(new, old):
                        return torch.where(mask_bcast(act, new), new, old)
                    n_params = tree_map(sel, n_params, params)
                    n_opt = tree_map(sel, n_opt, opt)
                params, opt = n_params, n_opt
                epoch = epoch + act.to(torch.float32) / nb
                li = li + act.to(li.dtype)
                pred = topk_indices(logits, 1)[..., 0]  # [k, B] top-1
                step_loss.append(loss_k.detach())
                step_acc.append((pred == by.to(pred.dtype)).to(
                    torch.float32).mean(dim=1))

        with torch.no_grad():
            deltas = tree_sub(sp, params)
            payloads, aux = vmap(
                lambda d, a, p, lr, ks, w: alg.client_payload(
                    delta=d, client_aux=a, params=p, server_params=sp,
                    server_aux=sa, lr=lr, local_steps=ks, weight=w,
                    full_loss=None))(
                deltas, aux, params, lrs_of(epoch),
                torch.tensor(budgets, device=dev), weights)
            act = active.to(torch.float32)
            n_act = act.sum(dim=0).clamp_min(1.0)
            losses = (torch.stack(step_loss) * act).sum(dim=0) / n_act
            accs = (torch.stack(step_acc) * act).sum(dim=0) / n_act
            kept = [(tree_take(deltas, j), tree_take(params, j))
                    for j in range(k)] if self._client_post else []
        return (payloads, deltas if self.guard_on else None, opt, aux,
                epoch, li, losses, accs, kept)

    def _client_loops(self, server, clients, plan, idx, x, y, block_opt,
                      on_aux, weights, budgets, shards, base_params,
                      base_aux, draws, vrows):
        """The dispatched clients' local loops, one client after another
        (the 'vmap' execution): each client's ``budgets[j]`` steps
        through ``alg.local_step`` from its optimizer rows
        ``block_opt[j]`` and aux row of ``on_aux``, then its payload.
        Returns the stacked
        payloads, the stacked raw deltas (guards on, else None), the
        stacked optimizer state and aux, the round-end epochs and local
        indices [k], the mean loss and accuracy over the steps taken [k]
        and (``client_post`` runs) each client's (delta, round-end
        params)."""
        alg, B = self.algorithm, self.batch_size
        commit = base_params is not None
        payloads, client_opts, client_aux = [], [], []
        epochs, local_index, losses, accs = [], [], [], []
        kept = []  # (delta, round-end params) for client_post
        deltas = []  # the raw deltas the guards judge
        for j, c in enumerate(idx.tolist()):
            size, budget = self.sizes[c], budgets[j]
            nb = math.ceil(size / B)  # batches per local epoch
            # the client's server snapshot: the live state on the sync
            # planes, its dispatch version's on the commit
            base_p = base_params[j] if commit else server.params
            base_a = base_aux[j] if commit else server.aux
            full_loss = self._full_loss(base_p, *shards[j], size) \
                if alg.needs_full_loss else None
            xj, yj = x[j], y[j]
            if alg.needs_val_batch:
                vx = self.val_data.x[c][vrows[j]]
                vy = self.val_data.y[c][vrows[j]]
            params, aux = base_p, tree_take(on_aux, j)
            opt = block_opt[j]
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
                    server_params=base_p, server_aux=base_a,
                    bx=bx, by=by, bval_x=bvx, bval_y=bvy, lr=lr,
                    step_idx=s, local_index=li, step_budget=budget,
                    rng=rng)
                epoch = epoch + 1.0 / nb
                li = li + 1
                step_loss.append(loss)
                step_acc.append(acc)
            with torch.no_grad():
                delta = tree_sub(base_p, params)
                payload, aux = alg.client_payload(
                    delta=delta, client_aux=aux, params=params,
                    server_params=base_p, server_aux=base_a,
                    lr=lr_at(self.schedule, epoch), local_steps=budget,
                    weight=weights[j], full_loss=full_loss)
            payloads.append(payload)
            client_opts.append(opt)
            client_aux.append(aux)
            epochs.append(epoch)
            local_index.append(li)
            losses.append(torch.stack(step_loss).sum() / budget)
            accs.append(torch.stack(step_acc).sum() / budget)
            if self._client_post:
                kept.append((delta, params))
            if self.guard_on:
                deltas.append(delta)

        with torch.no_grad():
            return (tree_stack(payloads),
                    tree_stack(deltas) if self.guard_on else None,
                    tree_stack(client_opts), tree_stack(client_aux),
                    torch.stack(epochs), torch.stack(local_index),
                    torch.stack(losses), torch.stack(accs), kept)

    def _round_metrics(self, server, k, rows_dev, losses, accs, cplan,
                       survive, avail, accept, fault_counts, dp_frac,
                       dp_sigma, cohort=None) -> RoundMetrics:
        """The round's :class:`RoundMetrics`: per-client leaves of the
        reporters ('perm': scattered into [C]; 'sparse': the [k']
        rows), the uplink bytes of the reporters, the fault planes'
        counts (the chaos and availability counts known on the host,
        moved in one copy) and, with cohort statistics on, the cohort
        fields (the staleness the sync planes' zeros; the commit
        overwrites it)."""
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
        cohort_fields = {}
        if cohort is not None:
            cohort_fields = dict(
                cohort_idx=rows_dev.to(torch.int32),
                cohort_online=online_k * torch.ones(k, device=dev),
                cohort_accept=cohort["accept"],
                cohort_selected=cohort["sel"],
                cohort_suspicion=cohort["susp"],
                cohort_staleness=torch.zeros(k, device=dev),
                cohort_norm_q=cohort["norm_q"],
                cohort_dispersion=cohort["disp"])
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
            dp_noise_sigma=dp_sigma, **cohort_fields)

    def _aggregate(self, stacked, wire_deltas, weights, robust_m, survive,
                   riders=None):
        """The aggregation seam on the stacked [k'] wire payloads:
        ``survive`` [k'] the reporters (None: every client reports, no
        chaos or availability plane). With the guards on, screen the
        payloads on ``wire_deltas``; else zero the payloads that did not
        report. Then the DP clip, then the robust rule, or the plain sum
        (armed: the grouped sum of ``parallel/podscale.py``)
        renormalized over the accepted clients. Returns (sum, the new
        ``norm_bound`` momentum or None, the [4] counts rejected,
        clipped, selected, trimmed, the accept mask or None, the DP
        clip's share or None, and with cohort statistics on the cohort's
        evidence: the accept and selection masks, the suspicion, the
        update-norm quantiles and the dispersion; else None).

        Under client sharding ``stacked`` holds this rank's rows of the
        cohort (``weights`` and ``survive`` stay [k']), and ``riders``, a
        dict of per-client trees of those rows, rides the seam's one
        gather: its entries are replaced in place by all k' rows. The
        guards' screen gathers the whole cohort's update norms first
        (``podscale.gather_row_stats``)."""
        k = weights.shape[0]
        lo, hi = self.seam_rows(k)
        counts = torch.zeros(4, device=weights.device)
        accept = None
        if self.guard_on:
            gather = None
            if self.client_shards > 1:
                # the median is over the whole cohort's norms: each
                # rank's [k/S] come to every rank of its shard group
                def gather(norms, finite):
                    before = gathered_bytes("norms")
                    out = gather_row_stats(norms, finite, self.mesh,
                                           self.client_shards)
                    self._norm_bytes = float(gathered_bytes("norms")
                                             - before)
                    return out
            stacked, report = screen_payloads(
                wire_deltas, stacked, survive if survive is not None
                else torch.ones(k, device=weights.device), self.fault,
                rows=(lo, hi), gather=gather)
            accept = report.accept
            counts[0], counts[1] = report.rejected, report.clipped
        elif survive is not None:
            accept = survive
            stacked = tree_map(lambda p: torch.where(
                mask_bcast(accept[lo:hi].bool(), p), p, torch.zeros_like(p)),
                stacked)
        dp_frac = clip_flags = None
        if self.dp_on:
            # every reporter's sensitivity bounded before any rule
            stacked, clip_flags = dp_clip_rows(
                stacked, weights[lo:hi], self.fault.dp_clip_norm)
        accept_f = accept if accept is not None \
            else torch.ones_like(weights)
        cohort = None
        if self.robust_rule != "mean":
            if self.dp_on:
                dp_frac = dp_clip_share(clip_flags, weights, accept)
            payload_sum, new_m, rep = robust_aggregate(
                self.robust_rule, stacked, weights, accept_f, self.fault,
                momentum=robust_m, per_client=self.cohort_stats)
            counts[2], counts[3] = rep.selected, rep.trimmed
            if self.cohort_stats:
                # the rule's own evidence is the suspicion; the gauges
                # come from the shared cohort statistics
                cs = cohort_statistics(stacked, weights, accept_f)
                cohort = {"accept": accept_f, "sel": rep.sel_mask,
                          "susp": rep.suspicion, "norm_q": cs.norm_q,
                          "disp": cs.dispersion}
            return payload_sum, new_m, counts, accept, dp_frac, cohort
        if self.podscale_armed:
            # the grouped sum, association a function of k alone; under
            # sharding its one gather also brings the riders (and the DP
            # clip flags) of every rank
            self._allreduce_bytes = cohort_allreduce_bytes(stacked, k)
            if self.client_shards > 1:
                ride = dict(riders)
                if clip_flags is not None:
                    ride["dp_clip"] = clip_flags
                before = gathered_bytes()
                payload_sum, ride = cohort_hierarchical_sum(
                    stacked, self.mesh, self.client_shards, ride)
                self._gather_bytes = float(gathered_bytes() - before)
                clip_flags = ride.pop("dp_clip", None)
                riders.update(ride)
            else:
                payload_sum = cohort_hierarchical_sum(stacked)
                self._gather_bytes = 0.0
        else:
            payload_sum = tree_map(lambda p: p.sum(dim=0), stacked)
        if self.dp_on:
            dp_frac = dp_clip_share(clip_flags, weights, accept)
        if accept is not None:
            # rejected weight redistributed over the accepted clients;
            # an all-rejected round sums to 0 and the server holds
            payload_sum = renormalize_accepted(payload_sum, weights, accept)
        if self.cohort_stats:
            cs = cohort_statistics(stacked, weights, accept_f)
            cohort = {"accept": accept_f,
                      "sel": accept_f * (weights > 0.0).to(accept_f.dtype),
                      "susp": cs.suspicion, "norm_q": cs.norm_q,
                      "disp": cs.dispersion}
        return payload_sum, None, counts, accept, dp_frac, cohort

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
                           extra: Optional[dict] = None,
                           ledger: bool = False):
        """Everything the CLI's round loop logs, in one transfer (which
        waits for the round): the mean training epoch over the clients,
        the learning rate at it, the reporters' count, loss and accuracy
        sums, the uplink bytes and the fault planes' counts (the JAX
        package's ``round_scalars_dev``), with cohort statistics on the
        dispersion, with DP armed the clip's share and the applied noise
        stddev, and ``extra``'s 0-d tensors by name (the supervisor's
        finite flag rides the same transfer). ``ledger=True`` returns
        ``(scalars, vectors)``: the ledger's cohort vectors
        (:meth:`cohort_vectors`, None with stats off) ride the same
        transfer (ids as float32: exact below 2^24 clients)."""
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
        if metrics.cohort_dispersion is not None:
            names.append("cohort_dispersion")
            vals.append(metrics.cohort_dispersion)
        if metrics.dp_clipped_frac is not None:
            names += ["dp_clipped_frac", "dp_noise_sigma"]
            vals += [metrics.dp_clipped_frac, metrics.dp_noise_sigma]
        for name, v in (extra or {}).items():
            names.append(name)
            vals.append(v.to(mean_epoch.device))
        flat = torch.stack([v.to(torch.float32) for v in vals])
        vecs = self.cohort_vectors(metrics) if ledger else None
        if vecs is not None:
            flat = torch.cat([flat] + [v.to(torch.float32).reshape(-1)
                                       for v in vecs.values()])
        host = flat.tolist()
        sc = dict(zip(names, host[:len(names)]))
        if not ledger:
            return sc
        led = None
        if vecs is not None:
            led, at = {}, len(names)
            for name, v in vecs.items():
                led[name] = np.asarray(host[at:at + v.numel()],
                                       np.float32).reshape(v.shape)
                at += v.numel()
            led["idx"] = led["idx"].astype(np.int64)
        return sc, led

    @staticmethod
    def cohort_vectors(metrics: RoundMetrics) -> Optional[dict]:
        """The ledger's per-client cohort vectors on the device (the
        JAX package's ``cohort_fetch_dev``): the cohort's ids, its
        online, accept and selection masks, the rule's suspicion, the
        per-job staleness and the [5] update-norm quantiles; None with
        cohort statistics off."""
        if metrics.cohort_idx is None:
            return None
        return {"idx": metrics.cohort_idx, "online": metrics.cohort_online,
                "accept": metrics.cohort_accept,
                "selected": metrics.cohort_selected,
                "suspicion": metrics.cohort_suspicion,
                "staleness": metrics.cohort_staleness,
                "norm_q": metrics.cohort_norm_q}

    @property
    def cohort_width(self) -> int:
        """The width of a round's cohort: ``k_dispatch`` (the commit
        buffer on the async plane)."""
        return self.k_dispatch

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
        noising); under the async plane's ring wrap too."""
        if not self.dp_on:
            raise ValueError(
                "dp_set_noise_scale on a trainer without DP armed "
                "(fault.dp_noise_multiplier == 0)")
        aux, ring = server.aux, None
        if "ring" in aux:
            ring, aux = aux["ring"], aux["alg"]
        leaf = aux["dp_noise_scale"]
        aux = dict(aux, dp_noise_scale=torch.tensor(
            value, dtype=torch.float32, device=leaf.device))
        if ring is not None:
            aux = {"alg": aux, "ring": ring}
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
                schedule=self._stream_schedule(server),
                depth=self.stream_depth, window=window,
                feed_layout=self.feed_layout, device=self.device,
                timeout_s=self.stream_timeout_s,
                cohort_rows=self.cohort_rows(self.cohort_width)
                if self.podscale_armed or self.flat_ranks else None,
                whole_pre=self._pre_round)
            # a trainer dropped without close() must not leave the
            # producer thread running (the producer holds no reference
            # back to the trainer)
            self._stream_finalizer = weakref.finalize(
                self, StreamFeedProducer.close, self._stream)
        return self._stream.next_feed()

    def _stream_schedule(self, server: ServerState) -> RoundSchedule:
        """The producer's plan schedule from the live generator and
        round (the async trainer's draws commits)."""
        return RoundSchedule(self.plan_drawer(), server.rng, server.round)

    def peek_plan(self, server: ServerState,
                  generator: torch.Generator) -> RoundPlan:
        """The plan the next round on ``server`` draws, drawn from
        ``generator`` (a clone of ``server.rng``: the supervisor learns
        which clients' rows the round writes)."""
        return self.plan_drawer()(generator, server.round,
                                  self._alg_aux(server.aux))

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
        its last (re)start), the rebuild count and, armed, the client
        shards and the seam's gather bytes. Host counters only: reading
        them costs no device sync."""
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
            if "shard_rows" in ss:
                out.update(stream_shard_rows=float(ss["shard_rows"]),
                           stream_shard_pack_s=ss["shard_pack_s"])
        if self.data_plane == "stream":
            out["stream_rebuilds"] = float(self._stream_rebuilds)
        if self.podscale_armed:
            # the shard count, the [G, P] bytes of the seam's gather and
            # the bytes of its whole buffer a round (both absent before
            # the first round)
            out["client_shards"] = float(self.client_shards)
            if self._allreduce_bytes is not None:
                out["cohort_allreduce_bytes"] = self._allreduce_bytes
                out["cohort_gather_bytes"] = self._gather_bytes
        if self.podscale_armed or self.state_sharded:
            # the bytes this rank holds of the client state and of the
            # population (device plane); the bytes the exchange, the
            # guards' norm gather and the 1-D mesh's cohort gather
            # brought it a round (absent until one ran)
            out["client_state_bytes"] = float(self._client_state_bytes)
            out["population_bytes"] = float(sum(
                t.numel() * t.element_size() for t in self.data)) \
                if self.data is not None else 0.0
            if self._exchange_bytes is not None:
                out["client_exchange_bytes"] = self._exchange_bytes
            if self._norm_bytes is not None:
                out["guard_norm_gather_bytes"] = self._norm_bytes
            if self._cohort_bytes is not None:
                out["flat_cohort_gather_bytes"] = self._cohort_bytes
        return out

    def staleness_histogram(self) -> Optional[dict]:
        """The async plane's staleness histogram; None on the sync
        planes."""
        return None

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
