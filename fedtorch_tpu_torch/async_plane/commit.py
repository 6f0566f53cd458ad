"""The asynchronous buffered federation plane, a FedBuff-style server
(port of ``fedtorch_tpu/async_plane/commit.py``).

``cfg.federated.sync_mode='async'`` replaces the blocking round with a
COMMIT loop (Nguyen et al., arXiv:2106.06639): ``concurrency`` clients
are always training, each against the server snapshot current at its
dispatch; the server folds finished updates into a buffer of ``m =
async_buffer_size`` and commits when it fills, so the commit clock
follows the fastest m arrivals and a straggler delays only itself.

* **Event schedule** (:mod:`.scheduler`): which clients commit, against
  which versions, is a pure function of (the run's fault key, commit).
* **Snapshot ring**: ``server.aux`` is wrapped as ``{'alg': <aux>,
  'ring': {'params', 'aux'}}``, the last ``snapshot_ring`` committed
  (params, server aux) versions as stacked ``[R]`` trees. The wrap
  composes outside the engine's own (``{'alg': ..., 'norm_bound_m',
  'dp_noise_scale', 'fault_key'}``), as the JAX package composes it, and
  rides the checkpoint payload, so a resumed run continues bitwise.
* **Staleness weighting** (:mod:`.staleness`), composed into the
  aggregation weights before the guards' renormalization.
* **The commit** (``parallel/round_program.py``): the round core
  through its commit seam, each job from its own snapshot (SCAFFOLD's
  control step and control update read the stale server control the
  client trained against), the server step against the current params,
  the ring rotated.

:meth:`AsyncFederatedTrainer.run_round` runs one commit, and
``server.round`` counts commit versions, so the CLI's loop,
checkpoints, the drain and the supervisor work unchanged. Each commit's
rows, augmentation, dropout keys and fault uniforms are drawn from the
server's generator after the schedule gives its clients (the stream
plane's producer draws the same on a clone, and each consumed commit is
checked against the generator). The schedule hangs off the fault key,
not the generator: a supervisor's rollback drops it and the next commit
rebuilds it from the restored commit by fast-forward, and a reseeded
retry (a new generator) trains the same clients against the same
versions on other rows.

Refused by name (``round_program.validate_cell``): algorithms outside
``ASYNC_ALGORITHMS``, the personalized families and their val streams,
and client fusion; here: a buffer larger than the concurrency, and a
population smaller than concurrency + buffer. Under client sharding
(``mesh.client_shards``) the commit's ``[m]`` buffer splits over the
shards as a round's cohort does (:attr:`AsyncFederatedTrainer.
cohort_width`): each rank runs, and on the stream plane packs, its
``m/S`` jobs, as the JAX package's commit places them (``commit.py``
``cohort_sharding``). The JAX package's
``lowered_cost_programs`` has no port (it lowers XLA programs).
"""
from __future__ import annotations

from typing import Optional

import torch

from fedtorch_tpu_torch.async_plane.scheduler import AsyncSchedule
from fedtorch_tpu_torch.core.state import tree_broadcast_clients
from fedtorch_tpu_torch.data.streaming import RoundSchedule
from fedtorch_tpu_torch.parallel.federated import (
    FederatedTrainer, PlanDrawer, RoundPlan,
)
from fedtorch_tpu_torch.parallel.round_program import (
    ASYNC_ALGORITHMS, CommitJobs,
)
from fedtorch_tpu_torch.robustness.availability import (
    make_availability_model,
)

__all__ = ["ASYNC_ALGORITHMS", "AsyncFederatedTrainer", "CommitJobs"]


def _gate(why: str) -> ValueError:
    """The scheduler's feasibility refusals (buffer and population)."""
    return ValueError(
        f"sync_mode='async' is unsupported here: {why}; "
        "use --sync_mode sync")


def draw_commit(drawer: PlanDrawer, sched: AsyncSchedule,
                generator: torch.Generator, commit: int) -> RoundPlan:
    """Commit ``commit``'s plan: the schedule's next buffered jobs, then
    their rows and draws from ``generator`` (the plan drawer with the
    jobs' clients as its cohort)."""
    hp = sched.next_commit()
    if hp.commit != commit:
        raise RuntimeError(f"async schedule stands at commit {hp.commit}, "
                           f"asked for commit {commit}")
    idx = torch.from_numpy(hp.idx.astype("int64"))
    jobs = CommitJobs(
        idx=idx, version=torch.from_numpy(hp.version.astype("int64")),
        dispatch=torch.from_numpy(hp.dispatch.astype("int64")),
        straggler=torch.from_numpy(hp.straggler))
    return drawer(generator, commit, None, idx=idx)._replace(jobs=jobs)


class AsyncFederatedTrainer(FederatedTrainer):
    """The trainer for ``sync_mode='async'``: :meth:`run_round` runs one
    COMMIT on either data plane."""

    supports_async = True
    construction_dispatch = "commit"

    def __init__(self, cfg, model, algorithm, data, val_data=None,
                 device=None):
        fed = cfg.federated
        k_online = max(int(fed.online_client_rate * data.num_clients), 1)
        self.concurrency = fed.async_concurrency or k_online
        self.buffer_size = fed.async_buffer_size or max(
            1, self.concurrency // 2)
        if self.buffer_size > self.concurrency:
            raise _gate(
                f"async_buffer_size ({self.buffer_size}) exceeds the "
                f"in-flight concurrency ({self.concurrency}) — a commit "
                "could never fill")
        if data.num_clients < self.concurrency + self.buffer_size:
            raise _gate(
                f"num_clients ({data.num_clients}) must be >= "
                f"concurrency + buffer ({self.concurrency} + "
                f"{self.buffer_size}) so every arrival has a distinct "
                "replacement to dispatch")
        self.snapshot_ring = fed.snapshot_ring
        super().__init__(cfg, model, algorithm, data, val_data=val_data,
                         device=device)
        self._commit_fn = self.programs.build("commit")
        self._sched: Optional[AsyncSchedule] = None
        # (commit, schedule standing before it) for peek_plan
        self._peek: Optional[tuple] = None
        # the last scheduler's staleness histogram, kept across
        # invalidate_stream for the run-end event
        self._hist_stash: Optional[dict] = None

    @property
    def cohort_width(self) -> int:
        """The commit's m buffered jobs are its cohort: under client
        sharding each rank runs and packs its block of them."""
        return self.buffer_size

    @property
    def metrics_width(self) -> int:
        """'sparse' commits emit [m]-wide per-client metrics (the m
        buffered jobs are the commit's cohort); 'perm' keeps [C]."""
        return self.buffer_size if self.participation_mode == "sparse" \
            else self.num_clients

    # -- state -----------------------------------------------------------
    def init_state(self, rng):
        """Sync init, then the snapshot ring around the server aux: every
        slot starts as version 0, what the first in-flight cohort trains
        against."""
        server, clients = super().init_state(rng)
        R = self.snapshot_ring
        ring = {"params": tree_broadcast_clients(server.params, R),
                "aux": tree_broadcast_clients(server.aux, R)}
        return server._replace(aux={"alg": server.aux, "ring": ring}), \
            clients

    @staticmethod
    def fault_key(server) -> int:
        """The run's fault key (the schedule's draws hang off it)."""
        return int(server.aux["alg"]["fault_key"])

    def commit_plan_drawer(self) -> PlanDrawer:
        """The plan drawer with the commit's m jobs as its cohort."""
        drawer = self.plan_drawer()
        drawer.k = self.buffer_size
        return drawer

    def _schedule_args(self) -> dict:
        flt = self.fault
        return dict(
            num_clients=self.num_clients, concurrency=self.concurrency,
            buffer_size=self.buffer_size, ring_size=self.snapshot_ring,
            participation_mode=self.participation_mode,
            straggler_rate=flt.straggler_rate,
            straggler_step_frac=flt.straggler_step_frac,
            # built fresh per schedule: a rebuilt one replays the same
            model=make_availability_model(flt))

    def new_schedule(self, server) -> AsyncSchedule:
        """A schedule fast-forwarded to the server's commit."""
        return AsyncSchedule(self.fault_key(server),
                             start_commit=server.round,
                             **self._schedule_args())

    # -- the commit ------------------------------------------------------
    def draw_plan(self, server) -> RoundPlan:
        """The next commit's plan: the schedule's jobs, their draws from
        ``server.rng``."""
        if self._sched is None:
            self._sched = self.new_schedule(server)
        return draw_commit(self.commit_plan_drawer(), self._sched,
                           server.rng, server.round)

    def peek_plan(self, server, generator) -> RoundPlan:
        """The plan of the commit on ``server``, drawn from
        ``generator``, without taking it from the live schedule (which
        on the stream plane runs ahead in the producer)."""
        commit = server.round
        if self._peek is not None and self._peek[0] == commit - 1:
            sched = self._peek[1]
            sched.next_commit()
        elif self._peek is not None and self._peek[0] == commit:
            sched = self._peek[1]
        else:
            sched = self.new_schedule(server)
        self._peek = (commit, sched)
        return draw_commit(self.commit_plan_drawer(), sched.clone(),
                           generator, commit)

    def round_fn(self, server, clients, plan: Optional[RoundPlan] = None):
        """One commit on the device plane; ``plan`` (with its ``jobs``)
        defaults to :meth:`draw_plan`."""
        if plan is None:
            plan = self.draw_plan(server)
        return self._commit_fn(server, clients, plan)

    def round_stream_fn(self, server, clients, feed):
        """One commit from a commit-keyed feed."""
        return self._commit_fn(server, clients, feed)

    def _stream_schedule(self, server) -> RoundSchedule:
        sched = self.new_schedule(server)
        # the producer thread owns it: its counters may run up to the
        # prefetch depth ahead of the last consumed commit
        self._sched = sched
        drawer = self.commit_plan_drawer()
        # no reference to the trainer in the producer's closure
        return RoundSchedule(
            lambda gen, commit: draw_commit(drawer, sched, gen, commit),
            server.rng, server.round)

    def invalidate_stream(self) -> None:
        """Also drop the event schedule (a rollback, reseed, resume or
        drain rewrote the state it replays); the next commit rebuilds it
        from the live commit. The staleness histogram is kept first."""
        if self._sched is not None and self._sched.staleness_hist:
            self._hist_stash = dict(self._sched.staleness_hist)
        super().invalidate_stream()
        self._sched = None

    # -- host telemetry --------------------------------------------------
    @property
    def schedule_stats(self):
        """The scheduler's counters; None before the first commit."""
        return self._sched.stats if self._sched is not None else None

    def telemetry_gauges(self) -> dict:
        """The stream gauges (on that plane) and the commit plane's:
        the buffer, the scheduler's dispatch, straggler, ring-clamp and
        dropout counters, and the commit rate in virtual time. Host
        counters only."""
        out = super().telemetry_gauges()
        sched = self._sched
        if sched is None:
            return out
        st = sched.stats
        ct = sched.commit_times
        out.update({
            "async_dispatches": float(st.dispatches),
            "async_stragglers": float(st.stragglers),
            "async_ring_clamped": float(st.staleness_clamped),
            "async_dropouts": float(st.dropouts),
            "async_buffer": float(self.buffer_size),
            "async_commit_rate": (len(ct) / ct[-1])
            if ct and ct[-1] > 0 else 0.0,
        })
        return out

    def staleness_histogram(self) -> Optional[dict]:
        """{commits stale: count} over every committed update so far
        (after the ring clamp), or the one kept across the last
        :meth:`invalidate_stream`."""
        if self._sched is not None and self._sched.staleness_hist:
            return dict(self._sched.staleness_hist)
        return dict(self._hist_stash) if self._hist_stash else None


