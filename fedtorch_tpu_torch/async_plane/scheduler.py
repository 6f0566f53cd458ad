"""Deterministic event schedule for the async commit plane (port of
``fedtorch_tpu/async_plane/scheduler.py``).

The asynchronous server is simulated as a discrete-event system:
``concurrency`` clients are always training ("in flight"), each against
the snapshot version current at its dispatch; per-dispatch completion
delays, straggler flags and mid-round dropouts come from a
:class:`~fedtorch_tpu_torch.robustness.availability.AvailabilityModel`.
:meth:`AsyncSchedule.next_commit` pops the next ``buffer_size`` arrivals
and re-dispatches each arrival's replacement (drawn uniformly from the
clients neither in flight nor already buffered) against the current
commit version: FedBuff's server loop (Nguyen et al., arXiv:2106.06639,
Alg. 1). No update exists before its commit: "in flight" is
bookkeeping, and the commit trains the m buffered clients at once.

Where the JAX package draws with threefry off ``server.rng``, the port
hashes every draw off the run's fault key (``init_state`` draws it into
the server aux under ``sync_mode='async'``): a dispatch's columns are
the availability model's ``columns(fault_key, dispatch_ids, clients,
versions)``, and each replacement draw is ``hash_uniforms(fault_key,
_SELECT_SALT, [draw], C)`` (``'perm'``: the stable argsort of the [C]
scores, first id not excluded) or ``floor(C * u)`` of one uniform
(``'sparse'``: rejection sampling in O(1) memory; 24-bit uniforms, so
ids past 2^24 clients are not reached). The commit sequence is a pure
function of (fault key, commit), so a resumed or rolled-back run
rebuilds its schedule by fast-forwarding (``start_commit``) without
training, and a supervisor's reseeded retry, which reseeds the
generator, leaves the schedule as it was. ``columns_fn`` and
``select_fn`` replace the two streams (tests feed the JAX scheduler's
own through them).
"""
from __future__ import annotations

import copy
import heapq
from typing import Callable, List, NamedTuple, Optional, Set, Tuple

import numpy as np

from fedtorch_tpu_torch.robustness.availability import (
    LEGACY_DELAY_SALT, AvailabilityModel, DefaultAvailability,
)
from fedtorch_tpu_torch.robustness.chaos import hash_uniforms

# the salt of the replacement draws off the fault key (the JAX package's
# fold constant)
_SELECT_SALT = 0x7FFFFFF5


class HostCommitPlan(NamedTuple):
    """One commit's buffered arrivals, in arrival order (host numpy).
    ``commit`` is the version this commit was built against (the server
    round that consumes it); committing produces ``commit + 1``."""
    commit: int
    idx: np.ndarray        # [m] int32 client ids (distinct)
    version: np.ndarray    # [m] int32 snapshot version each trained on
                           # (clamped into the ring window)
    dispatch: np.ndarray   # [m] int32 global dispatch counter
    straggler: np.ndarray  # [m] float32 {0,1} tail-delay dispatches
    arrival_times: np.ndarray  # [m] float64 virtual arrival times
    commit_time: float     # virtual time the buffer filled


class ScheduleStats(NamedTuple):
    dispatches: int
    stragglers: int
    staleness_clamped: int  # arrivals older than the snapshot ring
    dropouts: int = 0       # mid-round dropouts (arrival discarded,
                            # replacement dispatched)


class AsyncSchedule:
    """The event simulation: a pure function of (fault key, constructor
    arguments). Two instances with equal arguments produce the same
    commit sequence, and ``start_commit > 0`` fast-forwards a fresh one
    to a resumed run's commit."""

    def __init__(self, fault_key: int, *, num_clients: int,
                 concurrency: int, buffer_size: int, ring_size: int,
                 straggler_rate: float, straggler_step_frac: float,
                 jitter: float = 0.25, start_commit: int = 0,
                 model: Optional[AvailabilityModel] = None,
                 participation_mode: str = "perm",
                 columns_fn: Optional[Callable] = None,
                 select_fn: Optional[Callable] = None):
        if buffer_size < 1 or concurrency < 1:
            raise ValueError("buffer_size and concurrency must be >= 1")
        if participation_mode not in ("perm", "sparse"):
            raise ValueError(
                f"participation_mode must be 'perm' or 'sparse', got "
                f"{participation_mode!r}")
        if num_clients < concurrency + buffer_size:
            raise ValueError(
                f"async plane needs num_clients >= concurrency + "
                f"buffer_size ({concurrency} + {buffer_size}) so every "
                f"arrival has a distinct replacement to dispatch; got "
                f"{num_clients} clients")
        self.num_clients = num_clients
        self.concurrency = concurrency
        self.buffer_size = buffer_size
        self.ring_size = ring_size
        self.participation_mode = participation_mode
        self.fault_key = int(fault_key)
        model = model if model is not None else DefaultAvailability(
            straggler_rate=straggler_rate,
            straggler_step_frac=straggler_step_frac, jitter=jitter)
        self._model = model
        key = self.fault_key
        # (dispatch ids, clients, versions) -> [n, cols] uniforms
        self._columns = columns_fn if columns_fn is not None else (
            lambda d, c, v: model.columns(key, d, c, v))
        if select_fn is not None:
            self._select = select_fn
        elif participation_mode == "sparse":
            self._select = lambda i: int(
                float(hash_uniforms(key, _SELECT_SALT, [i], 1)[0, 0])
                * num_clients)
        else:
            self._select = lambda i: hash_uniforms(
                key, _SELECT_SALT, [i], num_clients)[0]

        # event state: min-heap of (finish_time, dispatch_id, client,
        # version, straggler, dropped); the dispatch id breaks ties
        self._heap: List[Tuple[float, int, int, int, bool, bool]] = []
        self._inflight: Set[int] = set()
        self._dispatch_count = 0
        self._select_count = 0
        self._commit = 0
        self._stragglers = 0
        self._dropouts = 0
        self._clamped = 0
        self.commit_times: List[float] = []
        # {commits stale: count} over every committed update (after the
        # ring clamp); a fast-forwarded resume rebuilds it exactly
        self.staleness_hist: dict = {}

        # the initial cohort: ``concurrency`` distinct clients against
        # version 0 at time 0
        if participation_mode == "sparse":
            cohort: List[int] = []
            while len(cohort) < concurrency:
                c = self._draw()
                if c not in cohort:
                    cohort.append(c)
            for c in cohort:
                self._dispatch(c, version=0, now=0.0)
        else:
            scores = self._draw()
            for c in np.argsort(scores, kind="stable")[:concurrency]:
                self._dispatch(int(c), version=0, now=0.0)
        for _ in range(start_commit):
            self.next_commit()

    def clone(self) -> "AsyncSchedule":
        """An independent copy at the same point of the sequence (to
        read the next commit without taking it)."""
        return copy.deepcopy(self)

    def _draw(self):
        """The next replacement draw: [C] scores ('perm') or one id
        ('sparse'); the count advances per draw, rejections included."""
        out = self._select(self._select_count)
        self._select_count += 1
        return out

    def _dispatch(self, client: int, version: int, now: float) -> None:
        did = self._dispatch_count
        self._dispatch_count += 1
        u = np.asarray(self._columns(np.asarray([did], np.int64),
                                     np.asarray([client], np.int64),
                                     np.asarray([version], np.int64)),
                       np.float64)
        delay, straggler, dropped = self._model.finish(
            u, np.asarray([version], np.int32))
        if straggler[0]:
            self._stragglers += 1
        heapq.heappush(self._heap, (now + float(delay[0]), did, client,
                                    version, bool(straggler[0]),
                                    bool(dropped[0])))
        self._inflight.add(client)

    def _pick_replacement(self, exclude: Set[int]) -> int:
        if self.participation_mode == "sparse":
            # |exclude| < num_clients (constructor guard): the
            # acceptance probability is above 0
            while True:
                c = self._draw()
                if c not in exclude:
                    return c
        for c in np.argsort(self._draw(), kind="stable"):
            if int(c) not in exclude:
                return int(c)
        raise RuntimeError("no dispatchable client (guarded by the "
                           "num_clients >= concurrency + buffer check)")

    def next_commit(self) -> HostCommitPlan:
        """Pop the next ``buffer_size`` arrivals; re-dispatch each
        arrival's replacement at once, against the current commit
        version."""
        m = self.buffer_size
        buffer: List[Tuple[float, int, int, int, bool]] = []
        buffered: Set[int] = set()
        while len(buffer) < m:
            t, did, client, version, straggler, dropped = \
                heapq.heappop(self._heap)
            self._inflight.discard(client)
            if dropped:
                # a mid-round dropout never reports: the slot re-fills,
                # and the offline client is not its own replacement
                self._dropouts += 1
                repl = self._pick_replacement(
                    self._inflight | buffered | {client})
                self._dispatch(repl, version=self._commit, now=t)
                continue
            buffer.append((t, did, client, version, straggler))
            buffered.add(client)
            repl = self._pick_replacement(self._inflight | buffered)
            self._dispatch(repl, version=self._commit, now=t)

        floor = max(self._commit - (self.ring_size - 1), 0)
        versions = np.asarray([v for _, _, _, v, _ in buffer], np.int64)
        clamped = np.maximum(versions, floor)
        self._clamped += int(np.sum(clamped != versions))
        for s in (self._commit - clamped).tolist():
            self.staleness_hist[int(s)] = \
                self.staleness_hist.get(int(s), 0) + 1
        plan = HostCommitPlan(
            commit=self._commit,
            idx=np.asarray([c for _, _, c, _, _ in buffer], np.int32),
            version=clamped.astype(np.int32),
            dispatch=np.asarray([d for _, d, _, _, _ in buffer],
                                np.int32),
            straggler=np.asarray([s for *_, s in buffer], np.float32),
            arrival_times=np.asarray([t for t, *_ in buffer]),
            commit_time=buffer[-1][0])
        self._commit += 1
        self.commit_times.append(plan.commit_time)
        return plan

    @property
    def commit(self) -> int:
        return self._commit

    @property
    def stats(self) -> ScheduleStats:
        return ScheduleStats(dispatches=self._dispatch_count,
                             stragglers=self._stragglers,
                             staleness_clamped=self._clamped,
                             dropouts=self._dropouts)


def simulate_sync_round_times(fault_key: int, *, rounds: int,
                              k_online: int, straggler_rate: float,
                              straggler_step_frac: float,
                              jitter: float = 0.25) -> np.ndarray:
    """Virtual duration of each SYNC round under the default delay
    model: the server waits for all k online clients, so a round costs
    the largest of its k dispatch delays."""
    u = hash_uniforms(fault_key, LEGACY_DELAY_SALT,
                      np.arange(rounds * k_online), 2).astype(np.float64)
    base = 1.0 + jitter * u[:, 1]
    tail = 1.0 / float(straggler_step_frac)
    delays = np.where(u[:, 0] < straggler_rate, base * tail, base)
    return delays.reshape(rounds, k_online).max(axis=1)
