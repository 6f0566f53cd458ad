"""Host-side round supervisor: rollback + retry instead of dying (port of
``fedtorch_tpu/robustness/supervisor.py``).

The reference's failure story is fail-stop: a diverged model or a dead
process kills the job. The supervisor wraps ``trainer.run_round`` as the
JAX package's does:

1. snapshot what the round writes;
2. run the round and health-check the result, on the round's ONE
   batched fetch (``round_host_scalars`` with the finite flag riding
   along): non-finite server params always count as divergence; with
   ``fault.loss_blowup_factor > 0`` a mean online loss above that
   multiple of the running loss EMA does too;
3. on divergence, roll back to the snapshot and retry with exponential
   backoff; each retry reseeds the server's generator
   (``fault.reseed_on_retry``) — a round replayed unchanged would
   reproduce the failure, so the retry draws a fresh participation and
   fault schedule;
4. after ``fault.max_retries`` failed retries, keep the rolled-back
   (healthy) state, advance the round counter and the generator (the
   round is SKIPPED; see below) and report it as the
   ``supervisor.round_skipped`` event.

Skips carry a CAUSE: ``"fault"`` (divergence or a host seam's error) or
``"quorum"`` (the availability lifecycle reported a sub-quorum cohort
and ``fault.avail_quorum_action='abort'`` escalates it here instead of
committing the degraded partial aggregate; the retry reseed draws a
fresh availability schedule). If the in-memory snapshot is itself sick,
the last on-disk checkpoint under ``checkpoint_dir`` is restored.

An exception never becomes a skipped round unless it is a
``HostSeamError`` (a host seam that exhausted its own recovery): when
any attempt raised anything else, or every attempt raised, the round is
rolled back and the last such exception is re-raised as itself. Skipping
a round cannot fix a structurally broken program, and a hand kernel that
fails to build or launch must surface by name, never as a skipped round.

What differs from the JAX package, and why:

* **The port writes client state in place** (``core/state.py``); the
  JAX round is functional and its supervisor holds device copies of the
  whole server and client trees. A full clone of the client state does
  not fit on the card in every cell (WideResNet-28-10: 100 x 3 x
  36,479,194 x 4 B = 43.8 GB; two copies are 87.6 GB on an 80 GB card).
  So the snapshot holds only what a round writes: the server (params,
  optimizer state and aux cloned, the generator's state), the ``[C]``
  ``epoch`` and ``local_index``, and the rows of the clients each
  attempt dispatches. Those rows are learned by drawing the attempt's
  plan on a clone of the generator (``trainer.plan_drawer()``, the
  drawer both data planes use) before the attempt runs; a rollback
  writes every attempt's saved rows back in place (each was taken from
  the pre-round state, so their order does not matter).
* **The retry reseed.** JAX folds ``RESEED_SALT + attempt`` into the
  round key. The port's generator is a CPU ``torch.Generator``, so its
  reseed is the port's own deterministic function of the snapshot's
  generator state and the attempt: the generator of attempt ``a >= 1``
  is ``torch.Generator().manual_seed(s)`` with ``s`` the first 8 bytes
  (big-endian, shifted right by one) of ``sha256(state ||
  (RESEED_SALT + a) as 8 big-endian bytes)``, ``state`` the bytes of
  ``get_state()`` before the round (:func:`reseeded_generator`). The
  draws differ from the JAX package's; tests replay this function.
* **The generator after a skip.** JAX folds the round into every plan
  key (``fold_in(server.rng, server.round)``), so a skipped round's
  successor draws afresh from the same key. The port's round index does
  not enter its draws: only the generator's state does. So a skip moves
  the generator on as a commit of the round's first attempt would have:
  to the state that attempt's plan draw left (kept in the snapshot).
  Restoring the pre-round state instead would make the next round draw
  the skipped round's cohort, rows and poison again, and one divergence
  caused by the plan would skip every round after it.
"""
from __future__ import annotations

import dataclasses
import hashlib
import math
import time
from typing import Callable, List, NamedTuple, Optional, Tuple

import torch

from fedtorch_tpu_torch import telemetry
from fedtorch_tpu_torch.config import FaultConfig
from fedtorch_tpu_torch.core.state import (
    RoundMetrics, ServerState, tree_map, tree_put, tree_take,
)
from fedtorch_tpu_torch.robustness.guards import all_rejected_scalars
from fedtorch_tpu_torch.robustness.host_recovery import HostSeamError
from fedtorch_tpu_torch.utils.diagnostics import check_finite, model_norms

#: the salt of the retry reseed (the JAX package's fold base)
RESEED_SALT = 0x5EED0000


def reseeded_generator(rng_state: torch.Tensor,
                       attempt: int) -> torch.Generator:
    """The generator of retry ``attempt`` (>= 1) of a round whose
    generator stood at ``rng_state`` before it: seeded from
    ``sha256(state bytes || (RESEED_SALT + attempt) big-endian)``."""
    digest = hashlib.sha256(
        rng_state.numpy().tobytes()
        + (RESEED_SALT + attempt).to_bytes(8, "big")).digest()
    return torch.Generator().manual_seed(
        int.from_bytes(digest[:8], "big") >> 1)


def _clone(tree):
    return tree_map(lambda x: x.detach().clone()
                    if isinstance(x, torch.Tensor) else x, tree)


class _Snapshot(NamedTuple):
    """What a rollback restores: the server with cloned tensors and its
    generator's state, the [C] epoch and local_index, and per attempt
    the dispatched ids and the clone of their rows; and the generator
    state the first attempt's plan draw leaves (where a skip puts it)."""
    server: ServerState
    rng_state: torch.Tensor
    epoch: torch.Tensor
    local_index: torch.Tensor
    rows: List[Tuple[torch.Tensor, dict]]
    skip_rng_state: Optional[torch.Tensor]


@dataclasses.dataclass
class SupervisorStats:
    """Host-side counters; read them after (or during) training."""
    rounds: int = 0
    healthy_rounds: int = 0
    retries: int = 0
    rollbacks: int = 0
    skipped_rounds: int = 0
    # skipped_rounds split by cause: "fault" = divergence / raising
    # round; "quorum" = sub-quorum cohort under avail_quorum_action=
    # 'abort'
    skipped_fault: int = 0
    skipped_quorum: int = 0
    disk_restores: int = 0
    # rounds where the guards rejected EVERY surviving update
    all_rejected_rounds: int = 0
    # host seam failures that escaped their own recovery and reached
    # the supervisor, by seam name (HostSeamError carries it)
    host_seam_failures: dict = dataclasses.field(default_factory=dict)
    last_good_round: int = -1
    loss_ema: Optional[float] = None


class RoundSupervisor:
    """Fault-tolerant wrapper around ``trainer.run_round``:
    ``run_round(server, clients) -> (server, clients, metrics)``.
    ``sleep_fn`` is injectable for tests."""

    # healthy-loss EMA smoothing for the blow-up detector
    EMA_ALPHA = 0.1
    RESEED_SALT = RESEED_SALT

    def __init__(self, trainer, fault: Optional[FaultConfig] = None,
                 checkpoint_dir: Optional[str] = None,
                 logger=None, sleep_fn: Callable[[float], None] = time.sleep):
        self.trainer = trainer
        self.fault = fault if fault is not None else trainer.cfg.fault
        self.checkpoint_dir = checkpoint_dir
        self.logger = logger
        self.sleep_fn = sleep_fn
        self.stats = SupervisorStats()
        # host scalars of the round that just passed the health check,
        # for the driver loop to log without a second fetch; None after
        # a skipped round
        self.last_scalars = None

    # -- health ---------------------------------------------------------
    def _round_health(self, server, clients, metrics: RoundMetrics) -> dict:
        """ONE batched device->host fetch of everything the health check
        reads: the trainer's log scalars with the finite flag riding
        along. Kept on ``self.last_scalars`` for the loop's row."""
        h = self.trainer.round_host_scalars(
            clients, metrics,
            extra={"finite": model_norms(server.params)["all_finite"]})
        self.last_scalars = h
        n = h["n_online"]
        return {"finite": bool(h["finite"]), "n": n,
                "loss": h["loss_sum"] / max(n, 1.0),
                "round": int(server.round)}

    def _healthy(self, health: dict) -> bool:
        if not health["finite"]:
            return False
        f = self.fault.loss_blowup_factor
        if f > 0.0 and health["n"] > 0:
            loss = health["loss"]
            if not math.isfinite(loss):
                return False
            ema = self.stats.loss_ema
            if ema is not None and loss > f * ema:
                return False
        return True

    def _quorum_abort(self) -> bool:
        """True when the round just checked reported a sub-quorum cohort
        and the config escalates that here."""
        flt = self.fault
        if getattr(flt, "avail_quorum_action", "degrade") != "abort" \
                or getattr(flt, "avail_quorum_frac", 0.0) <= 0.0:
            return False
        s = self.last_scalars or {}
        return s.get("quorum_degraded", 0.0) > 0.0

    def _note_healthy(self, health: dict) -> None:
        st = self.stats
        st.healthy_rounds += 1
        st.last_good_round = health["round"] - 1
        loss = health["loss"]
        # a zero-participation round carries no loss observation
        if health["n"] > 0 and math.isfinite(loss):
            st.loss_ema = loss if st.loss_ema is None else (
                (1 - self.EMA_ALPHA) * st.loss_ema + self.EMA_ALPHA * loss)

    def _log(self, msg: str) -> None:
        if self.logger is not None:
            self.logger.log(msg)

    # -- the snapshot ---------------------------------------------------
    def _dispatched(self, server) -> Tuple[torch.Tensor, torch.Tensor]:
        """The ids the round on ``server`` dispatches and the generator
        state its plan draw leaves, drawn on a clone of its generator
        (the live one does not move)."""
        t = self.trainer
        gen = torch.Generator()
        gen.set_state(server.rng.get_state())
        plan = t.plan_drawer()(gen, server.round, t._alg_aux(server.aux))
        return plan.idx.to(torch.int64).to(t.device), gen.get_state()

    def _save_rows(self, snap: _Snapshot, server, clients) -> torch.Tensor:
        """Add the rows the attempt on ``server`` will write; returns the
        generator state the attempt's plan draw leaves."""
        idx, after = self._dispatched(server)
        snap.rows.append((idx, {
            "params": tree_take(clients.params, idx),
            "opt": tree_take(clients.opt, idx),
            "aux": tree_take(clients.aux, idx)}))
        return after

    def _snapshot(self, server, clients) -> _Snapshot:
        snap = _Snapshot(
            server=server._replace(params=_clone(server.params),
                                   opt=_clone(server.opt),
                                   aux=_clone(server.aux)),
            rng_state=server.rng.get_state(),
            epoch=clients.epoch.clone(),
            local_index=clients.local_index.clone(), rows=[],
            skip_rng_state=None)
        return snap._replace(
            skip_rng_state=self._save_rows(snap, server, clients))

    def _restore(self, snap: _Snapshot, server, clients):
        """Write the snapshot back: every saved row in place, the [C]
        counters, and a server of fresh copies (the snapshot itself is
        never handed to a round) with the generator at its pre-round
        state. Falls back to the on-disk checkpoint if the snapshot is
        sick — only possible when the caller handed in diverged state."""
        with torch.no_grad():
            for idx, rows in snap.rows:
                for name in ("params", "opt", "aux"):
                    tree_put(getattr(clients, name), idx, rows[name])
            clients.epoch.copy_(snap.epoch)
            clients.local_index.copy_(snap.local_index)
        gen = torch.Generator()
        gen.set_state(snap.rng_state)
        restored = snap.server._replace(
            params=_clone(snap.server.params), opt=_clone(snap.server.opt),
            aux=_clone(snap.server.aux), rng=gen)
        if check_finite(restored.params) or self.checkpoint_dir is None:
            return restored, clients
        from fedtorch_tpu_torch.utils.checkpoint import maybe_resume
        try:
            s, c, _, resumed = maybe_resume(
                self.checkpoint_dir, restored, clients, self.trainer.cfg)
        except FileNotFoundError:
            resumed = False
        if resumed:
            self.stats.disk_restores += 1
            self._log("supervisor: in-memory snapshot non-finite; "
                      "restored last on-disk checkpoint "
                      f"(round {s.round})")
            return s, c
        return restored, clients

    def _skip_metrics(self) -> RoundMetrics:
        # per-client metrics match the round's shapes: [C] or the sparse
        # mode's cohort-aligned [k']
        dev = self.trainer.device
        z = torch.zeros(self.trainer.metrics_width, device=dev)
        s = torch.zeros((), device=dev)
        return RoundMetrics(
            train_loss=z, train_acc=z.clone(), online_mask=z.clone(),
            comm_bytes=s, dropped_clients=s, straggler_clients=s,
            rejected_updates=s, clipped_updates=s, staleness_mean=s,
            byzantine_clients=s, robust_selected=s, robust_trimmed=s,
            avail_dropped=s, deadline_missed=s, quorum_degraded=s)

    # -- the supervised round -------------------------------------------
    def run_round(self, server, clients):
        flt = self.fault
        self.stats.rounds += 1
        snap = self._snapshot(server, clients)
        round_idx = int(server.round)
        disk_restores = self.stats.disk_restores
        last_exc: Optional[Exception] = None
        # the last exception that is not a host seam's: it re-raises
        broken: Optional[Exception] = None
        produced_state = False
        cause = "fault"

        for attempt in range(flt.max_retries + 1):
            try:
                out_s, out_c, metrics = self.trainer.run_round(
                    server, clients)
                produced_state = True
                health = self._round_health(out_s, out_c, metrics)
                healthy = self._healthy(health)
                if healthy and self._quorum_abort():
                    cause = "quorum"
                    self.last_scalars = None
                    why = ("reporting cohort below quorum "
                           "(avail_quorum_action='abort')")
                elif healthy:
                    self._note_healthy(health)
                    sc = self.last_scalars
                    if (flt.guard_updates or flt.chaos_enabled) \
                            and all_rejected_scalars(sc):
                        self.stats.all_rejected_rounds += 1
                        telemetry.event("guards.all_rejected",
                                        round=round_idx,
                                        n_online=sc["n_online"],
                                        rejected=sc["rejected"],
                                        dropped=sc["dropped"])
                        self._log(f"supervisor: round {round_idx} "
                                  "rejected every update — server held "
                                  "(renorm scale 0)")
                    return out_s, out_c, metrics
                else:
                    cause = "fault"
                    self.last_scalars = None
                    why = "non-finite server params or loss blow-up"
            except Exception as e:
                last_exc = e
                cause = "fault"
                why = f"round program raised: {e!r}"
                if isinstance(e, HostSeamError):
                    seam = e.seam
                    n = self.stats.host_seam_failures.get(seam, 0) + 1
                    self.stats.host_seam_failures[seam] = n
                    telemetry.event("supervisor.host_fault",
                                    round=round_idx, seam=seam,
                                    failures=n)
                else:
                    broken = e

            self.stats.rollbacks += 1
            telemetry.event("supervisor.rollback", round=round_idx,
                            attempt=attempt + 1, why=why)
            server, clients = self._restore(snap, server, clients)
            # the stream plane's producer drew ahead from the generator
            # the rollback (and the reseed below) rewrites
            getattr(self.trainer, "invalidate_stream", lambda: None)()
            self._log(f"supervisor: round {round_idx} attempt "
                      f"{attempt + 1}/{flt.max_retries + 1} diverged "
                      f"({why}); rolled back")
            if attempt < flt.max_retries:
                self.stats.retries += 1
                self.sleep_fn(flt.backoff_base_s * (2.0 ** attempt))
                if flt.reseed_on_retry:
                    server = server._replace(rng=reseeded_generator(
                        snap.rng_state, attempt + 1))
                self._save_rows(snap, server, clients)

        if broken is not None or not produced_state:
            # an attempt raised outside a host seam, or every attempt
            # raised: a broken program, not divergence
            raise broken if broken is not None else last_exc

        # degrade: keep the healthy rolled-back state, skip the round
        self.stats.skipped_rounds += 1
        if cause == "quorum":
            self.stats.skipped_quorum += 1
        else:
            self.stats.skipped_fault += 1
        telemetry.event("supervisor.round_skipped", round=round_idx,
                        attempts=flt.max_retries + 1, cause=cause)
        server = server._replace(round=server.round + 1)
        if self.stats.disk_restores == disk_restores:
            # the generator moves on as the first attempt's commit would
            # have moved it (module docstring; a state read from disk
            # keeps its own); the stream plane's producer was dropped by
            # the rollback and restarts from it
            gen = torch.Generator()
            gen.set_state(snap.skip_rng_state)
            server = server._replace(rng=gen)
        self._log(f"supervisor: round {round_idx} skipped after "
                  f"{flt.max_retries + 1} attempts (cause={cause}); "
                  "state rolled back")
        return server, clients, self._skip_metrics()
