"""The round-program builder (port of
``fedtorch_tpu/parallel/round_program.py``): which (data source,
dispatch, client execution) cells a trainer may serve, and the
function that serves each.

* **source**: ``'resident'`` (the population on the device, gathered in
  the round) or ``'feed'`` (the population on the host, each round a
  packed feed; ``data/streaming.py``);
* **dispatch**: ``'round'`` (one call a round), ``'scan'`` (R rounds a
  call) or ``'commit'`` (the async plane's buffered commit);
* **execution**: ``'vmap'`` (the clients one after another on one
  module) or ``'fused'`` (all k clients' forward and backward as one
  grouped convolution a layer; ``parallel/fusion.py``).

:func:`validate_cell` is the one place a cell is refused, with the JAX
package's reason where the JAX package refuses it. Its client-shard
rules (``mesh.client_shards`` S > 1, ``parallel/podscale.py``) are the
JAX package's word for word, but one: the port has no ``gather_mode``
(its one gather selects the rows of the JAX 'batch' mode), so the JAX
rule against ``gather_mode='shard'`` has nothing to refuse. One more is
the port's own: the 'collude' byzantine attack under S > 1 (its crafted
update is the honest mean over the whole cohort, taken before the wire
format, a cross-rank reduction the seam does not make; ROADMAP A10).
``client_shards`` 0 on several ranks (the JAX package's 1-D mesh, where
GSPMD places every cross-client sum) is served: each rank runs its
``ceil(k/W)`` rows of the cohort and one gather brings every rank the
whole cohort before the rest of the round (``parallel/podscale.py``
``gather_cohort``), so every algorithm, robust rule, ``cohort_stats``
and byzantine mode runs there, and so does local-SGD mode; on several
ranks at S = 1 the exchange also brings the rows the population readers
take (``pre_round``'s batches, qFFL's shards, DRFA's probe batches).
The personal evaluation (``parallel/evaluate.py`` ``evaluate_personal``,
which reads every client's models) is refused on several ranks where it
runs (ROADMAP A10).

On the port a "scan" is a host loop over the R rounds (over one feed
window on the feed source), not a captured graph: the per-client loop
syncs with the host. The commit is the JAX package's ``_commit_core``:
each buffered job's server snapshot taken from the snapshot ring (views
of its slot, no copy), the staleness weights, the round core through its
commit seam, then the ring rotated out of place with the new version.
Where the JAX package keys each job's training stream by its dispatch id
(``ASYNC_TRAIN_SALT``), the port draws each commit's rows, augmentation
and fault draws from the server's generator, one commit after another,
as its sync rounds draw theirs; so it has no ``ASYNC_TRAIN_SALT``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from fedtorch_tpu_torch.algorithms.base import FedAlgorithm
from fedtorch_tpu_torch.core.state import RoundMetrics, tree_map, tree_take
from fedtorch_tpu_torch.parallel.fusion import fusion_supported

SOURCES = ("resident", "feed")
DISPATCHES = ("round", "scan", "commit")
EXECUTIONS = ("vmap", "fused")

# algorithms the JAX package wires for stale-snapshot commits
ASYNC_ALGORITHMS = ("fedavg", "fedprox", "fedadam", "scaffold")


class CommitJobs(NamedTuple):
    """One commit's buffered updates (all [m], CPU tensors)."""
    idx: torch.Tensor        # int64 client ids (distinct)
    version: torch.Tensor    # int64 snapshot version each trained on
    dispatch: torch.Tensor   # int64 global dispatch counter
    straggler: torch.Tensor  # float32 {0,1} tail-delay dispatches


def cell_name(source: str, dispatch: str, execution: str) -> str:
    return f"({source} x {dispatch} x {execution})"


def iter_cells():
    """Every (source, dispatch, execution) combination."""
    for source in SOURCES:
        for dispatch in DISPATCHES:
            for execution in EXECUTIONS:
                yield source, dispatch, execution


def _check_axes(source, dispatch, execution):
    if source not in SOURCES or dispatch not in DISPATCHES \
            or execution not in EXECUTIONS:
        raise ValueError(
            f"unknown round-program cell "
            f"{cell_name(source, dispatch, execution)} — axes are "
            f"source={SOURCES}, dispatch={DISPATCHES}, "
            f"execution={EXECUTIONS}")


def cell_build_facts(source: str, dispatch: str, execution: str, *,
                     client_shards: int = 0) -> dict:
    """The config values a trainer serving this cell is built with."""
    _check_axes(source, dispatch, execution)
    return {
        "data_plane": "stream" if source == "feed" else "device",
        "sync_mode": "async" if dispatch == "commit" else "sync",
        "client_fusion": execution,
        "client_shards": client_shards,
    }


def collective_budget(source: str, dispatch: str, execution: str, *,
                      mesh_devices: int, num_rounds: int = 1,
                      client_shards: int = 0) -> int:
    """The JAX package's budget of collectives for the cell's program:
    one a round (the aggregation seam's), ``num_rounds`` for a scan
    across devices, none on one device. Under ``client_shards > 1`` it
    is 1 and exact, read a round: the client-shard seam issues exactly
    one ``all_gather`` each round (``parallel/podscale.py``; the JAX
    package counts the scan body's one gather once), and a sharded round
    with none dropped the cross-shard reduction. The port counts what it
    issues in ``podscale.collective_count()``."""
    _check_axes(source, dispatch, execution)
    if client_shards > 1:
        return 1
    if mesh_devices <= 1:
        return 0
    return num_rounds if dispatch == "scan" else 1


def illegal_reason(source: str, dispatch: str, execution: str, *, cfg,
                   algorithm: FedAlgorithm, model, mesh_devices: int,
                   k_online: int, has_val: bool = False,
                   fused_resolved: bool = False):
    """Why the port cannot serve a cell, or None. ``model`` (the
    per-client ModelDef), ``mesh_devices`` and ``k_online`` (the
    dispatch width) are the fused execution's facts;
    ``fused_resolved=True`` skips its precondition check, which a
    trainer whose ``resolve_client_fusion`` resolved 'fused' has
    passed with the same reasons."""
    _check_axes(source, dispatch, execution)

    # -- dispatch axis: the JAX package's rules --------------------------
    if dispatch == "scan" and cfg.federated.sync_mode == "async":
        return ("run_rounds scans ONE traced round program over R "
                "rounds' inputs, but async commits are host-scheduled "
                "events (each commit's jobs come from the event "
                "scheduler), so no R-commit program exists to scan — "
                "call run_round once per commit, or use "
                "--sync_mode sync for the scan dispatch")
    if dispatch == "commit":
        alg_name = cfg.effective_algorithm
        if alg_name not in ASYNC_ALGORITHMS:
            return ("sync_mode='async' is unsupported for algorithm "
                    f"{alg_name!r}: it is not wired for stale-snapshot "
                    f"commits (supported: {', '.join(ASYNC_ALGORITHMS)};"
                    " AFL/qFFL aggregate cohort-global losses, DRFA "
                    "adds a dual phase and lambda participation, the "
                    "personalized families need per-client val "
                    "streams, and qsparse's tracking variate assumes "
                    "the round's payload sum)")
        if has_val or algorithm.needs_val_batch or cfg.federated.personal:
            return ("per-client validation splits "
                    "(cfg.federated.personal) are not buffered — "
                    "sync_mode='async' commits carry no val stream")
        if execution == "fused":
            return ("client_fusion='fused' packs clients into one "
                    "grouped conv against ONE shared server snapshot; "
                    "buffered commits train each client against its "
                    "own dispatch-time version — use the vmap "
                    "execution or --sync_mode sync")

    # -- source axis: the JAX package's rules ----------------------------
    if source == "feed":
        if not algorithm.participation_replayable:
            return (f"{algorithm.name} samples participation from "
                    "server state the host feed builder cannot see "
                    "(DRFA's lambda-distributed draw) — the schedule "
                    "replay cannot know the cohort before the round")
        if (type(algorithm).post_round_global
                is not FedAlgorithm.post_round_global
                and not algorithm.needs_post_probe):
            return (f"{algorithm.name} overrides post_round_global "
                    "with full-data logic and declares no host probe "
                    "plan (host_probe_fn/post_round_global_feed) the "
                    "feed builder could pack")
        if algorithm.needs_val_batch or has_val:
            return ("per-client validation splits "
                    "(cfg.federated.personal) are not streamed yet")

    # -- client-shard fact: the JAX package's rules ---------------------
    shards = int(cfg.mesh.client_shards or 0)
    if shards > 1:
        if execution == "fused":
            return ("client_fusion='fused' packs all k clients into "
                    "one grouped conv on one device, while "
                    f"mesh.client_shards={shards} splits the cohort "
                    "across device groups — fused x multi-shard stays "
                    "refused until a sharded grouped-conv lowering is "
                    "measured (use the vmap execution, which shards "
                    "the client axis)")
        if k_online % shards:
            return (f"mesh.client_shards={shards} does not divide the "
                    f"dispatch cohort width k={k_online} — contiguous "
                    "k/shards client blocks are the unit of the "
                    "bitwise hierarchical sum, so the cohort must "
                    "split evenly (adjust online_client_rate or the "
                    "shard count)")
        if cfg.fault.robust_agg != "mean":
            return (f"robust_agg={cfg.fault.robust_agg!r} reduces "
                    "across the FULL cohort axis (median/trim "
                    "selection and norm-bound renormalization are "
                    "cross-client order-sensitive floats) — only the "
                    "hierarchical 'mean' seam is certified bitwise "
                    "under client sharding")
        if cfg.telemetry.cohort_stats:
            return ("telemetry.cohort_stats computes cross-cohort "
                    "dispersion (cosine-to-mean reductions) whose "
                    "float association is not shard-invariant — "
                    "disable cohort_stats under "
                    "mesh.client_shards > 1")
        alg_name = cfg.effective_algorithm
        if alg_name not in ASYNC_ALGORITHMS:
            return (f"algorithm {alg_name!r} is not certified for the "
                    "sharded aggregation seam: only the FedAvg family "
                    f"({', '.join(ASYNC_ALGORITHMS)}) confines its "
                    "cross-client float reductions to the one "
                    "hierarchical weighted sum (AFL/qFFL aggregate "
                    "cohort-global losses, DRFA adds a dual phase, "
                    "and qsparse's tracking variate assumes the "
                    "round's full payload sum)")
        if has_val or algorithm.needs_val_batch \
                or cfg.federated.personal:
            return ("per-client validation splits "
                    "(cfg.federated.personal) reduce across the full "
                    "cohort outside the sharded seam — disable them "
                    "under mesh.client_shards > 1")
        # (the JAX rule against gather_mode='shard' has no counterpart:
        # the port has one gather, the JAX 'batch' mode's rows)
        if dispatch == "commit":
            conc = cfg.federated.async_concurrency or k_online
            m = cfg.federated.async_buffer_size or max(1, conc // 2)
            if m % shards:
                return ("the async commit buffer width m="
                        f"{m} does not divide over "
                        f"mesh.client_shards={shards} — each shard "
                        "must own whole buffered jobs for the commit "
                        "program's hierarchical sum (set "
                        "async_buffer_size to a multiple of the "
                        "shard count)")
        # the port's own rule (module docstring)
        if cfg.fault.byzantine_rate > 0.0 \
                and cfg.fault.byzantine_mode == "collude":
            return ("byzantine_mode='collude' crafts the honest mean "
                    "update over the whole cohort before the wire "
                    "format, a cross-rank reduction the client-shard "
                    "seam does not make — use another byzantine_mode "
                    f"under mesh.client_shards={shards} (ROADMAP A10)")
    # -- execution axis: the JAX package's rules -------------------------
    if execution == "fused" and mesh_devices > 1:
        return ("mesh.client_fusion='fused' is unsupported: mesh has "
                f"{mesh_devices} devices — the packed client/channel "
                "axis must not be sharded (use the vmap path's "
                "client-axis sharding)")
    if execution == "fused" and dispatch != "commit" \
            and not fused_resolved:
        fused, why = fusion_supported(cfg, model, algorithm,
                                      mesh_devices, k_online)
        if fused is None:
            return f"mesh.client_fusion='fused' is unsupported: {why}"
    return None


def validate_cell(source: str, dispatch: str, execution: str, **facts
                  ) -> None:
    """Raise the cell's one ValueError when it is illegal."""
    reason = illegal_reason(source, dispatch, execution, **facts)
    if reason is not None:
        raise ValueError(
            "round-program cell "
            f"{cell_name(source, dispatch, execution)} is unsupported "
            f"here: {reason}")


def feed_layout(algorithm: FedAlgorithm) -> str:
    """The stream plane's feed layout (the JAX package's
    ``resolve_gather_mode`` on the feed source): whole shards for an
    algorithm that reads each client's full data (qFFL), else the
    round's rows."""
    return "shard" if algorithm.needs_full_loss else "batch"


def stack_metrics(history) -> RoundMetrics:
    """Per-round metrics stacked on a leading [R] axis (a field that is
    None in every round, the DP gauges with DP off, stays None)."""
    return RoundMetrics(*(None if f[0] is None else torch.stack(f)
                          for f in zip(*history)))


class RoundProgramBuilder:
    """Builds a trainer's round functions, the source and execution axes
    read off the trainer:

    ======== ========== =========================================
    source   dispatch   function
    ======== ========== =========================================
    resident round      ``trainer.round_fn(server, clients)``
    feed     round      ``trainer.round_stream_fn(server, clients,
                        feed)``
    resident scan-of-R  ``fn(server, clients)``: R ``round_fn`` calls
    feed     scan-of-R  ``fn(server, clients)``: one feed window, R
                        ``round_stream_fn`` calls
    resident commit     ``fn(server, clients, plan)``: the commit on
                        the plan's rows gathered on the device
    feed     commit     ``fn(server, clients, feed)``: the commit on
                        a commit-keyed feed
    ======== ========== =========================================
    """

    def __init__(self, trainer):
        self._t = trainer

    @property
    def source(self) -> str:
        return "feed" if self._t.data_plane == "stream" else "resident"

    @property
    def execution(self) -> str:
        return self._t.client_fusion

    def validate(self, dispatch: str) -> None:
        t = self._t
        validate_cell(self.source, dispatch, self.execution, cfg=t.cfg,
                      algorithm=t.algorithm, model=t.model,
                      mesh_devices=t.mesh_devices,
                      k_online=t.k_dispatch, has_val=t.has_val,
                      fused_resolved=t.fused_module is not None)

    def build(self, dispatch: str, *, scan_length: int = 1):
        """Validate the cell, then return its function."""
        self.validate(dispatch)
        if dispatch == "round":
            return self._t.round_fn if self.source == "resident" \
                else self._t.round_stream_fn
        if dispatch == "commit":
            return self._commit_program()
        return self._scan_program(scan_length)

    def _scan_program(self, num_rounds: int):
        t = self._t
        if self.source == "resident":
            def rounds_fn(server, clients):
                history = []
                for _ in range(num_rounds):
                    server, clients, metrics = t.round_fn(server, clients)
                    history.append(metrics)
                return server, clients, stack_metrics(history)
        else:
            def rounds_fn(server, clients):
                window = t._pop_stream_with_rebuild(
                    lambda: t.next_stream_item(server, window=num_rounds))
                history = []
                for r in range(num_rounds):
                    server, clients, metrics = t.consume_stream_round(
                        server, clients, window, r)
                    history.append(metrics)
                return server, clients, stack_metrics(history)
        return rounds_fn

    # -- commit dispatch --------------------------------------------------
    def _commit_program(self):
        """The async plane's buffered commit: each job's rows gathered
        (on the device, or from the commit-keyed feed), then the round
        core once through its commit seam."""
        t = self._t
        if self.source == "resident":
            def commit_fn(server, clients, plan):
                x, y, pre_x, pre_y, shards = t.gather_resident(plan)
                return self._commit_core(server, clients, plan, x, y,
                                         pre_x, pre_y, shards)
        else:
            def commit_fn(server, clients, feed):
                plan = t.feed_plan(feed)
                x, y, shards = t.gather_feed(feed, plan)
                return self._commit_core(server, clients, plan, x, y,
                                         feed.pre_x, feed.pre_y, shards)
        return commit_fn

    def _commit_core(self, server, clients, plan, x, y, pre_x, pre_y,
                     shards):
        """Unwrap the snapshot ring, take each job's snapshot, run the
        round core through its commit seam, rotate the ring."""
        # lazy: the async plane's package imports parallel.federated,
        # which imports this module
        from fedtorch_tpu_torch.async_plane.staleness import (
            normalized_staleness_weights,
        )
        t = self._t
        fed = t.cfg.federated
        jobs = plan.jobs
        ring = server.aux["ring"]
        inner = server._replace(aux=server.aux["alg"])
        R = t.snapshot_ring
        slots = (jobs.version % R).tolist()
        base_params = [tree_take(ring["params"], s) for s in slots]
        base_aux = [tree_take(ring["aux"], s) for s in slots]
        stale = (server.round - jobs.version).to(torch.float32)
        weight_scale = normalized_staleness_weights(
            stale, fed.staleness_weight, fed.staleness_exponent)
        new_inner, clients, metrics = t._round_core(
            inner, clients, plan, x, y, pre_x, pre_y, shards,
            base_params=base_params, base_aux=base_aux,
            weight_scale=weight_scale)
        # the new version overwrites the ring's oldest slot, out of place
        # (a snapshot of the previous server keeps its ring)
        slot = torch.tensor([new_inner.round % R])

        def rotate(r, v):
            if not isinstance(r, torch.Tensor):
                return r
            return r.index_copy(0, slot.to(r.device), v[None].to(r.device))
        new_ring = {"params": tree_map(rotate, ring["params"],
                                       new_inner.params),
                    "aux": tree_map(rotate, ring["aux"], new_inner.aux)}
        new_server = new_inner._replace(
            aux={"alg": new_inner.aux, "ring": new_ring})
        dev = t.device
        metrics = metrics._replace(
            straggler_clients=jobs.straggler.sum().to(dev),
            staleness_mean=stale.mean().to(dev))
        if metrics.cohort_staleness is not None:
            # each job's commit staleness in place of the sync zeros
            metrics = metrics._replace(cohort_staleness=stale.to(dev))
        return new_server, clients, metrics
