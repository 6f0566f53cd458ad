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
  module; the port has no batched client axis yet) or ``'fused'``
  (grouped convolutions).

:func:`validate_cell` is the one place a cell is refused: with the JAX
package's reason where the JAX package refuses it, and as not yet
ported for the commit dispatch (ROADMAP A8) and the fused execution
(ROADMAP A9). The port has no pod-scale client shards (ROADMAP A10)
and no ``gather_mode``, so those rules of the JAX validator have no
counterpart here.

On the port a "scan" is a host loop over the R rounds (over one feed
window on the feed source), not a captured graph: the per-client loop
syncs with the host.
"""
from __future__ import annotations

import torch

from fedtorch_tpu_torch.algorithms.base import FedAlgorithm
from fedtorch_tpu_torch.core.state import RoundMetrics

SOURCES = ("resident", "feed")
DISPATCHES = ("round", "scan", "commit")
EXECUTIONS = ("vmap", "fused")

# algorithms the JAX package wires for stale-snapshot commits
ASYNC_ALGORITHMS = ("fedavg", "fedprox", "fedadam", "scaffold")

NOT_PORTED = {
    "commit": ("the commit dispatch (sync_mode='async', the async plane) "
               "is not yet ported (ROADMAP A8)"),
    "fused": "client_fusion='fused' is not yet ported (ROADMAP A9)",
}


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


def illegal_reason(source: str, dispatch: str, execution: str, *, cfg,
                   algorithm: FedAlgorithm, has_val: bool = False):
    """Why the port cannot serve a cell, or None."""
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

    # -- what the port has not ported ------------------------------------
    if dispatch == "commit":
        return NOT_PORTED["commit"]
    if execution == "fused":
        return NOT_PORTED["fused"]
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
    ======== ========== =========================================
    """

    def __init__(self, trainer):
        self._t = trainer

    @property
    def source(self) -> str:
        return "feed" if self._t.data_plane == "stream" else "resident"

    @property
    def execution(self) -> str:
        return "fused" if self._t.cfg.mesh.client_fusion == "fused" \
            else "vmap"

    def validate(self, dispatch: str) -> None:
        t = self._t
        validate_cell(self.source, dispatch, self.execution, cfg=t.cfg,
                      algorithm=t.algorithm, has_val=t.has_val)

    def build(self, dispatch: str, *, scan_length: int = 1):
        """Validate the cell, then return its function."""
        self.validate(dispatch)
        if dispatch == "round":
            return self._t.round_fn if self.source == "resident" \
                else self._t.round_stream_fn
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
