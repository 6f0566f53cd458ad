"""Telemetry record schemas (port of ``fedtorch_tpu/telemetry/schema.py``,
a copy: docs/observability.md "Metric catalog").

The port writes the JAX package's schema names (``fedtorch_tpu.metrics/v1``,
``events/v1``, ``health/v1``) and its catalog's field names unchanged, so
the JAX package's readers (``fedtorch-tpu report``, ``compare``,
``watch``) take a port run directory as they take their own. The device
gauges keep their names with the port's meanings (the catalog's texts).
:data:`EVENT_NAMES` is the port's own list of the events it emits
(held to the emit sites by ``fedtorch_tpu_torch.lint.registry_audit``,
FTC002).

Everything the run emits machine-readably is versioned here: the
``metrics.jsonl`` per-round row, the ``events.jsonl`` event record, and
the ``health.json`` liveness document. Consumers (the ``fedtorch-tpu
report`` tool, external monitors, tests) key on ``SCHEMA`` /
``HEALTH_SCHEMA`` strings instead of sniffing shapes, so a future
breaking change bumps the version and old parsers fail loudly.

Stdlib-only on purpose: the report tool and external monitors must be
able to parse a run dir without initializing a backend.
"""
from __future__ import annotations

import json
from typing import Dict, Iterator, List, Optional, Tuple

# bump ONLY on breaking changes (renamed/retyped required fields);
# adding optional fields is backward-compatible and needs no bump
METRICS_SCHEMA = "fedtorch_tpu.metrics/v1"
EVENTS_SCHEMA = "fedtorch_tpu.events/v1"
HEALTH_SCHEMA = "fedtorch_tpu.health/v1"

# -- the per-round metrics row ------------------------------------------
# Required fields every row carries. All values are host-side Python
# scalars: the row is populated exclusively from the round loop's ONE
# batched scalar fetch (FederatedTrainer.round_host_scalars) plus
# host-only counters — emitting a row costs zero device syncs.
METRICS_REQUIRED = {
    "round": int,        # round index (async: commit version)
    "round_s": float,    # wall-clock of the jitted round/commit call
    "loss": float,       # mean online train loss
    "acc": float,        # mean online train top-1
    "lr": float,         # schedule LR at the round's mean epoch
    "n_online": float,   # online clients this round
    "comm_bytes": float,  # uplink payload volume
}

# Optional gauge groups (absent when the subsystem is off). Names are
# the catalog rendered in docs/observability.md.
METRICS_OPTIONAL = {
    # row stamps (telemetry/metrics.py JsonlWriter — every row since
    # the ops plane; optional so pre-ops run dirs stay valid): `seq`
    # restarts at 0 per writer, so a mid-file seq drop marks an
    # elastic-restart boundary and `t` orders rows across it —
    # cross-restart stitching in compare/watch is unambiguous
    "seq": "monotonic per-writer row sequence (resets on restart)",
    "t": "wall-clock emit time (unix seconds)",
    # robustness counters (chaos/guards; 0-valued when enabled but calm)
    "dropped": "chaos-crashed clients masked out of aggregation",
    "stragglers": "step-budget cuts (async: delayed dispatches)",
    "rejected": "guard-rejected updates",
    "clipped": "guard-norm-clipped updates",
    # byzantine adversary + robust aggregation (robustness/chaos.py,
    # robustness/aggregators.py)
    "byzantine": "adversary-crafted uploads injected this round",
    "robust_selected": "updates the robust aggregation rule kept",
    "robust_trimmed": "updates the robust rule excluded/clipped "
                      "beyond the guards",
    "staleness": "mean snapshot staleness this commit (async plane)",
    # deployment-realism availability lifecycle
    # (robustness/availability.py; docs/robustness.md "Deployment
    # realism")
    "avail_dropped": "mid-round client dropouts (sync lifecycle)",
    "deadline_missed": "late survivors masked after the round closed "
                       "on its first k arrivals (over-selection)",
    "quorum_degraded": "1 when the accepted cohort fell below the "
                       "configured quorum this round",
    "mean_epoch": "mean training epoch over real clients",
    # per-round host phase wall-clock (seconds)
    "fetch_s": "batched scalar-fetch wall (blocks on the round)",
    "eval_s": "server eval wall (eval rounds only)",
    "checkpoint_s": "checkpoint snapshot+dispatch wall (eval rounds)",
    # eval results (eval rounds only; host floats from the eval fetch)
    "test_top1": "server-model test top-1 this eval",
    "best_top1": "best test top-1 so far",
    # stream plane (trainer.stream_stats)
    "stream_depth": "prefetched feeds ready at fetch time",
    "stream_wait_s": "consumer wall blocked on the feed queue (total)",
    "stream_gather_s": "producer schedule+pack wall (total)",
    "stream_h2d_s": "producer device_put dispatch wall (total)",
    "stream_produced": "feeds produced since (re)start",
    "stream_store_resident_mb": "client-store bytes held in host RAM "
                                "(mmap store: sizes vector only)",
    "stream_store_mapped_mb": "client-store bytes memory-mapped from "
                              "disk (0 for the RAM store)",
    # pod-scale client-axis sharding (parallel/podscale.py;
    # docs/performance.md "Pod-scale round programs") — present only
    # when mesh.client_shards arms the sharded seam
    "client_shards": "client-axis shard count S of the armed mesh "
                     "(the round's cohort is split S ways)",
    "cohort_allreduce_bytes": "static [G, P] partial-sum bytes the "
                              "seam's ONE cross-shard all-reduce "
                              "moves per round (stashed at trace "
                              "time)",
    "cohort_gather_bytes": "bytes of the whole buffer the seam's one "
                           "gather brings each rank per round: the "
                           "partials and the per-client rows that ride "
                           "with them (0 at client_shards 1; the port's "
                           "own gauge)",
    "stream_shard_rows": "cohort rows THIS host's producer packed "
                         "(its owned shard slices; k/S per shard)",
    "stream_shard_pack_s": "producer wall spent packing this host's "
                           "shard rows (per-host scaling gauge)",
    # round-wall critical path (telemetry/critical_path.py;
    # docs/observability.md "Operating and comparing runs")
    "overlap_efficiency": "fraction of this round's producer "
                          "gather+H2D wall hidden under device "
                          "compute (stream plane)",
    # async commit plane (trainer.schedule_stats + staleness histogram)
    "async_dispatches": "client dispatches simulated so far",
    "async_stragglers": "tail-delayed dispatches so far",
    "async_ring_clamped": "arrivals older than the snapshot ring",
    "async_buffer": "buffer size m (updates folded per commit)",
    "async_commit_rate": "commits per virtual time unit so far",
    "async_dropouts": "mid-round dropouts discarded at arrival and "
                      "re-dispatched (availability model)",
    # checkpoint IO (AsyncCheckpointer.stats)
    "ckpt_queue_depth": "writes queued behind the worker",
    "ckpt_writes": "checkpoints durably written so far",
    "ckpt_last_write_s": "serialization+disk wall of the last write",
    "ckpt_total_write_s": "cumulative write wall over the run",
    # checkpoint degraded mode (docs/robustness.md "Host plane")
    "ckpt_degraded": "1 once the async writer fell back to sync "
                     "writes after a lost background write",
    "ckpt_lost_writes": "background checkpoint writes durably lost "
                        "(each emitted a ckpt.degraded event)",
    # supervisor (host counters)
    "sup_rollbacks": "supervisor rollbacks so far",
    "sup_retries": "supervisor retries so far",
    "sup_skipped": "supervisor skipped rounds so far",
    "sup_skipped_fault": "skips caused by divergence or a raising "
                         "round program",
    "sup_skipped_quorum": "skips caused by sub-quorum rounds under "
                          "avail_quorum_action='abort'",
    # host-plane chaos + self-healing (robustness/host_chaos.py,
    # robustness/host_recovery.py; docs/robustness.md "Host plane")
    "host_faults": "injected host-seam faults fired so far (armed "
                   "drills only)",
    "host_retries": "host-seam recovery retries so far (all seams)",
    "host_recovered": "host operations that succeeded after >= 1 "
                      "retry",
    "host_degraded": "host seams currently in degraded mode",
    "stream_rebuilds": "stream feed producers rebuilt via the "
                       "invalidate_stream resync after a death",
    # device-side gauges (telemetry.costs.ProgramCostCapture; present
    # once program_costs.json was captured). The port's meanings: FLOPs
    # from torch.utils.flop_counter over one round on a twin (plus the
    # hand kernels' counts), peaks of the H100 by compute dtype, memory
    # from the CUDA caching allocator; on the CPU the memory pair is
    # absent (graceful None)
    "model_flops_utilization": "round FLOPs / (round wall x peak x "
                               "cards) — measured MFU fraction",
    "hbm_program_peak_bytes": "torch.cuda.max_memory_allocated over "
                              "round 0 — the round's measured device-"
                              "memory peak",
    "hbm_live_bytes": "torch.cuda.memory_allocated() at row time — "
                      "bytes the CUDA allocator holds for live tensors "
                      "(a host counter, no sync)",
    "round_device_min_s": "FLOPs-at-peak device-time floor of the "
                          "captured round (the analytic lower bound on "
                          "device-busy seconds)",
    "round_host_frac": "1 - round_device_min_s/round_s — the round-"
                       "wall share NOT explained by the device floor "
                       "(host dispatch, launch gaps, sub-peak kernels)",
    # federation-plane cohort statistics (telemetry.cohort_stats;
    # robustness/aggregators.py:cohort_statistics — docs/
    # observability.md "Federation plane")
    "cohort_dispersion": "1 - mean cosine of the accepted unit "
                         "updates vs their weighted mean (the "
                         "heterogeneity gauge)",
    "cohort_norm_min": "min accepted unit-update l2 norm",
    "cohort_norm_q25": "25th-percentile accepted unit-update norm",
    "cohort_norm_med": "median accepted unit-update norm",
    "cohort_norm_q75": "75th-percentile accepted unit-update norm",
    "cohort_norm_max": "max accepted unit-update norm",
    # privacy plane (robustness/privacy.py; docs/robustness.md
    # "Privacy plane") — present only when fault.dp_noise_multiplier
    # arms the DP aggregation stage
    "dp_clipped_frac": "fraction of accepted clients the DP L2 clip "
                       "actually shrank this round",
    "dp_noise_sigma": "applied DP noise stddev on the released "
                      "estimate (0 after a budget 'degrade')",
    "dp_epsilon_spent": "cumulative accounted epsilon at dp_delta "
                        "(host-side RDP accountant)",
    # per-client ledger (telemetry/ledger.py)
    "ledger_tracked": "clients with exact per-client ledger records "
                      "(dense: the population; sketch: the "
                      "suspicion top-K)",
    "ledger_bytes": "ledger host-memory footprint — bounded "
                    "O(min(C, ledger_sketch_budget))",
}

def all_metric_fields() -> frozenset:
    """Every cataloged metrics-row field name (required + optional) —
    the single catalog surface consumers key on. The registry-drift
    checker (``fedtorch_tpu_torch.lint.registry_audit``, FTC001) gates
    this set against the port's emit sites."""
    return frozenset(METRICS_REQUIRED) | frozenset(METRICS_OPTIONAL)


# every event name the port emits into events.jsonl (FTC002)
EVENT_NAMES = (
    "anomaly.detected", "anomaly.summary", "async.staleness_hist",
    "chaos.byzantine_attack", "chaos.host_fault", "ckpt.degraded",
    "cost.capture", "guards.all_rejected", "host.degraded",
    "host.recovered", "kernels.launches", "lifecycle.quorum_degraded",
    "preempt.drain", "privacy.budget_exhausted", "run.end", "run.start",
    "stream.producer_rebuilt", "supervisor.host_fault",
    "supervisor.rollback", "supervisor.round_skipped",
    "telemetry.degraded", "watchdog.fired",
)


HEALTH_INTENTS = (
    "starting",    # process up, loop not yet entered
    "running",     # making round progress
    "recovering",  # progressing, but a host seam retried this round
    "degraded",    # progressing with >= 1 host seam in degraded mode
    "drain",       # stop agreed; writing the final checkpoint
    "preempted",   # drained and exiting restartable (75)
    "stalled",     # watchdog fired; exiting restartable (75)
    "complete",    # ran to num_comms
    "error",       # round loop raised
)


def validate_metrics_row(row: Dict) -> None:
    """Raise ``ValueError`` when ``row`` violates the v1 contract —
    the schema half of the round-trip test."""
    for key, typ in METRICS_REQUIRED.items():
        if key not in row:
            raise ValueError(f"metrics row missing required {key!r}")
        v = row[key]
        if typ is float and isinstance(v, (int, float)) \
                and not isinstance(v, bool):
            continue
        if typ is int and isinstance(v, int) and not isinstance(v, bool):
            continue
        raise ValueError(
            f"metrics row field {key!r} must be {typ.__name__}, got "
            f"{type(v).__name__} ({v!r})")
    unknown = [k for k in row
               if k not in METRICS_REQUIRED and k not in METRICS_OPTIONAL]
    if unknown:
        raise ValueError(
            f"metrics row carries uncataloged fields {unknown!r} — add "
            "them to telemetry.schema.METRICS_OPTIONAL (the catalog is "
            "the contract docs/observability.md renders)")


def validate_health(doc: Dict) -> None:
    if doc.get("schema") != HEALTH_SCHEMA:
        raise ValueError(
            f"health schema {doc.get('schema')!r} != {HEALTH_SCHEMA!r}")
    for key in ("pid", "host", "round", "intent", "updated_unix",
                "progress_monotonic"):
        if key not in doc:
            raise ValueError(f"health.json missing required {key!r}")
    if doc["intent"] not in HEALTH_INTENTS:
        raise ValueError(f"unknown health intent {doc['intent']!r} "
                         f"(expected one of {HEALTH_INTENTS})")


def iter_jsonl(path: str, on_torn=None) -> Iterator[Dict]:
    """Yield one dict per line; the header line (``{"schema": ...}``)
    is included — callers filter on the ``"schema"`` key. A torn
    partial line (crash/preemption mid-append — normally the file's
    last line, but an elastic restart can bury one mid-file) is
    skipped, not fatal: every COMPLETE line was written atomically
    enough (single ``write`` of a line under append mode) to parse.
    ``on_torn(line)``, when given, is called once per skipped line so
    readers surface a COUNTED warning instead of silently dropping."""
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                yield json.loads(line)
            except json.JSONDecodeError:
                if on_torn is not None:
                    on_torn(line)
                continue


def load_jsonl(path: str) -> Tuple[Optional[Dict], List[Dict], int]:
    """``(header, records, torn_lines)`` — the whole-file form every
    offline reader (report / compare / runs registry / anomaly replay)
    shares, so torn-tail tolerance and its counted warning cannot be
    implemented five slightly-different ways. ``header`` is the first
    record carrying a ``schema`` key (None for headerless files);
    later ``schema`` records (an elastic restart appending a fresh
    header) are dropped from ``records`` too."""
    torn = [0]

    def _count(_line: str) -> None:
        torn[0] += 1

    header: Optional[Dict] = None
    records: List[Dict] = []
    for rec in iter_jsonl(path, on_torn=_count):
        if "schema" in rec:
            if header is None:
                header = rec
            continue
        records.append(rec)
    return header, records, torn[0]


def count_restarts(records: List[Dict]) -> int:
    """Elastic-restart boundaries in a stitched row stream: each time
    the per-writer ``seq`` stamp drops, a fresh writer appended to the
    same file. Rows without ``seq`` (pre-ops runs) contribute no
    boundaries."""
    restarts = 0
    prev = None
    for rec in records:
        seq = rec.get("seq")
        if not isinstance(seq, int) or isinstance(seq, bool):
            continue
        # within one writer seq is STRICTLY increasing, so a repeat is
        # a boundary too (a pre-crash writer that flushed exactly one
        # row hands seq 0 to the restart's first seq 0)
        if prev is not None and seq <= prev:
            restarts += 1
        prev = seq
    return restarts


def stitch_rows(records: List[Dict], key: str = "round") -> List[Dict]:
    """Cross-restart stitching: an elastic restart resumes from the
    last durable checkpoint, so the re-run rounds appear twice in the
    appended stream. The LAST occurrence of each ``key`` wins (file
    order — the re-run row supersedes the pre-crash one), and the
    result is sorted by ``key``. Rows missing ``key`` are dropped."""
    by_key: Dict = {}
    for rec in records:
        k = rec.get(key)
        if isinstance(k, (int, float)) and not isinstance(k, bool):
            by_key[k] = rec
    return [by_key[k] for k in sorted(by_key)]


def read_header(path: str) -> Optional[Dict]:
    for rec in iter_jsonl(path):
        return rec if "schema" in rec else None
    return None
