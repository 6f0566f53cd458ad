"""Round-wall critical-path attribution (port of
``fedtorch_tpu/telemetry/critical_path.py``, docs/observability.md
"Operating and comparing runs"). Stdlib arithmetic over host values the
metrics rows already carry; no device sync.

* :func:`overlap_efficiency`: the share of the stream producer's
  gather + H2D wall that hid under device compute this round. The
  producer's cumulative gauges (``StreamFeedProducer.stats``) give per
  round

      hidden = max(d_gather + d_h2d - d_wait, 0)
      overlap_efficiency = hidden / (d_gather + d_h2d)

  clamped to [0, 1]; ``None`` when the producer did no work.
* :func:`round_wall_decomposition`: the round wall split into the host
  phases and, where ``program_costs.json`` gives the primary program's
  FLOPs, the device-time floor. The port writes no such file (XLA's
  cost analysis has no torch port), so on a port run
  :func:`device_floor_s` returns None and the decomposition holds the
  host phases only, as the JAX functions do without costs.
"""
from __future__ import annotations

from typing import Dict, List, Optional

# metrics-row keys the per-round delta derivation consumes (cumulative
# counters, StreamFeedProducer.stats)
STREAM_CUMULATIVE_KEYS = ("stream_gather_s", "stream_h2d_s",
                          "stream_wait_s")


def overlap_efficiency(gather_s: float, h2d_s: float,
                       wait_s: float) -> Optional[float]:
    """Fraction of one round's producer wall (gather + H2D dispatch)
    hidden under device compute, clamped to [0, 1]; ``None`` when the
    producer did no work this round (no wall to hide). ``wait_s``
    exceeding the producer wall (the consumer also waited on a stall
    that wasn't producer work — a rebuild, a retry backoff) clamps to
    0: nothing provably hid."""
    producer_wall = float(gather_s) + float(h2d_s)
    if producer_wall <= 0.0:
        return None
    hidden = producer_wall - max(float(wait_s), 0.0)
    return min(max(hidden / producer_wall, 0.0), 1.0)


class StreamOverlapTracker:
    """Per-round :func:`overlap_efficiency` from the CUMULATIVE
    producer gauges the metrics row already carries. The CLI loop
    feeds it each round's gauge dict; report/compare replay it over
    recorded rows. A cumulative counter going backwards (producer
    rebuild, elastic restart re-zeroing `.stats`) resets the baseline
    instead of producing a negative delta."""

    def __init__(self):
        self._prev: Optional[Dict[str, float]] = None

    def observe(self, gauges: Dict) -> Optional[float]:
        """One round's gauge dict (any dict containing the cumulative
        ``stream_gather_s``/``stream_h2d_s``/``stream_wait_s`` keys);
        returns this round's overlap efficiency or ``None`` (non-stream
        row, first row, counter reset, idle producer)."""
        try:
            cur = {k: float(gauges[k]) for k in STREAM_CUMULATIVE_KEYS}
        except (KeyError, TypeError, ValueError):
            return None
        prev, self._prev = self._prev, cur
        if prev is None:
            return None
        deltas = {k: cur[k] - prev[k] for k in STREAM_CUMULATIVE_KEYS}
        if any(d < 0.0 for d in deltas.values()):
            # counters re-zeroed under us: new producer / restart —
            # this round's delta is unattributable
            return None
        return overlap_efficiency(deltas["stream_gather_s"],
                                  deltas["stream_h2d_s"],
                                  deltas["stream_wait_s"])


def replay_overlap(rows: List[Dict]) -> List[Optional[float]]:
    """Per-row overlap efficiency over recorded metrics rows: the
    row's own ``overlap_efficiency`` gauge when the run emitted it
    (post-ops-plane runs), else re-derived from the cumulative
    counters (older runs) — one entry per row, ``None`` where
    undefined."""
    tracker = StreamOverlapTracker()
    out: List[Optional[float]] = []
    for row in rows:
        derived = tracker.observe(row)
        emitted = row.get("overlap_efficiency")
        out.append(float(emitted) if isinstance(emitted, (int, float))
                   and not isinstance(emitted, bool) else derived)
    return out


def _counter_total(rows: List[Dict], key: str) -> float:
    """Total accumulated by a CUMULATIVE per-writer counter across the
    whole (possibly restart-stitched) row stream: segment-aware, so a
    counter that re-zeroes mid-run (elastic restart, producer rebuild)
    contributes every segment's growth instead of only the last
    segment's final value."""
    total = 0.0
    prev = None
    for r in rows:
        v = r.get(key)
        if not isinstance(v, (int, float)) or isinstance(v, bool):
            continue
        v = float(v)
        # a drop starts a fresh writer counting from 0
        total += v if (prev is None or v < prev) else v - prev
        prev = v
    return total


def overlap_summary(rows: List[Dict]) -> Optional[Dict]:
    """Run-level overlap statistics for report/compare: mean/min/last
    efficiency over the rounds where it is defined, plus the producer
    wall and the exposed (unhidden) share of it — both reset-aware
    across elastic restarts (``_counter_total``). ``None`` for
    non-stream runs."""
    effs = [e for e in replay_overlap(rows) if e is not None]
    if not effs:
        return None
    producer_wall = _counter_total(rows, "stream_gather_s") \
        + _counter_total(rows, "stream_h2d_s")
    wait = _counter_total(rows, "stream_wait_s")
    return {
        "rounds": len(effs),
        "mean": sum(effs) / len(effs),
        "min": min(effs),
        "last": effs[-1],
        "producer_wall_s": producer_wall,
        "consumer_wait_s": wait,
        "exposed_frac": min(wait / producer_wall, 1.0)
        if producer_wall > 0 else 0.0,
    }


def device_floor_s(costs_doc: Optional[Dict]) -> Optional[float]:
    """The primary program's FLOPs-at-peak device-time floor (seconds)
    from a ``program_costs.json`` document — the analytic lower bound
    on device-busy time per round. ``None`` when the capture has no
    usable primary FLOPs."""
    if not costs_doc:
        return None
    primary = (costs_doc.get("programs") or {}).get(
        costs_doc.get("primary"))
    if not primary:
        return None
    flops = primary.get("flops")
    peak = costs_doc.get("peak_tflops_per_chip")
    chips = costs_doc.get("num_devices") or 1
    if not flops or not peak:
        return None
    return float(flops) / (float(peak) * 1e12 * float(chips))


def round_wall_decomposition(rows: List[Dict],
                             costs_doc: Optional[Dict] = None
                             ) -> Optional[Dict]:
    """Mean per-round wall split into attributed terms:

    * ``device_floor_s`` — the captured primary program's FLOPs at
      peak (what a 100%-MFU chip would need; the MXU share of the
      round is AT LEAST this);
    * ``host_fetch_s`` / ``host_eval_s`` / ``host_checkpoint_s`` —
      the measured host phases around the jitted call;
    * ``stream_exposed_s`` — the producer wall the overlap failed to
      hide (consumer queue-wait; inside ``round_s``'s clock on the
      stream plane, so it is named, not added);
    * ``unattributed_s`` — round wall minus the device floor: dispatch
      gap, sub-peak MXU occupancy, copies/infeed — what the profiler
      trace attribution (``tools/trace_attrib``) decomposes further.

    Per-round means over the steady-state rows (the compile round is
    excluded, like the report's rate). ``None`` without rows."""
    steady = rows[1:] or rows
    if not steady:
        return None
    n = len(steady)
    mean = lambda key: sum(float(r.get(key, 0.0)) for r in steady) / n
    round_s = mean("round_s")
    floor = device_floor_s(costs_doc)
    out: Dict = {
        "rounds": n,
        "round_s_mean": round_s,
        "host_fetch_s": mean("fetch_s"),
        "host_eval_s": mean("eval_s"),
        "host_checkpoint_s": mean("checkpoint_s"),
    }
    # stream_wait_s is cumulative; per-round exposure is the mean
    # GROWTH after the first observation (reset-aware: a restart's
    # re-zeroed counter starts a new segment instead of clamping the
    # whole-run delta to 0)
    waits = [float(r["stream_wait_s"]) for r in rows
             if isinstance(r.get("stream_wait_s"), (int, float))
             and not isinstance(r.get("stream_wait_s"), bool)]
    if waits:
        if len(waits) >= 2:
            grown = sum((v if v < p else v - p)
                        for p, v in zip(waits, waits[1:]))
            out["stream_exposed_s"] = grown / (len(waits) - 1)
        else:
            out["stream_exposed_s"] = waits[0]
    if floor is not None and round_s > 0:
        out["device_floor_s"] = floor
        out["device_floor_frac"] = min(floor / round_s, 1.0)
        out["unattributed_s"] = max(round_s - floor, 0.0)
        out["host_frac"] = min(max(1.0 - floor / round_s, 0.0), 1.0)
    return out
