"""Host-side anomaly detection over the metrics rows (port of
``fedtorch_tpu/telemetry/anomaly.py``, docs/observability.md
"Federation plane").

A stdlib EWMA z-score detector the CLI loop feeds each finished metrics
row: per watched field it tracks an exponentially weighted mean and
variance and, past its warm-up, flags values more than ``zscore``
standard deviations out (a diverging loss, a dispersion spike, a
guard-rejection burst, a staleness runaway). Observe-only: anomalies
become ``anomaly.detected`` events and drive no control flow (the
supervisor stays the only actor).

One event per field per excursion (the detector re-arms when the field
comes back inside the band), at most ``max_events_per_field`` a field.
The EWMA absorbs every finite value, anomalous ones included, so a
level shift becomes the new normal. Stdlib only.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

# metrics-row fields watched by default. ``reject_rate``,
# ``dropout_rate`` and ``deadline_miss_rate`` are derived (count /
# max(n_online, 1)) — the raw counts scale with k and would alias
# cohort-size changes into anomalies.
ANOMALY_FIELDS = ("loss", "cohort_dispersion", "reject_rate",
                  "staleness", "dropout_rate", "deadline_miss_rate",
                  "dp_clipped_frac")


class EwmaAnomalyDetector:
    """Per-field EWMA mean/variance + z-score excursion detection."""

    def __init__(self, zscore: float = 6.0, fields=ANOMALY_FIELDS,
                 alpha: float = 0.1, warmup: int = 10,
                 max_events_per_field: int = 20):
        if zscore <= 0.0:
            raise ValueError(f"zscore must be > 0, got {zscore}")
        self.zscore = float(zscore)
        self.fields = tuple(fields)
        self.alpha = float(alpha)
        self.warmup = int(warmup)
        self.max_events_per_field = int(max_events_per_field)
        # field -> (n, mean, var, in_excursion, emitted)
        self._state: Dict[str, Tuple[int, float, float, bool, int]] = {
            f: (0, 0.0, 0.0, False, 0) for f in self.fields}

    @staticmethod
    def derive(row: Dict) -> Dict[str, float]:
        """The derived fields observed alongside the raw row."""
        out = {}
        if "rejected" in row and "n_online" in row:
            out["reject_rate"] = float(row["rejected"]) \
                / max(float(row["n_online"]), 1.0)
        # availability-lifecycle rates (robustness/availability.py):
        # a dropout or deadline-miss burst is a deployment-health
        # signal even before quorum degrades
        if "avail_dropped" in row and "n_online" in row:
            out["dropout_rate"] = float(row["avail_dropped"]) \
                / max(float(row["n_online"]), 1.0)
        if "deadline_missed" in row and "n_online" in row:
            out["deadline_miss_rate"] = float(row["deadline_missed"]) \
                / max(float(row["n_online"]), 1.0)
        # privacy plane: dp_clipped_frac is already a cohort-size-
        # invariant fraction — a clip-saturation excursion means the
        # update distribution shifted against the fixed dp_clip_norm
        if "dp_clipped_frac" in row:
            out["dp_clipped_frac"] = float(row["dp_clipped_frac"])
        return out

    def observe(self, row: Dict) -> List[Dict]:
        """Feed one metrics row; returns the (possibly empty) list of
        anomaly records — ``{"field", "value", "zscore", "ewma_mean",
        "ewma_std"}`` — for the caller to emit as ``anomaly.detected``
        events. Never raises on missing/odd fields: telemetry must not
        outcrash the loop it watches."""
        values = dict(row)
        values.update(self.derive(row))
        out: List[Dict] = []
        for field in self.fields:
            v = values.get(field)
            if v is None or isinstance(v, bool) \
                    or not isinstance(v, (int, float)):
                continue
            x = float(v)
            n, mean, var, in_exc, emitted = self._state[field]
            std = math.sqrt(max(var, 0.0))
            anomalous = False
            z: Optional[float] = None
            if not math.isfinite(x):
                # a NaN/Inf metric is an anomaly by definition (and
                # must not poison the EWMA below)
                anomalous = n >= self.warmup
            elif n >= self.warmup:
                dev = abs(x - mean)
                if std > 0.0:
                    z = dev / std
                    anomalous = z > self.zscore
                else:
                    # a zero-variance history (e.g. a reject rate that
                    # was 0.0 every round) makes ANY departure
                    # infinitely many sigmas out — z stays None
                    anomalous = dev > max(1e-9 * abs(mean), 1e-12)
            if anomalous and not in_exc \
                    and emitted < self.max_events_per_field:
                out.append({
                    "field": field, "value": x if math.isfinite(x)
                    else repr(x),
                    "zscore": round(z, 2) if z is not None else None,
                    "ewma_mean": round(mean, 6),
                    "ewma_std": round(std, 6)})
                emitted += 1
            if math.isfinite(x):
                # standard EW mean/variance update (West 1979 form);
                # anomalous values are absorbed too — a level shift
                # becomes the new normal instead of alerting forever
                diff = x - mean
                incr = self.alpha * diff
                mean += incr
                var = (1.0 - self.alpha) * (var + diff * incr)
                n += 1
            self._state[field] = (n, mean, var, anomalous, emitted)
        return out

    def summary(self) -> Dict[str, Dict[str, float]]:
        """Per-field detector state for end-of-run reporting."""
        return {
            f: {"observations": n, "ewma_mean": round(mean, 6),
                "ewma_std": round(math.sqrt(max(var, 0.0)), 6),
                "events": emitted}
            for f, (n, mean, var, _exc, emitted) in self._state.items()}


def replay_anomalies(run_dir: str, zscore: float = 6.0,
                     **detector_kwargs) -> Dict:
    """Offline anomaly replay: run a FRESH detector over a recorded
    run dir's ``metrics.jsonl`` (e.g. to re-judge a run at a different
    threshold than the live one, or a run that had the detector off).
    Torn-tail tolerant and restart-stitched via the shared
    ``telemetry.schema`` loader — a truncated final line is counted,
    never raises. Returns ``{"anomalies": [per-row records with the
    round attached], "summary": detector state, "rows": n,
    "torn_lines": n}``."""
    import os

    from fedtorch_tpu_torch.telemetry.schema import load_jsonl, stitch_rows

    _header, records, torn = load_jsonl(
        os.path.join(run_dir, "metrics.jsonl"))
    rows = stitch_rows(records)
    det = EwmaAnomalyDetector(zscore=zscore, **detector_kwargs)
    out: List[Dict] = []
    for row in rows:
        for a in det.observe(row):
            out.append({"round": row.get("round"), **a})
    return {"anomalies": out, "summary": det.summary(),
            "rows": len(rows), "torn_lines": torn}
