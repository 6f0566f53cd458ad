"""Machine-readable per-host liveness: ``health.json`` (port of
``fedtorch_tpu/telemetry/health.py``).

Before this file existed, "is the run alive?" was answerable only from
inside the process (the watchdog's in-memory heartbeat) or by regex on
``record0`` timestamps. ``health.json`` makes it a contract external
monitors can poll: one small JSON document per host, atomically
replaced at every round boundary, carrying the round/commit, a
monotonic last-progress stamp, the mean staleness (async plane), and
the process's **exit intent** — so a scraper can distinguish "draining
on SIGTERM" from "wedged in a collective" from "done" without reading
logs.

Atomicity: ``os.replace`` of a fully-written temp file, so a reader
polling mid-write always sees a complete, parseable document (pinned
under the SIGTERM drain drill in tests/test_preemption.py). No fsync:
the file is a liveness signal, not durable state — a host that loses
power stops updating it, which IS the signal, and an fsync per round
would put disk latency on the round clock.
"""
from __future__ import annotations

import json
import os
import socket
import time
from typing import Dict, Optional

from fedtorch_tpu_torch.telemetry.schema import HEALTH_SCHEMA, validate_health


def health_path(run_dir: str, process_index: int = 0) -> str:
    """Per-host file name: process 0 owns the plain ``health.json``
    (what single-host monitors poll); peers get an indexed sibling."""
    name = "health.json" if process_index == 0 \
        else f"health.p{process_index}.json"
    return os.path.join(run_dir, name)


class HealthFile:
    """Atomic writer for one host's health document.

    ``update`` is cheap (one json.dumps + tmp write + rename of ~300
    bytes) and failure-tolerant: a full disk or read-only run dir must
    degrade telemetry, never kill training — write errors are counted,
    not raised."""

    def __init__(self, path: str, process_index: int = 0,
                 clock=time.monotonic, min_interval_s: float = 1.0,
                 max_consecutive_errors: int = 3, on_degrade=None):
        self.path = path
        self.process_index = process_index
        self.clock = clock
        # disk-write throttle: a run doing 100+ rounds/s must not pay
        # an atomic file replace per round (~1ms on hardened
        # filesystems — the dominant term of the JAX package's
        # telemetry A/B before throttling). Liveness monitors poll at >= seconds
        # granularity, so the round field lagging up to this interval
        # costs nothing; INTENT changes always write immediately.
        self.min_interval_s = float(min_interval_s)
        self.write_errors = 0
        self.writes = 0
        self.throttled = 0
        # degrade-to-off (docs/robustness.md "Host plane"): after this
        # many CONSECUTIVE replace failures the writer stops touching
        # the sick filesystem — a silent health file IS the liveness
        # signal a dead disk should produce, and per-round write
        # attempts against it would put its timeouts on the round clock
        self.max_consecutive_errors = int(max_consecutive_errors)
        self.degraded = False
        self._on_degrade = on_degrade
        self._consecutive_errors = 0
        self._last: Dict = {}
        self._last_write_t: Optional[float] = None
        self._last_progress = clock()
        self._last_round: Optional[int] = None

    def update(self, intent: str, round_idx: Optional[int] = None,
               staleness: Optional[float] = None, **extra) -> Dict:
        """Write the document. ``round_idx`` advancing (or first
        appearing) refreshes the monotonic last-progress stamp;
        intent-only updates (e.g. ``drain``) keep it, so staleness
        stays measurable through a drain."""
        now = self.clock()
        if round_idx is not None and round_idx != self._last_round:
            self._last_round = round_idx
            self._last_progress = now
        if (self._last_write_t is not None
                and intent == self._last.get("intent")
                and now - self._last_write_t < self.min_interval_s):
            self.throttled += 1
            return self._last
        doc = {
            "schema": HEALTH_SCHEMA,
            "pid": os.getpid(),
            "host": socket.gethostname(),
            "process_index": self.process_index,
            "round": self._last_round if self._last_round is not None
            else -1,
            "intent": intent,
            "updated_unix": time.time(),
            # monotonic stamps let a same-host reader compute
            # time-since-progress without wall-clock skew
            "progress_monotonic": self._last_progress,
            "updated_monotonic": now,
            "since_progress_s": now - self._last_progress,
        }
        if staleness is not None:
            doc["staleness"] = float(staleness)
        doc.update(extra)
        self._last = doc
        self._last_write_t = now
        if self.degraded:
            return doc  # document kept current in memory; disk is off
        tmp = f"{self.path}.tmp.{os.getpid()}"
        try:
            from fedtorch_tpu_torch.telemetry import faults
            faults.check("telemetry.write")
            with open(tmp, "w") as f:
                json.dump(doc, f)
            os.replace(tmp, self.path)
            self.writes += 1
            self._consecutive_errors = 0
        except OSError:
            self.write_errors += 1
            self._consecutive_errors += 1
            if self._consecutive_errors >= self.max_consecutive_errors:
                self.degraded = True
                from fedtorch_tpu_torch.telemetry import faults
                faults.note_degraded("telemetry.write")
                if self._on_degrade is not None:
                    try:
                        self._on_degrade(self)
                    except Exception:
                        pass
        return doc

    @property
    def last(self) -> Dict:
        return dict(self._last)


def read_health(run_dir_or_path: str,
                process_index: int = 0) -> Optional[Dict]:
    """Parse a health document; None when missing/unreadable (a
    monitor's absence case, never an exception). A parseable document
    with a bad schema DOES raise — that is a version skew the operator
    must see."""
    path = run_dir_or_path
    if os.path.isdir(path):
        path = health_path(path, process_index)
    try:
        with open(path) as f:
            doc = json.load(f)
    except (OSError, json.JSONDecodeError):
        return None
    validate_health(doc)
    return doc
