"""The run-scoped telemetry hub: one object per training run (port of
``fedtorch_tpu/telemetry/runtime.py``).

:class:`Telemetry` bundles the three pillars (docs/observability.md):

* structured **metrics/events** — ``metrics.jsonl`` (one row per
  round/commit, schema-versioned) and ``events.jsonl`` (irregular
  occurrences: drain requests, supervisor rollbacks, chaos summaries,
  watchdog firings) in the run dir;
* **host-span tracing** — a :class:`~.spans.SpanRecorder` exported to
  ``trace.json`` (Chrome trace-event format, loads in Perfetto);
* machine-readable **health** — the atomically-replaced per-host
  ``health.json``.

Library code that cannot see the run's ``Telemetry`` object (the
stream-feed producer thread, the async checkpoint writer, the
supervisor, ``capture_round_trace``) records through the module-level
:func:`~fedtorch_tpu_torch.telemetry.span` / ``event`` / ``instant``
functions, which dispatch to the ACTIVE instance — installed by the
CLI loop for the run's duration — and compile to a shared no-op when
none is active (or ``level='off'``), so instrumented hot paths cost an
attribute load + truth test when telemetry is disabled.

Multi-host: every process writes its own health file; only process 0
writes metrics/events/trace (after the collective scalar fetch every
process holds the same values — N writers would race on one file for
no information gain).
"""
from __future__ import annotations

import os
import time
from typing import Dict, Optional

from fedtorch_tpu_torch.telemetry.health import HealthFile, health_path
from fedtorch_tpu_torch.telemetry.metrics import JsonlWriter
from fedtorch_tpu_torch.telemetry.schema import (
    EVENTS_SCHEMA, METRICS_SCHEMA,
)
from fedtorch_tpu_torch.telemetry.spans import NULL_SPAN, SpanRecorder

LEVELS = ("off", "default", "debug")

# the active instance (None = every module-level hook is a no-op)
_active: Optional["Telemetry"] = None


def get_active() -> Optional["Telemetry"]:
    return _active


class Telemetry:
    """Per-run telemetry files + span recorder + health document.

    Use as a context manager (installs/uninstalls the active instance)
    or call :meth:`install`/:meth:`close` explicitly. Safe to construct
    with ``level='off'``: everything becomes inert and no files are
    touched — callers never need an ``if`` around instrumentation.
    """

    def __init__(self, run_dir: Optional[str], level: str = "default",
                 process_index: int = 0,
                 run_meta: Optional[Dict] = None,
                 max_span_events: int = 200_000):
        if level not in LEVELS:
            raise ValueError(
                f"telemetry level must be one of {LEVELS}, got {level!r}")
        self.level = level
        self.run_dir = run_dir
        self.process_index = process_index
        self.enabled = level != "off" and run_dir is not None
        self.is_writer = process_index == 0
        self._installed = False
        self.metrics: Optional[JsonlWriter] = None
        self.events: Optional[JsonlWriter] = None
        self.spans: Optional[SpanRecorder] = None
        self.health: Optional[HealthFile] = None
        self.trace_path: Optional[str] = None
        self._rounds_seen = 0
        if not self.enabled:
            return
        self.health = HealthFile(health_path(run_dir, process_index),
                                 process_index,
                                 on_degrade=lambda _w:
                                 self._writer_degraded("health"))
        if self.is_writer:
            self.metrics = JsonlWriter(
                os.path.join(run_dir, "metrics.jsonl"), METRICS_SCHEMA,
                run_meta,
                on_degrade=lambda _w: self._writer_degraded("metrics"))
            self.events = JsonlWriter(
                os.path.join(run_dir, "events.jsonl"), EVENTS_SCHEMA,
                run_meta,
                on_degrade=lambda _w: self._writer_degraded("events"))
            self.spans = SpanRecorder(max_events=max_span_events)
            self.trace_path = os.path.join(run_dir, "trace.json")

    # -- lifecycle ------------------------------------------------------
    def install(self) -> "Telemetry":
        global _active
        if self.enabled:
            _active = self
            self._installed = True
        return self

    def close(self) -> None:
        """Uninstall, export the trace, close the writers. Idempotent;
        never raises (end-of-run bookkeeping must not mask the loop's
        own outcome)."""
        global _active
        if _active is self:
            _active = None
        self._installed = False
        if self.spans is not None and self.trace_path is not None:
            try:
                self.spans.export(self.trace_path)
            except OSError:
                pass
        for w in (self.metrics, self.events):
            if w is not None:
                w.close()

    def __enter__(self) -> "Telemetry":
        return self.install()

    def __exit__(self, *exc) -> None:
        self.close()

    def _writer_degraded(self, which: str) -> None:
        """One of the pillar writers gave up (too many consecutive IO
        failures): emit ONE ``telemetry.degraded`` event — on the
        events channel if it is still alive (a degraded events writer
        silently drops it, which is the best that can be done with a
        dead disk) — and a stderr line so the operator sees it even
        with every file channel down. The loop keeps running either
        way: telemetry degrades to off, never to a crash."""
        import sys
        try:
            self.event("telemetry.degraded", writer=which)
        except Exception:
            pass
        print(f"telemetry: {which} writer degraded to off after "
              "repeated write failures", file=sys.stderr, flush=True)

    # -- recording ------------------------------------------------------
    def span(self, name: str, **args):
        if self.spans is None:
            return NULL_SPAN
        return self.spans.span(name, **args)

    def instant(self, name: str, **args) -> None:
        if self.spans is not None:
            self.spans.instant(name, **args)

    def event(self, name: str, **fields) -> None:
        """One irregular occurrence: a line in ``events.jsonl`` plus an
        instant marker on the trace timeline (same name — so Perfetto
        shows WHERE in the round the drain/rollback/firing landed)."""
        if self.events is not None:
            self.events.write({"t": time.time(), "event": name,
                               **fields}, flush=True)
        if self.spans is not None:
            self.spans.instant(name, **fields)

    def round_row(self, row: Dict) -> None:
        """Append one per-round metrics row (see telemetry.schema).
        ``level='debug'`` additionally re-exports the trace every 25
        rounds so a live Perfetto session can follow a long run."""
        if self.metrics is not None:
            self.metrics.write(row)
        self._rounds_seen += 1
        if self.level == "debug" and self.spans is not None \
                and self.trace_path is not None \
                and self._rounds_seen % 25 == 0:
            try:
                self.spans.export(self.trace_path)
            except OSError:
                pass

    def health_update(self, intent: str, round_idx: Optional[int] = None,
                      staleness: Optional[float] = None, **extra) -> None:
        if self.health is not None:
            self.health.update(intent, round_idx=round_idx,
                               staleness=staleness, **extra)
