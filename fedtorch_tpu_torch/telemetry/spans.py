"""Host-span tracing exported as Chrome trace-event JSON (port of
``fedtorch_tpu/telemetry/spans.py``).

The device profiler attributes time *inside* the round's kernels; what
it cannot see is the host side of a round — schedule replay, feed
gather, H2D dispatch, the dispatch gap between rounds, scalar fetch,
eval, checkpoint IO — and :class:`SpanRecorder` makes those visible
facts: every instrumented host phase becomes a complete event
(``ph: "X"``) in a ``trace.json`` loadable in Perfetto / chrome://
tracing, with thread lanes for the CLI loop, the stream-feed producer,
and the async checkpoint writer.

Overhead discipline: opening+closing a span is two
``time.perf_counter_ns`` calls and one ``list.append`` (GIL-atomic, so
producer/writer threads record without locks). The buffer is
bounded (``max_events``); past the cap new spans are counted as
dropped instead of growing without bound on month-long runs.
"""
from __future__ import annotations

import json
import os
import threading
import time
from typing import Dict, List, Optional


class _Span:
    """Reusable context manager for one span (allocation-light: one
    object per ``span()`` call, no closure)."""

    __slots__ = ("_rec", "name", "args", "_t0")

    def __init__(self, rec: "SpanRecorder", name: str, args: Optional[Dict]):
        self._rec = rec
        self.name = name
        self.args = args

    def __enter__(self) -> "_Span":
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> None:
        self._rec._record(self.name, self._t0, time.perf_counter_ns(),
                          self.args)


class _NullSpan:
    """The disabled path: one shared instance, empty enter/exit."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return None


NULL_SPAN = _NullSpan()


class SpanRecorder:
    """In-memory span buffer with a Chrome trace-event exporter.

    ``ts``/``dur`` are microseconds relative to the recorder's creation
    (the Chrome format treats the origin as arbitrary); the absolute
    wall-clock origin is recorded as trace metadata so spans can be
    correlated with profiler captures and log timestamps.
    """

    def __init__(self, max_events: int = 200_000,
                 pid: Optional[int] = None):
        self.pid = pid if pid is not None else os.getpid()
        self.max_events = int(max_events)
        self.origin_ns = time.perf_counter_ns()
        self.origin_unix = time.time()
        self.dropped = 0
        self._events: List[tuple] = []  # (name, t0, t1, tid, args)
        self._instants: List[tuple] = []  # (name, t, tid, args)
        # tid -> thread name, captured at RECORD time: worker threads
        # (the stream producer, the checkpoint writer) exit before the
        # run-end export, when threading.enumerate() can no longer
        # name them — their lanes must not degrade to "thread-<id>"
        self._names: Dict[int, str] = {}

    # -- recording ------------------------------------------------------
    def span(self, name: str, **args) -> _Span:
        return _Span(self, name, args or None)

    def _record(self, name, t0, t1, args) -> None:
        if len(self._events) >= self.max_events:
            self.dropped += 1
            return
        tid = threading.get_ident()
        if tid not in self._names:
            self._names[tid] = threading.current_thread().name
        self._events.append((name, t0, t1, tid, args))

    def instant(self, name: str, **args) -> None:
        """A zero-duration marker (``ph: "i"``) — used for correlating
        external windows (profiler captures) and one-shot events."""
        if len(self._instants) >= self.max_events:
            self.dropped += 1
            return
        tid = threading.get_ident()
        if tid not in self._names:
            self._names[tid] = threading.current_thread().name
        self._instants.append((name, time.perf_counter_ns(), tid,
                               args or None))

    def __len__(self) -> int:
        return len(self._events) + len(self._instants)

    # -- export ---------------------------------------------------------
    def _us(self, t_ns: int) -> float:
        return (t_ns - self.origin_ns) / 1e3

    def to_trace_events(self) -> List[Dict]:
        """The Chrome trace-event list (JSON-ready dicts)."""
        # thread-name metadata: Perfetto renders these as lane labels
        # (record-time capture in self._names; live threads refresh it
        # in case one was renamed)
        names = dict(self._names)
        names.update({t.ident: t.name for t in threading.enumerate()})
        tids = {tid for *_, tid, _ in self._events} \
            | {tid for _, _, tid, _ in self._instants}
        out: List[Dict] = [
            {"name": "process_name", "ph": "M", "pid": self.pid, "tid": 0,
             "args": {"name": "fedtorch_tpu_torch host"}},
        ]
        for tid in sorted(tids):
            out.append({"name": "thread_name", "ph": "M", "pid": self.pid,
                        "tid": tid,
                        "args": {"name": names.get(tid, f"thread-{tid}")}})
        for name, t0, t1, tid, args in self._events:
            ev = {"name": name, "cat": "host", "ph": "X",
                  "ts": self._us(t0), "dur": (t1 - t0) / 1e3,
                  "pid": self.pid, "tid": tid}
            if args:
                ev["args"] = args
            out.append(ev)
        for name, t, tid, args in self._instants:
            ev = {"name": name, "cat": "host", "ph": "i", "s": "p",
                  "ts": self._us(t), "pid": self.pid, "tid": tid}
            if args:
                ev["args"] = args
            out.append(ev)
        return out

    def export(self, path: str) -> int:
        """Write the Perfetto-loadable trace file; returns the event
        count. Atomic (tmp + rename) so a crash mid-export never leaves
        a torn file where a monitor expects JSON."""
        doc = {
            "traceEvents": self.to_trace_events(),
            "displayTimeUnit": "ms",
            "otherData": {
                "origin_unix": self.origin_unix,
                "dropped_spans": self.dropped,
            },
        }
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(doc, f)
        os.replace(tmp, path)
        return len(self)
