"""Append-only JSONL writers for ``metrics.jsonl`` / ``events.jsonl`` (port
of ``fedtorch_tpu/telemetry/metrics.py``).

One line per record, first line a schema header. Rows are buffered in
memory and flushed on a time budget (``flush_interval_s``, default 1s)
or every ``flush_rows`` records, whichever comes first — a per-row
flush would put an fsync-adjacent syscall on the round clock (the JAX
package's telemetry A/B measured ~100us/row on hardened filesystems),
while a 1s budget bounds crash loss to one second of rows
(``iter_jsonl`` skips a torn tail) and keeps ``tail -f`` usable.
Events flush immediately (rare, and each one matters). Values must
already be host-side Python scalars — the writers never touch device
values, which keeps the per-round device-sync count at exactly the one
batched fetch the loop already paid.
"""
from __future__ import annotations

import json
import os
import time
from typing import Dict, List, Optional

from fedtorch_tpu_torch.telemetry import faults as _tel_faults


class JsonlWriter:
    """Buffered line-per-record appender with a schema header.

    Failure-tolerant like the health file, with a bounded-retry
    degrade policy (docs/robustness.md "Host plane"): a failed flush
    KEEPS its buffered rows (bounded) and retries on the next flush —
    a transient full disk loses nothing — and only after
    ``max_consecutive_errors`` consecutive failures does the writer
    degrade to off: buffer dropped, one ``on_degrade`` notification
    (the hub turns it into a ``telemetry.degraded`` event), and every
    later write a cheap no-op. Telemetry must never kill training."""

    # rows kept across failed flushes before the oldest are dropped
    MAX_BUFFER_ROWS = 2000

    def __init__(self, path: str, schema: str,
                 run_meta: Optional[Dict] = None,
                 flush_interval_s: float = 1.0, flush_rows: int = 200,
                 max_consecutive_errors: int = 3, on_degrade=None):
        self.path = path
        self.schema = schema
        self.rows = 0
        self.write_errors = 0
        self.dropped_rows = 0
        self.degraded = False
        self.max_consecutive_errors = int(max_consecutive_errors)
        self.flush_interval_s = float(flush_interval_s)
        self.flush_rows = int(flush_rows)
        self._on_degrade = on_degrade
        self._consecutive_errors = 0
        self._buf: List[str] = []
        # events arrive from worker threads too (the stream producer's
        # chaos.host_fault, the checkpoint worker's ckpt.degraded, the
        # watchdog's firing): buffer append/drain must be mutually
        # exclusive or a row appended mid-flush is cleared unwritten.
        # _mutex guards ONLY the buffer (never held across IO);
        # _open_lock serializes the one-time file open; _io_lock
        # serializes batch writes (TextIOWrapper is not thread-safe —
        # concurrent f.write calls can splice lines). The injection
        # check runs under NONE of them: its first-fire announce
        # re-enters this writer, and any held lock would self-deadlock.
        # Created through the faults lock factory: the lock-order
        # sentinel (utils/lock_sentinel.py) instruments them by name
        # when armed; unarmed these are plain threading.Locks.
        self._mutex = _tel_faults.new_lock("JsonlWriter._mutex")
        self._open_lock = _tel_faults.new_lock("JsonlWriter._open_lock")
        self._io_lock = _tel_faults.new_lock("JsonlWriter._io_lock")
        self._last_flush = time.monotonic()
        self._f = None
        self._header = {"schema": schema,
                        "created_unix": time.time(),
                        **({"run": run_meta} if run_meta else {})}

    def _open(self):
        """Open (once) the output file, writing the schema header on a
        fresh file. Raises ``OSError`` on failure. Guarded by its own
        lock so two racing first-flushes cannot double-write the
        header; held only around the open, never around batch IO.
        NO injection check in here — flush() already checks the seam
        before calling, and a check under ``_open_lock`` could fire
        the first-fire announce, which re-enters this writer and would
        self-deadlock on the held lock."""
        with self._open_lock:
            if self._f is None:
                os.makedirs(os.path.dirname(self.path) or ".",
                            exist_ok=True)
                f = open(self.path, "a")
                if f.tell() == 0:
                    f.write(json.dumps(self._header) + "\n")
                    f.flush()
                else:
                    # appending to an existing file (elastic restart):
                    # a crash may have left a torn final line with NO
                    # newline — writing our first row directly after
                    # it would merge the two into one unparseable line
                    # and lose BOTH (the stale pre-crash row would
                    # then win the restart stitch). A defensive
                    # newline isolates the torn bytes; readers skip
                    # blank lines.
                    f.write("\n")
                    f.flush()
                self._f = f
            return self._f

    def _io_error(self) -> None:
        """Called OUTSIDE ``_mutex``: the degrade notifications can
        re-enter this (or another) writer via ``telemetry.event``."""
        self.write_errors += 1
        self._consecutive_errors += 1
        if self._consecutive_errors >= self.max_consecutive_errors \
                and not self.degraded:
            self.degraded = True
            with self._mutex:
                self.dropped_rows += len(self._buf)
                self._buf.clear()
            from fedtorch_tpu_torch.telemetry import faults
            faults.note_degraded("telemetry.write")
            if self._on_degrade is not None:
                try:
                    self._on_degrade(self)
                except Exception:
                    pass  # the notification must not outcrash the IO

    def write(self, row: Dict, flush: bool = False) -> None:
        if self.degraded:
            self.dropped_rows += 1
            return
        # stamp every row with the per-writer monotonic sequence and a
        # wall-clock time (events already carry their own `t`): an
        # elastic restart appends a fresh writer to the SAME file, so
        # a mid-stream seq drop marks the restart boundary and `t`
        # orders rows across it — compare/watch stitch unambiguously
        # (telemetry.schema count_restarts/stitch_rows). Stamped under
        # the mutex so seq order matches buffer order.
        row = dict(row)
        if "t" not in row:
            row["t"] = time.time()
        with self._mutex:
            row["seq"] = self.rows
            try:
                line = json.dumps(row) + "\n"
            except (TypeError, ValueError):
                self.write_errors += 1
                return
            self._buf.append(line)
            self.rows += 1
            if len(self._buf) > self.MAX_BUFFER_ROWS:
                # a long outage must not grow host memory without bound
                del self._buf[0]
                self.dropped_rows += 1
            # the flush decision reads the buffer length, so it
            # belongs under the same mutex as the appends (FTH003
            # half-discipline: a concurrent drain between the append
            # and an unlocked read could skip the row-count trigger)
            want_flush = flush or len(self._buf) >= self.flush_rows
        now = time.monotonic()
        if want_flush or now - self._last_flush >= self.flush_interval_s:
            self.flush()

    def flush(self) -> None:
        self._last_flush = time.monotonic()
        if self.degraded:
            return
        # swap the batch out under the lock, do ALL IO (and the
        # injection check) outside it: a slow disk must not block
        # every telemetry-emitting thread behind the mutex, and the
        # injector's first-fire announce re-enters this writer via
        # telemetry.event — under a held non-reentrant lock that was
        # a self-deadlock
        with self._mutex:
            if not self._buf:
                return
            batch, self._buf = self._buf, []
        try:
            from fedtorch_tpu_torch.telemetry import faults
            faults.check("telemetry.write")
            with self._io_lock:
                f = self._open()
                # one write call for the batch: concurrent readers
                # (and a crash) see whole lines or nothing
                f.write("".join(batch))
                f.flush()
                self._consecutive_errors = 0
        except OSError:
            # the batch stays buffered for the next attempt (a
            # transient full disk loses nothing); rows appended by
            # other threads meanwhile land AFTER — ordering wobble,
            # never loss
            with self._mutex:
                self._buf[0:0] = batch
            self._io_error()

    def close(self) -> None:
        self.flush()
        if self._f is not None:
            try:
                self._f.close()
            except OSError:
                pass
            self._f = None
