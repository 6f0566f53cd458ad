"""Stall watchdog: a wedged run becomes a detected, cycling failure (port
of ``fedtorch_tpu/robustness/watchdog.py``, a copy).

A process that hangs — a kernel that never returns, a stuck driver
call, a filesystem that blocks a write forever — raises nothing to
catch. The signature is unmistakable from the host side, though: *no
round completes*. :class:`StallWatchdog` watches exactly that signal.

The trainer loop feeds :meth:`heartbeat` once per completed round from
the main thread; a monitor thread checks the time since the last beat.
When it exceeds ``fault.watchdog_timeout_s``, the watchdog

1. dumps every Python thread's stack plus a host runtime snapshot
   (``utils.diagnostics.runtime_snapshot``) to the run log — the
   post-mortem an operator needs to distinguish "dead peer" from "slow
   eval" — and then
2. hard-exits with the restartable code 75 (``os._exit``: the main
   thread is wedged and cannot unwind, so ``sys.exit`` would never
   run). It exits from its own thread while a kernel may still be
   running on the card — the JAX package's contract, kept: the driver
   reclaims the context with the process.

The restart harness (``robustness/harness.py``) sees 75, relaunches
with ``--resume``, and training continues from the last durable
checkpoint — an infinite hang becomes a bounded outage.

Zero overhead when off: ``timeout_s <= 0`` (the default) never starts
the thread, and the watchdog is host-only — it touches no device state.
"""
from __future__ import annotations

import os
import sys
import threading
import time
import traceback
from typing import Callable, Optional

from fedtorch_tpu_torch.robustness.preemption import RESTART_EXIT_CODE


def format_thread_stacks() -> str:
    """Every live Python thread's stack, watchdog-safe: reads
    ``sys._current_frames`` without touching CUDA or the wedged
    thread's locks."""
    names = {t.ident: t.name for t in threading.enumerate()}
    lines = []
    for tid, frame in sys._current_frames().items():
        lines.append(f"--- Thread {names.get(tid, '?')} (ident {tid}) ---")
        lines.extend(ln.rstrip("\n")
                     for ln in traceback.format_stack(frame))
    return "\n".join(lines)


class StallWatchdog:
    """Monitor thread converting a silent stall into exit code 75.

    ``exit_fn`` is injectable for tests (default ``os._exit``); it
    receives the exit code AFTER the diagnostics have been written.
    ``sleep_fn``/``clock`` are injectable likewise. Use as a context
    manager or call :meth:`start`/:meth:`stop`."""

    def __init__(self, timeout_s: float, logger=None,
                 exit_code: int = RESTART_EXIT_CODE,
                 exit_fn: Optional[Callable[[int], None]] = None,
                 poll_s: Optional[float] = None,
                 clock: Callable[[], float] = time.monotonic):
        self.timeout_s = float(timeout_s)
        self.logger = logger
        self.exit_code = exit_code
        self.exit_fn = exit_fn if exit_fn is not None else os._exit
        # poll fast enough that a stall is caught well within ~1.25x
        # the timeout even for small timeouts
        self.poll_s = poll_s if poll_s is not None \
            else max(min(self.timeout_s / 4.0, 1.0), 0.05)
        self.clock = clock
        self.enabled = self.timeout_s > 0.0
        self.fired = False
        self.last_round: Optional[int] = None
        self._last_beat = clock()
        self._stop_evt = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- lifecycle ------------------------------------------------------
    def start(self) -> "StallWatchdog":
        if not self.enabled or self._thread is not None:
            return self
        self._last_beat = self.clock()
        self._thread = threading.Thread(
            target=self._monitor, name="stall-watchdog", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop_evt.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    def __enter__(self) -> "StallWatchdog":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- the heartbeat --------------------------------------------------
    def heartbeat(self, round_idx: Optional[int] = None) -> None:
        """Called by the trainer loop after every completed round (and
        at loop entry). Cheap and lock-free: a float store is atomic
        under the GIL, and one-sided staleness is harmless here."""
        self._last_beat = self.clock()
        if round_idx is not None:
            self.last_round = round_idx

    # -- the monitor ----------------------------------------------------
    def _monitor(self) -> None:
        while not self._stop_evt.wait(self.poll_s):
            elapsed = self.clock() - self._last_beat
            if elapsed > self.timeout_s:
                self._fire(elapsed)
                return

    def _fire(self, elapsed: float) -> None:
        self.fired = True
        at = f" (last completed round: {self.last_round})" \
            if self.last_round is not None else ""
        self._log(
            f"StallWatchdog: no round completed in {elapsed:.1f}s "
            f"(timeout {self.timeout_s:.1f}s){at} — the signature of a "
            "wedged process. Dumping thread "
            f"stacks and exiting {self.exit_code} (restartable).")
        try:
            # flip the machine-readable exit intent FIRST: an external
            # monitor polling health.json learns "stalled, exiting 75"
            # even if the diagnostics below wedge on a sick filesystem
            from fedtorch_tpu_torch import telemetry
            tel = telemetry.get_active()
            if tel is not None:
                tel.event("watchdog.fired", elapsed_s=elapsed,
                          last_round=self.last_round)
                # no round_idx: the health file already holds the
                # loop's rounds-completed counter, and writing the
                # watchdog's (differently-based) heartbeat round would
                # count as progress — a wedged host must NOT report
                # since_progress_s ~ 0 in its own stall document
                tel.health_update("stalled", exit_code=self.exit_code)
        except Exception as e:  # telemetry must never block the exit
            self._log(f"StallWatchdog: health update failed: {e!r}")
        try:
            from fedtorch_tpu_torch.utils.diagnostics import runtime_snapshot
            self._log(f"StallWatchdog: runtime: {runtime_snapshot()}")
        except Exception as e:  # diagnostics must never block the exit
            self._log(f"StallWatchdog: runtime snapshot failed: {e!r}")
        try:
            self._log(format_thread_stacks())
        except Exception as e:
            self._log(f"StallWatchdog: stack dump failed: {e!r}")
        self.exit_fn(self.exit_code)

    def _log(self, msg: str) -> None:
        if self.logger is not None:
            try:
                self.logger.log(msg)
            except Exception:
                print(msg, file=sys.stderr, flush=True)
        else:
            print(msg, file=sys.stderr, flush=True)
