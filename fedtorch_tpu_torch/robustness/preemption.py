"""Preemption-safe stop signaling: SIGTERM drain instead of dying (port
of ``fedtorch_tpu/robustness/preemption.py``, a copy).

On a rented GPU the dominant failure is not a NaN client but
**preemption**: the cloud sends SIGTERM (or SIGUSR1, the advance
preemption notice) and reclaims the VM seconds later. The reference is
fail-stop here — the MPI job just dies and the operator restarts from
whatever checkpoint happens to exist (SURVEY §5.3). This module turns
the signal into a *clean drain*:

1. :class:`PreemptionHandler` installs SIGTERM/SIGINT/SIGUSR1 handlers
   that set a flag — nothing else happens in signal context.
2. The CLI round loop polls the flag at round boundaries, after the
   round's CUDA work has finished (the port runs one process, so the
   JAX package's cross-host agreement on the stop has nothing to
   agree with).
3. The loop drains the
   :class:`~fedtorch_tpu_torch.utils.checkpoint.AsyncCheckpointer`,
   writes a final checkpoint, and exits with the restartable code
   :data:`RESTART_EXIT_CODE` (75, BSD ``EX_TEMPFAIL``) so the restart
   harness (``robustness/harness.py``) knows to relaunch with
   ``--resume`` instead of treating the exit as fatal.

A second SIGINT while a drain is in progress restores Python's default
KeyboardInterrupt behavior — a hung drain must stay interruptible.
"""
from __future__ import annotations

import signal
import threading
from typing import Iterable, Optional

# BSD sysexits.h EX_TEMPFAIL: "temporary failure, retry later" — the
# contract between the draining trainer, the stall watchdog, and the
# restart harness. Anything else is treated as fatal by the harness.
RESTART_EXIT_CODE = 75


def default_stop_signals() -> tuple:
    """SIGTERM/SIGINT plus SIGUSR1 where the platform has it (the
    cloud preemption advance notice; absent on Windows)."""
    sigs = [signal.SIGTERM, signal.SIGINT]
    usr1 = getattr(signal, "SIGUSR1", None)
    if usr1 is not None:
        sigs.append(usr1)
    return tuple(sigs)


class PreemptionHandler:
    """Signal-to-flag adapter polled by the round loop.

    The handler body only sets a ``threading.Event`` and remembers the
    signal name — no I/O, no CUDA, nothing that could re-enter runtime
    state from signal context. Use as a context manager (or call
    :meth:`install`/:meth:`restore`); previously-installed handlers are
    restored on exit so library callers never leak process state."""

    def __init__(self, signals: Optional[Iterable[int]] = None,
                 logger=None):
        self.signals = tuple(signals) if signals is not None \
            else default_stop_signals()
        self.logger = logger
        self._stop = threading.Event()
        self._reason: Optional[str] = None
        self._prev: dict = {}
        self._sigints = 0
        self.installed = False

    # -- lifecycle ------------------------------------------------------
    def install(self) -> bool:
        """Install the handlers; returns False (and stays inert) when
        not on the main thread — ``signal.signal`` raises there, and a
        library must degrade to manual :meth:`request_stop` rather
        than kill an embedding application."""
        if self.installed:
            return True
        try:
            for sig in self.signals:
                self._prev[sig] = signal.signal(sig, self._on_signal)
        except ValueError:  # not the main thread
            for sig, prev in self._prev.items():
                signal.signal(sig, prev)  # pragma: no cover (unreached)
            self._prev.clear()
            self._log("preemption: not on the main thread; signal "
                      "handlers not installed (request_stop still works)")
            return False
        self.installed = True
        return True

    def restore(self) -> None:
        if not self.installed:
            return
        for sig, prev in self._prev.items():
            try:
                signal.signal(sig, prev)
            except (ValueError, OSError):  # interpreter teardown
                pass
        self._prev.clear()
        self.installed = False

    def __enter__(self) -> "PreemptionHandler":
        self.install()
        return self

    def __exit__(self, *exc) -> None:
        self.restore()

    # -- the flag -------------------------------------------------------
    def _on_signal(self, signum, frame) -> None:
        if signum == getattr(signal, "SIGINT", None):
            # escalate only on the SECOND Ctrl-C: a drain started by
            # SIGTERM/SIGUSR1 (the cloud's preemption notice) must
            # survive one stray Ctrl-C — only a repeated SIGINT means
            # the operator wants OUT of a hung drain
            self._sigints += 1
            if self._sigints >= 2:
                prev = self._prev.get(signum,
                                      signal.default_int_handler)
                signal.signal(signum, prev)
                raise KeyboardInterrupt
        try:
            self._reason = signal.Signals(signum).name
        except ValueError:  # unknown/realtime signal number
            self._reason = f"signal {signum}"
        self._stop.set()

    @property
    def stop_requested(self) -> bool:
        return self._stop.is_set()

    @property
    def reason(self) -> Optional[str]:
        """Name of the signal (or manual reason) that requested the
        stop; None while no stop is pending."""
        return self._reason

    def request_stop(self, reason: str = "request_stop") -> None:
        """Manual trigger — the watchdog, tests, and embedding apps
        (no signal delivery) use this path."""
        self._reason = reason
        self._stop.set()

    def _log(self, msg: str) -> None:
        if self.logger is not None:
            self.logger.log(msg)
