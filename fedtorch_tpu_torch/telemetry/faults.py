"""Seam hooks connecting the telemetry writers to the host-chaos layer
(port of ``fedtorch_tpu/telemetry/faults.py``).

The telemetry package must stay stdlib-only (the report tool and
external monitors parse run dirs without a backend), so it cannot
import ``fedtorch_tpu_torch.robustness`` — whose package init pulls the
torch-backed chaos/guard modules. This tiny registry inverts the
dependency: the host-fault injector (``robustness/host_chaos.py``)
registers a *check* hook here when it installs, and the recovery
recorder (``robustness/host_recovery.py``) registers a *degrade sink*;
the writers call :func:`check`/:func:`note_degraded` unconditionally,
which compile to a None-test when nothing is armed.

* :func:`check` — called inside each writer's try block, so an
  injected ``OSError`` flows through the SAME error handling a real
  full disk would exercise (the point of the drill).
* :func:`note_degraded` — called once when a writer gives up (too many
  consecutive failures), so the run's degraded-seam set and the
  ``health.json`` ``degraded`` intent see it.
* :func:`new_lock` — the lock factory the host-plane subsystems create
  their mutexes through. Unarmed it returns a plain
  ``threading.Lock`` (zero overhead); the runtime lock-order sentinel
  (``utils/lock_sentinel.py``) registers a factory hook
  while armed, so every lock created inside its scope is instrumented
  with a stable name and per-thread acquisition-order recording.
"""
from __future__ import annotations

import threading
from typing import Callable, Optional

_check_hook: Optional[Callable[[str], None]] = None
_degrade_sink: Optional[Callable[[str], None]] = None
_lock_hook: Optional[Callable[[str], object]] = None


def set_check_hook(fn: Optional[Callable[[str], None]]) -> None:
    """Install (or clear, with None) the fault-injection check hook."""
    global _check_hook
    _check_hook = fn


def set_degrade_sink(fn: Optional[Callable[[str], None]]) -> None:
    """Install (or clear, with None) the degraded-seam sink."""
    global _degrade_sink
    _degrade_sink = fn


def check(seam: str) -> None:
    """Give an armed injector the chance to raise at ``seam``. Called
    inside the writer's own try block — injected faults exercise the
    real recovery path, not a parallel one."""
    if _check_hook is not None:
        _check_hook(seam)


def note_degraded(seam: str) -> None:
    """Report that the subsystem owning ``seam`` degraded itself."""
    if _degrade_sink is not None:
        _degrade_sink(seam)


def set_lock_hook(fn: Optional[Callable[[str], object]]):
    """Install (or clear, with None) the named-lock factory hook.
    Returns the previously installed hook so a scoped sentinel can
    chain/restore it on exit."""
    global _lock_hook
    prev = _lock_hook
    _lock_hook = fn
    return prev


def new_lock(name: str):
    """A mutex for the host-plane subsystem that names it. Plain
    ``threading.Lock`` unless a lock-order sentinel armed the factory
    hook — then an instrumented wrapper recording acquisition order
    under ``name``."""
    if _lock_hook is not None:
        return _lock_hook(name)
    return threading.Lock()
