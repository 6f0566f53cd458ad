"""Host-plane self-healing: bounded retries, degraded modes, and the
run-scoped recovery ledger (port of
``fedtorch_tpu/robustness/host_recovery.py``, a copy; docs/robustness.md
"Host plane").

Production FL servers treat host I/O faults as routine, not fatal
(FedScale keeps its executor pool alive across worker faults; tf.data
makes the input pipeline a restartable service). Before this module,
every host seam added since the streaming plane was fail-fast: one
transient gather error or a full disk during a checkpoint aborted the
run — at best exit-75 and a full restart, paying start-up + resume.
This module is the shared recovery vocabulary those seams now use:

* :func:`retry` / :func:`retry_io` — bounded retry-with-backoff around
  an idempotent host operation (the stream producer's gather and its
  copy to the device, checkpoint writes). Exhaustion raises
  :class:`HostSeamError`, which NAMES the seam — so whatever layer
  finally reports the failure (the producer-rebuild wrapper, the
  supervisor, the operator's traceback) says *what* broke, not just
  that something timed out.
* :class:`HostRecovery` — the per-run ledger of retries, recoveries
  and degraded seams, installed by the CLI loop (like the telemetry
  hub) and read into the metrics row / ``health.json``
  ``degraded``/``recovering`` intents. It also registers as the
  telemetry writers' degrade sink (``telemetry.faults``), closing the
  loop the import direction forbids from the other side.

A module-default ledger backs library callers that never install one,
so ``retry`` works (and counts) outside a CLI run too.
"""
from __future__ import annotations

import dataclasses
import sys
import time
from typing import Callable, Dict, Optional, Tuple

from fedtorch_tpu_torch import telemetry
from fedtorch_tpu_torch.telemetry import faults as _tel_faults


class HostSeamError(RuntimeError):
    """A host-seam operation failed past its retry budget. Carries the
    seam name so supervisors/operators see WHICH host path broke
    (``RoundSupervisor`` counts these per seam)."""

    def __init__(self, seam: str, message: str):
        super().__init__(message)
        self.seam = seam


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Bounded retry-with-backoff: attempt n sleeps
    ``min(backoff_base_s * 2**n, backoff_max_s)`` before retrying."""
    max_retries: int = 3
    backoff_base_s: float = 0.05
    backoff_max_s: float = 2.0


class HostRecovery:
    """Run-scoped recovery ledger + the active retry policy.

    Thread-safe (the producer thread, the checkpoint worker and the
    main loop all report here). ``sleep_fn`` is injectable for tests.
    """

    def __init__(self, policy: Optional[RetryPolicy] = None,
                 sleep_fn: Callable[[float], None] = time.sleep):
        self.policy = policy if policy is not None else RetryPolicy()
        self.sleep_fn = sleep_fn
        self.retries: Dict[str, int] = {}
        self.recovered: Dict[str, int] = {}
        self.degraded: set = set()
        self._recovered_announced: set = set()
        self._lock = _tel_faults.new_lock("HostRecovery._lock")

    # -- lifecycle ------------------------------------------------------
    def install(self) -> "HostRecovery":
        global _active
        _active = self
        _tel_faults.set_degrade_sink(self.note_degraded)
        return self

    def uninstall(self) -> None:
        """Idempotent, and a no-op when ANOTHER ledger has since
        installed — a stale run's cleanup must not detach the live
        run's degrade sink."""
        global _active
        if _active is self:
            _active = _DEFAULT
            _tel_faults.set_degrade_sink(None)

    # -- the ledger -----------------------------------------------------
    def note_retry(self, seam: str) -> None:
        with self._lock:
            self.retries[seam] = self.retries.get(seam, 0) + 1

    def note_recovered(self, seam: str) -> None:
        """An operation succeeded after >= 1 retry. Emits one
        ``host.recovered`` event per seam per run — monitors key on
        the transition, not on every absorbed fault."""
        with self._lock:
            self.recovered[seam] = self.recovered.get(seam, 0) + 1
            announce = seam not in self._recovered_announced
            self._recovered_announced.add(seam)
        if announce:
            telemetry.event("host.recovered", seam=seam)

    def note_degraded(self, seam: str) -> None:
        """A subsystem gave up on ``seam`` and switched to its degraded
        mode (sync checkpoint writes, telemetry off). Idempotent per
        seam; emits one ``host.degraded`` event."""
        with self._lock:
            if seam in self.degraded:
                return
            self.degraded.add(seam)
        telemetry.event("host.degraded", seam=seam)
        print(f"host_recovery: seam {seam!r} degraded", file=sys.stderr,
              flush=True)

    def total_retries(self) -> int:
        with self._lock:
            return sum(self.retries.values())

    def stats(self) -> dict:
        """Recovery gauges for the telemetry round row."""
        with self._lock:
            return {
                "host_retries": float(sum(self.retries.values())),
                "host_recovered": float(sum(self.recovered.values())),
                "host_degraded": float(len(self.degraded)),
            }


# library callers without an installed ledger still retry (and count)
_DEFAULT = HostRecovery()
_active: HostRecovery = _DEFAULT


def get_active() -> HostRecovery:
    return _active


def retry(fn: Callable, seam: str,
          retryable: Tuple[type, ...] = (Exception,),
          policy: Optional[RetryPolicy] = None):
    """Run ``fn()`` with the active ledger's bounded retry policy.

    ``fn`` must be idempotent (host gathers, atomic writes,
    copies to the device all are). A success after >= 1 retry is
    recorded as a recovery; exhaustion raises :class:`HostSeamError`
    naming the seam, chained to the last real failure."""
    rec = _active
    pol = policy if policy is not None else rec.policy
    for attempt in range(pol.max_retries + 1):
        try:
            out = fn()
        except retryable as e:
            if attempt >= pol.max_retries:
                raise HostSeamError(
                    seam,
                    f"host seam {seam!r} failed "
                    f"{pol.max_retries + 1} consecutive attempts; "
                    f"last error: {e!r}") from e
            rec.note_retry(seam)
            rec.sleep_fn(min(pol.backoff_base_s * (2.0 ** attempt),
                             pol.backoff_max_s))
        else:
            if attempt:
                rec.note_recovered(seam)
            return out


def retry_io(fn: Callable, seam: str,
             policy: Optional[RetryPolicy] = None):
    """:func:`retry` scoped to ``OSError`` — the write seams' class."""
    return retry(fn, seam, retryable=(OSError,), policy=policy)
