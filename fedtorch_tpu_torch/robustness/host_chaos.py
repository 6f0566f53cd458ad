"""Deterministic host-plane fault injection (port of
``fedtorch_tpu/robustness/host_chaos.py``; docs/robustness.md "Host
plane").

The in-round chaos layer (``robustness/chaos.py``) covers the DEVICE
plane; this module covers everything that runs on host threads and
I/O paths around it: the stream-feed producer's gather and its copy to
the device, checkpoint atomic writes and the telemetry/health file
writers. Each of those is a named
**seam** (``config.HOST_FAULT_SEAMS``); an installed
:class:`HostFaultInjector` decides per check whether the seam fires —
raising the same exception class the real fault would (``OSError``
with ``ENOSPC`` for writes, ``RuntimeError`` for producer work),
stalling, or truncating the bytes about to land — so the recovery
layer (``robustness/host_recovery.py``) is exercised through its REAL
error handling, never a parallel test-only path.

Determinism: the fire decision for the n-th check at a seam is a pure
sha256 hash of ``(seed, seam, n)`` compared against the rate — no RNG
state, no wall clock — so a drill replays the exact fault schedule on
every run, and the bitwise-trajectory acceptance bar is meaningful. The
hash is the JAX package's, so one seed fires the same schedule on every
seam in both packages.

The JAX package's seventh seam, ``native.load``, fails the load of its
C++ gather library into a numpy fallback. The port has no native
library (``native/host_pipeline.py`` gathers with ``index_select``), so
nothing could fail there: arming that seam is refused by name
(:data:`UNPORTED_SEAMS`), never accepted as a drill that cannot fire.

Like the telemetry hub, the injector is an installable active
instance: library code calls the module-level helpers
(:func:`maybe_raise`, :func:`maybe_raise_io`, :func:`maybe_delay`,
:func:`maybe_truncate`), which no-op when nothing is installed. The
telemetry writers cannot import this package (they must stay
stdlib-only), so :meth:`HostFaultInjector.install` registers the check
hook with ``telemetry.faults`` instead.
"""
from __future__ import annotations

import errno
import hashlib
import time
from typing import Dict, Optional

from fedtorch_tpu_torch.config import HOST_FAULT_SEAMS
from fedtorch_tpu_torch.telemetry import faults as _tel_faults

#: seams of ``config.HOST_FAULT_SEAMS`` that have no counterpart in the
#: port, with the reason an armed drill is refused
UNPORTED_SEAMS = {
    "native.load": "the port has no native library to fail loading "
                   "(native/host_pipeline.py gathers with index_select)",
}

_active: Optional["HostFaultInjector"] = None


def get_active() -> Optional["HostFaultInjector"]:
    return _active


class HostFaultInjector:
    """Seeded, seam-scoped host-fault source.

    ``seams`` is the armed subset of :data:`HOST_FAULT_SEAMS`;
    ``rate`` the per-check fire probability; ``max_fires`` (>0) caps
    total fires per seam — the lever the producer-rebuild drill uses
    (rate 1.0 + a cap of retries+1 kills the producer exactly once and
    lets the rebuilt one through). Thread-safe: the producer thread,
    the async checkpoint worker and the main loop all check seams."""

    def __init__(self, seams, rate: float = 0.25, seed: int = 0,
                 delay_s: float = 0.02, max_fires: int = 0):
        seams = tuple(seams)
        for seam in seams:
            if seam not in HOST_FAULT_SEAMS:
                raise ValueError(
                    f"unknown host-fault seam {seam!r}; expected one "
                    f"of {HOST_FAULT_SEAMS}")
            if seam in UNPORTED_SEAMS:
                raise ValueError(f"host-fault seam {seam!r} is not "
                                 f"ported: {UNPORTED_SEAMS[seam]}")
        self.seams = frozenset(seams)
        self.rate = float(rate)
        self.seed = int(seed)
        self.delay_s = float(delay_s)
        self.max_fires = int(max_fires)
        self.checks: Dict[str, int] = {s: 0 for s in seams}
        self.fires: Dict[str, int] = {s: 0 for s in seams}
        self._announced: set = set()
        self._lock = _tel_faults.new_lock("HostFaultInjector._lock")

    @classmethod
    def from_config(cls, fault) -> Optional["HostFaultInjector"]:
        """Build from a finalized ``FaultConfig``; None when unarmed."""
        if not fault.host_chaos_enabled:
            return None
        return cls(fault.host_fault_seam_tuple,
                   rate=fault.host_fault_rate,
                   seed=fault.host_fault_seed,
                   delay_s=fault.host_fault_delay_s,
                   max_fires=fault.host_fault_max)

    # -- lifecycle ------------------------------------------------------
    def install(self) -> "HostFaultInjector":
        global _active
        _active = self
        if "telemetry.write" in self.seams:
            _tel_faults.set_check_hook(self._telemetry_check)
        return self

    def uninstall(self) -> None:
        """Idempotent, and a no-op when ANOTHER injector has since
        installed — a stale run's cleanup must not disarm the live
        run's hooks."""
        global _active
        if _active is self:
            _active = None
            _tel_faults.set_check_hook(None)

    # -- the decision ---------------------------------------------------
    def fire(self, seam: str) -> bool:
        """True when the seam's next check fires. The draw is
        ``sha256(seed:seam:n)`` against ``rate`` — pure, replayable,
        independent across seams."""
        if seam not in self.seams:
            return False
        with self._lock:
            n = self.checks[seam]
            self.checks[seam] = n + 1
            if self.max_fires and self.fires[seam] >= self.max_fires:
                return False
            digest = hashlib.sha256(
                f"{self.seed}:{seam}:{n}".encode()).digest()
            fired = int.from_bytes(digest[:8], "big") < self.rate * 2**64
            if fired:
                self.fires[seam] += 1
                announce = seam not in self._announced
                self._announced.add(seam)
            else:
                announce = False
        if announce:
            # one event per seam per run, at the first injection — the
            # marker the fault-matrix (and monitors) key on, mirroring
            # chaos.byzantine_attack
            try:
                from fedtorch_tpu_torch import telemetry
                telemetry.event("chaos.host_fault", seam=seam,
                                rate=self.rate, seed=self.seed)
            except Exception:
                pass  # an event must never turn a drill into a crash
        return fired

    def total_fires(self) -> int:
        with self._lock:
            return sum(self.fires.values())

    def fire_counts(self) -> Dict[str, int]:
        """Locked per-seam snapshot (the producer thread may still be
        finishing an in-flight fire when a run-end reader iterates)."""
        with self._lock:
            return dict(self.fires)

    def stats(self) -> dict:
        """Injector gauges for the telemetry round row."""
        return {"host_faults": float(self.total_fires())}

    # -- telemetry hook (registered via telemetry.faults) ---------------
    def _telemetry_check(self, seam: str) -> None:
        if self.fire(seam):
            raise OSError(errno.ENOSPC,
                          f"injected host fault at seam {seam!r}")


# -- module-level seam helpers (no-ops when nothing is installed) --------
def fire(seam: str) -> bool:
    inj = _active
    return inj.fire(seam) if inj is not None else False


def maybe_raise(seam: str) -> None:
    """Producer-work seams: raise the transient-failure class."""
    if fire(seam):
        raise RuntimeError(f"injected host fault at seam {seam!r}")


def maybe_raise_io(seam: str) -> None:
    """Write seams: raise what a full disk raises."""
    if fire(seam):
        raise OSError(errno.ENOSPC,
                      f"injected host fault at seam {seam!r}")


def maybe_delay(seam: str) -> None:
    """Stall seams: sleep the injector's configured delay."""
    inj = _active
    if inj is not None and inj.delay_s > 0.0 and inj.fire(seam):
        time.sleep(inj.delay_s)


def maybe_truncate(seam: str, data: bytes) -> bytes:
    """Torn-write seams: hand back a truncated payload that LANDS —
    simulating a partial write the OS reported complete. The
    checkpoint integrity frame exists to catch exactly this."""
    if fire(seam) and len(data) > 1:
        return data[:len(data) // 2]
    return data
