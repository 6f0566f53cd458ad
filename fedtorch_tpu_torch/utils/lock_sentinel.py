"""Runtime lock-order sentinel (port of
``fedtorch_tpu/utils/lock_sentinel.py``), the dynamic half of the FTH
concurrency audit (``fedtorch_tpu_torch/lint/concurrency_audit.py``).

The static pass proves properties about lock-acquisition *syntax*; this
module checks the orders a live run actually takes. A scoped context
manager, inert in production, armed in tests and the host-chaos drill.

While armed, the sentinel installs the ``telemetry.faults.new_lock``
factory hook, so every host-plane mutex created inside its scope
(``JsonlWriter._mutex``/``_open_lock``/``_io_lock``,
``HostFaultInjector._lock``, ``HostRecovery._lock``,
``AsyncCheckpointer._gauges``) comes back wrapped in an
:class:`_InstrumentedLock` that records, per thread, the stack of locks
held at each acquisition; the threads that take them are the round
loop, the stall watchdog, the stream prefetcher and the async
checkpoint writer.

* **Re-entrant acquire** of a non-reentrant lock by the thread already
  holding it raises ``AssertionError`` *immediately*: the self-deadlock
  of an injector whose first-fire announce re-enters the events writer
  from inside its own flush becomes a test failure instead of a hang.
* **Order inversion** (acquiring ``B`` while holding ``A`` after some
  thread acquired ``A`` while holding ``B``) is recorded as a violation
  and raised at scope exit (``strict=True``, the default) or via
  :meth:`assert_clean`. Recording rather than raising keeps the first
  offending thread alive long enough to capture both sites.

Locks created *before* the sentinel armed can be adopted with
:meth:`watch`, which swaps the attribute for a wrapper and restores the
original on exit. Wrappers that outlive their sentinel degrade to plain
pass-through delegation.
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional, Tuple

from fedtorch_tpu_torch.telemetry import faults as _tel_faults

__all__ = ["LockOrderSentinel", "active_sentinel"]

_RLOCK_TYPE = type(threading.RLock())

# Sentinels currently armed, newest last.
_ACTIVE_SENTINELS: List["LockOrderSentinel"] = []


def active_sentinel() -> Optional["LockOrderSentinel"]:
    """The innermost armed sentinel, or None."""
    return _ACTIVE_SENTINELS[-1] if _ACTIVE_SENTINELS else None


class _InstrumentedLock:
    """Duck-typed ``threading.Lock`` that reports acquisitions to its
    sentinel. Once the sentinel disarms, every method is a plain
    delegation to the wrapped lock."""

    def __init__(self, inner, name: str, sentinel: "LockOrderSentinel",
                 reentrant: bool = False) -> None:
        self._inner = inner
        self.name = name
        self._sentinel = sentinel
        self._reentrant = reentrant

    def _armed(self) -> bool:
        return self._sentinel is not None and self._sentinel.armed

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        if self._armed():
            self._sentinel._before_acquire(self)
        got = self._inner.acquire(blocking, timeout)
        if got and self._armed():
            self._sentinel._after_acquire(self)
        return got

    def release(self) -> None:
        if self._armed():
            self._sentinel._on_release(self)
        self._inner.release()

    def locked(self) -> bool:
        return self._inner.locked()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, exc_type, exc, tb):
        self.release()
        return False

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"<_InstrumentedLock {self.name!r} inner={self._inner!r}>"


class LockOrderSentinel:
    """Scoped recorder of per-thread lock acquisition order.

    Usage (tests / host-chaos drill)::

        with LockOrderSentinel() as locks:
            run_experiment(cfg)          # locks created inside are wrapped
        # strict=True: __exit__ raised if any inversion was observed
        locks.assert_clean()             # idempotent, explicit form

    ``watch(obj, "attr", ...)`` adopts pre-existing lock attributes for
    the duration of the scope.
    """

    def __init__(self, strict: bool = True) -> None:
        self.strict = strict
        self.armed = False
        self.violations: List[str] = []
        # Directed acquired-after graph on lock *names*:
        # _edges[a][b] = description of the first site acquiring b while
        # holding a.
        self._edges: Dict[str, Dict[str, str]] = {}
        self._tls = threading.local()
        self._graph_mu = threading.Lock()
        self._watched: List[Tuple[object, str, object]] = []
        self._prev_hook = None
        # names of the locks made or adopted inside the scope
        self._names: List[str] = []

    # -- arming ---------------------------------------------------------

    def __enter__(self) -> "LockOrderSentinel":
        self.armed = True
        _ACTIVE_SENTINELS.append(self)
        self._prev_hook = _tel_faults.set_lock_hook(self._make_lock)
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        _tel_faults.set_lock_hook(self._prev_hook)
        for obj, attr, original in reversed(self._watched):
            setattr(obj, attr, original)
        self._watched.clear()
        if self in _ACTIVE_SENTINELS:
            _ACTIVE_SENTINELS.remove(self)
        self.armed = False
        if exc_type is None and self.strict:
            self.assert_clean()
        return False

    def _make_lock(self, name: str):
        with self._graph_mu:
            self._names.append(name)
        return _InstrumentedLock(threading.Lock(), name, self)

    def watch(self, obj, *attrs: str, name: Optional[str] = None
              ) -> "LockOrderSentinel":
        """Wrap existing lock attributes of ``obj`` (restored on exit)."""
        base = name or type(obj).__name__
        for attr in attrs:
            original = getattr(obj, attr)
            if isinstance(original, _InstrumentedLock):
                continue
            wrapper = _InstrumentedLock(
                original, f"{base}.{attr}", self,
                reentrant=isinstance(original, _RLOCK_TYPE))
            with self._graph_mu:
                self._names.append(wrapper.name)
            self._watched.append((obj, attr, original))
            setattr(obj, attr, wrapper)
        return self

    # -- recording ------------------------------------------------------

    def _held(self) -> List[_InstrumentedLock]:
        held = getattr(self._tls, "held", None)
        if held is None:
            held = []
            self._tls.held = held
        return held

    def _before_acquire(self, lock: _InstrumentedLock) -> None:
        if lock._reentrant:
            return
        for h in self._held():
            if h is lock:
                msg = (f"re-entrant acquire of {lock.name!r} on thread "
                       f"{threading.current_thread().name!r} while already "
                       f"holding it (held: {[x.name for x in self._held()]})"
                       " — a self-deadlock")
                self.violations.append(msg)
                # Raise NOW: letting the acquire proceed would hang the
                # process, which is exactly what this sentinel exists to
                # turn into a test failure.
                raise AssertionError("LockOrderSentinel: " + msg)

    def _after_acquire(self, lock: _InstrumentedLock) -> None:
        held = self._held()
        tname = threading.current_thread().name
        with self._graph_mu:
            for h in held:
                if h.name == lock.name:
                    continue
                site = f"thread {tname!r}: {h.name} -> {lock.name}"
                self._edges.setdefault(h.name, {}).setdefault(lock.name, site)
                if self._reaches(lock.name, h.name):
                    back = self._edges.get(lock.name, {}).get(h.name)
                    self.violations.append(
                        f"lock-order inversion: {site} but earlier "
                        f"{back or f'{lock.name} ..-> {h.name}'}")
        held.append(lock)

    def _on_release(self, lock: _InstrumentedLock) -> None:
        held = self._held()
        for i in range(len(held) - 1, -1, -1):
            if held[i] is lock:
                del held[i]
                return

    def _reaches(self, a: str, b: str) -> bool:
        """Path a ..-> b in the acquired-after graph (the caller holds
        _graph_mu)."""
        seen = set()
        stack = [a]
        while stack:
            node = stack.pop()
            if node == b:
                return True
            if node in seen:
                continue
            seen.add(node)
            stack.extend(self._edges.get(node, ()))
        return False

    # -- reporting ------------------------------------------------------

    def order_edges(self) -> Dict[str, List[str]]:
        """Observed acquired-after pairs: {held: [acquired, ...]}."""
        with self._graph_mu:
            return {a: sorted(bs) for a, bs in sorted(self._edges.items())}

    def lock_names(self) -> List[str]:
        """The distinct names of the locks made through the hook or
        adopted with :meth:`watch` inside the scope, sorted."""
        with self._graph_mu:
            return sorted(set(self._names))

    def assert_clean(self) -> None:
        """Raise if any inversion or re-entrant acquire was observed."""
        if self.violations:
            raise AssertionError(
                "LockOrderSentinel observed %d violation(s):\n  %s"
                % (len(self.violations), "\n  ".join(self.violations)))
