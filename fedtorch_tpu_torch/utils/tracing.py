"""Profiling and tracing (port of ``fedtorch_tpu/utils/tracing.py``), and
the synchronization sentinel.

The hand timers (``utils/meters.py``) see phases; a profiler trace sees
inside one round. :func:`capture_round_trace` runs a round under
``torch.profiler`` (CUDA activity only on the card: with CPU activity
the profiler's processing took minutes on a round's ~100,000 launches;
CPU ops on a CPU run), drains it inside the window and writes a Chrome
trace that ``fedtorch_tpu_torch.tools.trace_attrib`` attributes to the
JAX package's device-time categories. :func:`profile_window` is the same
capture for rounds of several hundred thousand launches: it keeps the
raw kineto events in memory and writes no JSON (``key_averages()`` took
133 s on DenseNet-BC-100's 462,561 launches; summing the raw records
takes seconds).

:class:`SyncSentinel` is the port's runtime guard of the round's
contract. The JAX package guards it with ``RecompilationSentinel`` (a
traced program is traced once) and the program audit's FTP002 (no host
transfer inside the program). Eager torch never retraces and lowers no
program, so neither has a meaning here, nor do ``instrument_trace``,
``record_trace_event`` and ``trace_counts``, which count traces. What
stands for them is a scoped count of the synchronizing CUDA calls the
round makes, each named by the innermost frame of this package that
made it. It arms ``torch.cuda.set_sync_debug_mode("warn")``, which does
not report every sync: an explicit ``torch.cuda.synchronize()``
(``cudaDeviceSynchronize``) raises no warning.
:meth:`ProfileWindow.runtime_syncs` counts the synchronizing CUDA
runtime calls a profile recorded, which no warning feeds: each warning
precedes one ``cudaStreamSynchronize``, and the other calls, the
window's own drains left out, are the syncs the debug mode missed.
"""
from __future__ import annotations

import contextlib
import os
import socket
import sys
import time
import warnings
from collections import Counter
from typing import Callable, Dict, Optional

import torch

# the sync debug mode's warning text (c10/cuda/CUDAFunctions.h)
SYNC_WARNING = "called a synchronizing CUDA operation"
# the CUDA runtime calls that block the host until the device is done
RUNTIME_SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
                      "cudaEventSynchronize", "cudaMemcpy")
# the call under every sync-debug warning (c10's ``stream_synchronize``
# and ``memcpy_and_sync`` warn, then make it)
WARNED_SYNC_CALL = "cudaStreamSynchronize"
# the cudaDeviceSynchronize calls a CUDA window records of its own: the
# opening edge's, the closing drain and edge's, and the profiler's at
# its stop (torch.autograd.profiler's ``__exit__``)
WINDOW_DRAINS = 4

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_REPO_DIR = os.path.dirname(_PKG_DIR)
_THIS_FILE = os.path.abspath(__file__)
# device-side kineto activity kinds
DEVICE_ACTIVITIES = ("kernel", "gpu_memcpy", "gpu_memset")
# the host-time margin a CUDA window keeps at each edge, so that every
# device record of the work inside falls within it
_EDGE_S = 0.05
# the empty kernels (``torch.cuda._sleep``) a CUDA window launches at
# each edge: the profiler loses up to ~60 records at a window's start
# (and at times its last), and these are the ones it loses; they are
# left out of the window's records
PAD_LAUNCHES = 256
PAD_KERNEL = "spin_kernel"


def _pad_edge() -> None:
    for _ in range(PAD_LAUNCHES):
        torch.cuda._sleep(1)
    torch.cuda.synchronize()
    time.sleep(_EDGE_S)


def _activity(e) -> Optional[str]:
    """A kineto record's activity kind (``kernel``, ``cpu_op``, ...);
    None where the torch build's records do not report it."""
    kind = getattr(e, "activity_type", None)
    return kind() if kind is not None else None


def on_device(e) -> bool:
    """Is this kineto record a device activity (a kernel, memcpy or
    memset) rather than a host call?"""
    return "CUDA" in str(e.device_type()) \
        or _activity(e) in DEVICE_ACTIVITIES


def _device_test(evs):
    """``on_device`` for a window's records, with the CUDA device type
    looked up once (a string test a record costs a second on a round's
    100,000 launches)."""
    if not evs:
        return on_device
    kind = type(evs[0].device_type())
    cuda = getattr(kind, "CUDA", None)
    if cuda is None or hasattr(evs[0], "activity_type"):
        return on_device
    return lambda e: e.device_type() == cuda


def _cuda_in_use(device=None) -> bool:
    if device is not None:
        return torch.device(device).type == "cuda"
    return torch.cuda.is_available()


def _activities(device=None) -> list:
    from torch.profiler import ProfilerActivity
    return [ProfilerActivity.CUDA] if _cuda_in_use(device) \
        else [ProfilerActivity.CPU]


def _first_tensor(out):
    if isinstance(out, torch.Tensor):
        return out
    if isinstance(out, dict):
        out = list(out.values())
    elif hasattr(out, "__dataclass_fields__"):
        out = [getattr(out, f) for f in out.__dataclass_fields__]
    if isinstance(out, (list, tuple)):
        for v in out:
            t = _first_tensor(v)
            if t is not None:
                return t
    return None


def fetch_sync(out):
    """Wait for ``out`` (a tensor, or a dict, dataclass, list or tuple
    holding tensors) by fetching one element of its first tensor, and
    return it (None when ``out`` holds no non-empty tensor; a CUDA
    device is then synchronized). The drain for timing and tracing
    windows: the stream runs in order, so the fetched element's copy
    waits for every launch before it."""
    t = _first_tensor(out)
    if t is None or t.numel() == 0:
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()
        return None
    # lint: disable=FTL001 — this one-element fetch IS the sync
    return t.reshape(-1)[0].item()


def annotate(name: str):
    """A named range inside a trace (``torch.profiler.record_function``)."""
    return torch.profiler.record_function(name)


class ProfileWindow:
    """The records of one profiled window, read in memory.
    :meth:`open` starts one (pending device work drained first, so the
    window holds what follows alone) and :meth:`close` ends it; a window
    may span calls, as a round loop's callback sees them."""

    def __init__(self, prof, trace_path: Optional[str] = None,
                 cuda: bool = False):
        self.prof = prof
        self.trace_path = trace_path
        self.cuda = cuda
        self._events = None
        self._sums = None

    @classmethod
    def open(cls, device=None) -> "ProfileWindow":
        """Start profiling: CUDA activity only when ``device`` is a CUDA
        device, or by default when CUDA is available; CPU ops
        otherwise. A CUDA window opens through the profiler's warm-up
        step (one small kernel, then ``step()``) and pads each edge with
        :data:`PAD_LAUNCHES` empty kernels and ``_EDGE_S`` of host time:
        late in a long process the profiler lost a transformer round's
        first ~60 records (its first flash launch among them) on every
        try, margin and warm-up notwithstanding, and at times a round's
        last ones (the quantizer's)."""
        from torch.profiler import profile, schedule
        cuda = _cuda_in_use(device)
        if not cuda:
            prof = profile(activities=_activities(device))
            prof.start()
            return cls(prof, cuda=False)
        torch.cuda.synchronize()
        prof = profile(activities=_activities(device),
                       schedule=schedule(wait=0, warmup=1, active=1))
        prof.start()
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()
        prof.step()
        _pad_edge()
        return cls(prof, cuda=True)

    def close(self, log_dir: Optional[str] = None) -> "ProfileWindow":
        """Stop profiling (the device drained first) and, with
        ``log_dir``, write the Chrome trace there."""
        try:
            if self.cuda:
                torch.cuda.synchronize()
                _pad_edge()
        finally:
            self.prof.stop()
        if log_dir is not None:
            os.makedirs(log_dir, exist_ok=True)
            self.trace_path = _trace_file(log_dir)
            self.prof.export_chrome_trace(self.trace_path)
        return self

    def kineto_events(self) -> list:
        if self._events is None:
            self._events = list(self.prof.profiler.kineto_results.events())
        return self._events

    def sums(self) -> Dict:
        """``{(on_device, name): (ms, count)}`` over the raw records, in
        one pass of three reads a record: the sums ``key_averages()``
        gives for kernels and runtime calls (they have no children),
        without building an event object a record (the big-round path:
        ``key_averages()`` took 133 s on 462,561 launches)."""
        if self._sums is None:
            evs = self.kineto_events()
            dev = _device_test(evs)
            sums = {}
            for e in evs:
                d = dev(e)
                name = e.name()
                if d and PAD_KERNEL in name:
                    continue  # the window's own edge padding
                key = (d, name)
                ms, n = sums.get(key, (0.0, 0))
                sums[key] = (ms + e.duration_ns() / 1e6, n + 1)
            self._sums = sums
        return self._sums

    def runtime_syncs(self) -> Dict[str, int]:
        """Count of each synchronizing CUDA runtime call recorded, their
        ``total``, and ``unwarned``: those the sync debug mode does not
        report (every one but :data:`WARNED_SYNC_CALL`), a CUDA window's
        own :data:`WINDOW_DRAINS` left out."""
        sums = self.sums()
        n = {name: sums.get((False, name), (0.0, 0))[1]
             for name in RUNTIME_SYNC_CALLS}
        n["total"] = sum(n.values())
        n["unwarned"] = n["total"] - n[WARNED_SYNC_CALL] \
            - (WINDOW_DRAINS if self.cuda else 0)
        return n

    def memcpy_counts(self) -> Dict[str, int]:
        """Device-side memcpy records by direction."""
        n = {"dtoh": 0, "htod": 0}
        for (dev, name), (_, count) in self.sums().items():
            if not dev:
                continue
            if name.startswith("Memcpy DtoH"):
                n["dtoh"] += count
            elif name.startswith("Memcpy HtoD"):
                n["htod"] += count
        return n


def _trace_file(log_dir: str) -> str:
    return os.path.join(log_dir, f"{socket.gethostname()}.{os.getpid()}"
                                 ".trace.json")


def profile_window(fn: Callable, *args, device=None,
                   log_dir: Optional[str] = None):
    """``(fn(*args), ProfileWindow)``: ``fn`` run in a
    :meth:`ProfileWindow.open` window, its result drained inside it by
    :func:`fetch_sync`. With ``log_dir`` the window is a
    ``profiler.capture`` telemetry span carrying ``log_dir`` (so the
    trace lines up with the run's host spans) and its Chrome trace is
    written there: a capture directory for
    ``python -m fedtorch_tpu_torch.tools.trace_attrib``."""
    from fedtorch_tpu_torch import telemetry
    span = telemetry.span("profiler.capture", log_dir=log_dir) \
        if log_dir is not None else contextlib.nullcontext()
    with span:
        window = ProfileWindow.open(device)
        try:
            out = fn(*args)
            fetch_sync(out)
        finally:
            window.close(log_dir)
    return out, window


class Watch:
    """A profiler window around a :class:`SyncSentinel` scope, opened on
    construction (pending device work drained first) and read by
    :meth:`close`, which drains the device outside the sentinel's scope
    (a drain is not the watched work's sync). A watch may span calls, as
    a round loop's callback sees them."""

    def __init__(self, device=None):
        self.window = ProfileWindow.open(device)
        self.sentinel = SyncSentinel().__enter__()

    def close(self) -> Dict:
        """The watched work's numbers: the sentinel's synchronizing CUDA
        calls (``syncs``, charged to ``sync_sites``), the profiler's
        synchronizing runtime calls beside them (:meth:`ProfileWindow.
        runtime_syncs`: on a card, as many ``cudaStreamSynchronize`` as
        ``syncs`` and no ``unwarned`` call when the debug mode saw every
        sync), its memcpy records by direction, its quantizer kernels and
        its kernel launches (memcpys and memsets not counted)."""
        from fedtorch_tpu_torch.tools.trace_attrib import hand_kernel
        try:
            self.sentinel.__exit__(None, None, None)
        finally:
            self.window.close()
        s, n = self.sentinel, self.window.memcpy_counts()
        dev = [(name, c) for (d, name), (_, c) in self.window.sums().items()
               if d]
        n["quantizer"] = sum(c for name, c in dev
                             if (hand_kernel(name) or "").startswith("qdq_"))
        n["kernel_launches"] = sum(
            c for name, c in dev if not name.startswith(("Memcpy", "Memset")))
        n.update(syncs=s.count(), runtime_syncs=self.window.runtime_syncs(),
                 sync_sites=[dict(site=site, function=s.function_of(site),
                                  count=c) for site, c in s.sites().items()])
        return n


def watch(fn: Callable, *args, device=None):
    """``(fn(*args), Watch numbers)``: ``fn`` run in a :class:`Watch`."""
    w = Watch(device)
    try:
        out = fn(*args)
    finally:
        numbers = w.close()
    return out, numbers


def capture_round_trace(log_dir: str, fn: Callable, *args, device=None):
    """Run ``fn(*args)`` under the profiler with a Chrome trace written
    into ``log_dir`` and return its result: the capture hook for a round
    (:func:`profile_window` with ``log_dir``). The result is drained
    inside the window: a trace stopped before the stream finishes
    records the launches, not the work."""
    return profile_window(fn, *args, device=device, log_dir=log_dir)[0]


@contextlib.contextmanager
def trace(log_dir: str, device=None):
    """Context manager: profile everything inside, written to
    ``log_dir`` as a Chrome trace at exit."""
    window = ProfileWindow.open(device)
    try:
        yield window
    finally:
        window.close(log_dir)


def device_memory_stats() -> dict:
    """Per-card allocator summary (``torch.cuda.memory_stats``): bytes in
    use, their peak since the last reset, and bytes reserved; empty
    without CUDA."""
    stats = {}
    if not torch.cuda.is_available():
        return stats
    for i in range(torch.cuda.device_count()):
        s = torch.cuda.memory_stats(i)
        stats[f"cuda:{i}"] = {
            "bytes_in_use": s.get("allocated_bytes.all.current"),
            "peak_bytes_in_use": s.get("allocated_bytes.all.peak"),
            "bytes_reserved": s.get("reserved_bytes.all.current"),
        }
    return stats


def live_buffer_summary() -> dict:
    """The bytes the CUDA caching allocator holds for live tensors
    (``torch.cuda.memory_allocated`` summed over the cards: a host
    counter, no sync). ``total_bytes`` is None without CUDA: the CPU
    allocator keeps no such counter. ``by_shape`` stays empty: eager
    torch keeps no registry of live tensors (the JAX package walks
    ``jax.live_arrays()``), and a walk of every Python object is not
    cheap enough for a metrics row."""
    total = sum(torch.cuda.memory_allocated(i)
                for i in range(torch.cuda.device_count())) \
        if torch.cuda.is_available() else None
    return {"total_bytes": total, "by_shape": {}}


def _site_of(frame):
    """``("path:line", function)`` of the innermost frame that lies in
    this package (this module excepted), the path repo-relative; else
    the innermost frame outside torch and the warnings machinery, its
    site marked ``(outside the port)``."""
    outside = None
    f = frame
    while f is not None:
        path = os.path.abspath(f.f_code.co_filename)
        if path.startswith(_PKG_DIR + os.sep) and path != _THIS_FILE:
            rel = os.path.relpath(path, _REPO_DIR).replace(os.sep, "/")
            return f"{rel}:{f.f_lineno}", f.f_code.co_name
        if outside is None and path != _THIS_FILE \
                and f"{os.sep}torch{os.sep}" not in path \
                and not path.endswith(f"{os.sep}warnings.py"):
            outside = (f"(outside the port) {path}:{f.f_lineno}",
                       f.f_code.co_name)
        f = f.f_back
    return outside or ("(outside the port) ?", "?")


class SyncSentinel:
    """Scoped count of synchronizing CUDA calls, by the site that made
    them.

    ::

        with SyncSentinel() as s:
            server, clients, m = trainer.run_round(server, clients)
        s.assert_syncs(0)       # raises, listing the sites, when any

    On entry it arms ``torch.cuda.set_sync_debug_mode("warn")`` (when
    CUDA is available and ``arm`` is true) and shows the debug mode's
    warnings once each; every one is charged to the innermost frame of
    this package on the stack at warning time (the warning's own
    location is inside torch), or to the innermost frame outside torch
    where none is. The mode goes back to
    0 and the warning filters are restored on exit, an exception
    included. Warnings of other kinds pass through to the handler that
    was there before."""

    def __init__(self, arm: bool = True):
        self.arm = arm
        self._sites: Counter = Counter()
        self._functions: Dict[str, str] = {}
        self._catch = None
        self._prev_show = None
        self._armed_cuda = False

    def __enter__(self) -> "SyncSentinel":
        self._catch = warnings.catch_warnings()
        self._catch.__enter__()
        warnings.filterwarnings("always", message=".*" + SYNC_WARNING)
        self._prev_show = warnings.showwarning
        warnings.showwarning = self._show
        if self.arm and torch.cuda.is_available():
            torch.cuda.set_sync_debug_mode("warn")
            self._armed_cuda = True
        return self

    def __exit__(self, *exc) -> None:
        try:
            if self._armed_cuda:
                torch.cuda.set_sync_debug_mode(0)
                self._armed_cuda = False
        finally:
            self._catch.__exit__(*exc)

    def _show(self, message, category, filename, lineno, file=None,
              line=None):
        if SYNC_WARNING not in str(message):
            self._prev_show(message, category, filename, lineno, file, line)
            return
        site, function = _site_of(sys._getframe(1))
        self._sites[site] += 1
        self._functions.setdefault(site, function)

    def count(self) -> int:
        """Synchronizing calls reported, each charged to a site."""
        return sum(self._sites.values())

    def sites(self) -> Dict[str, int]:
        """``{"path:line": count}``, most frequent first."""
        return dict(self._sites.most_common())

    def function_of(self, site: str) -> str:
        return self._functions.get(site, "?")

    def assert_syncs(self, expected: int) -> None:
        got = self.count()
        if got != expected:
            raise AssertionError(
                f"{got} synchronizing CUDA call(s), expected {expected}: "
                + ", ".join(f"{s} ({self.function_of(s)}) x{n}"
                            for s, n in self.sites().items()))
