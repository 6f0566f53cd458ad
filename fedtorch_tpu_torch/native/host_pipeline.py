"""The host side of the streaming data plane (port of
``fedtorch_tpu/native/host_pipeline.py``): the row gather, cyclic index
padding and the background prefetcher.

The JAX package gathers through a C++ library it compiles with g++ on
first use (``pipeline.cpp``). The port builds no host library: its
gather is ATen's ``index_select``, which copies whole rows, runs on
several threads and releases the interpreter lock while it copies, and
which writes straight into a caller's buffer (the feed producer's pinned
host memory) through ``out=``. Its output is bitwise the output of numpy
fancy indexing.
"""
from __future__ import annotations

import queue
import threading
import time
from typing import Optional

import numpy as np
import torch


def gather_rows(src: torch.Tensor, idx, out: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
    """``out[k] = src[idx[k]]`` over leading-axis rows. ``src`` is a CPU
    tensor (a view of host memory or of a memory map); ``idx`` any
    integer array of row ids; ``out`` (optional) a contiguous
    ``[len(idx), ...]`` tensor of ``src``'s dtype to write into."""
    idx = torch.as_tensor(np.asarray(idx), dtype=torch.int64)
    if out is None:
        return torch.index_select(src, 0, idx)
    return torch.index_select(src, 0, idx, out=out)


def cyclic_pad_indices(idx: np.ndarray, n_out: int) -> np.ndarray:
    """``idx`` repeated cyclically to ``n_out`` entries, as int32."""
    idx = np.ascontiguousarray(idx, np.int32)
    reps = -(-n_out // len(idx))
    return np.tile(idx, reps)[:n_out]


class HostPrefetcher:
    """One daemon thread runs ``produce_fn(step)`` for step = 0, 1, ...
    into a bounded queue of ``depth`` items, so the next work item is
    built while the consumer works on the current one. A ``StopIteration``
    from ``produce_fn`` ends the stream (``next`` returns None)."""

    def __init__(self, produce_fn, depth: int = 2,
                 name: str = "host-prefetcher"):
        self._produce = produce_fn
        self.name = name
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        # the producer's exception, kept beside the queued copy: the
        # queue delivers it once, every later next() raises it again
        self._error: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._worker, daemon=True,
                                        name=name)
        self._thread.start()

    def _worker(self):
        step = 0
        while not self._stop.is_set():
            try:
                item = self._produce(step)
            except StopIteration:
                self._put(None)
                return
            except BaseException as e:  # handed to the consumer
                self._error = e
                self._put(e)
                return
            if not self._put(item):
                return  # closed while waiting for queue space
            step += 1

    def _put(self, item) -> bool:
        """A put that keeps watching the stop flag, so a worker parked on
        a full queue exits on close()."""
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def next(self, timeout: float = 60.0):
        """The next item. A producer that died raises its own exception
        (at once if it was already delivered); one that is alive but has
        produced nothing for ``timeout`` seconds raises TimeoutError."""
        deadline = time.monotonic() + timeout
        while True:
            try:
                item = self._q.get(timeout=min(
                    0.2, max(deadline - time.monotonic(), 0.01)))
            except queue.Empty:
                # the worker writes _error once, then exits
                if self._error is not None:
                    raise self._error
                if not self._thread.is_alive():
                    raise RuntimeError(
                        f"{self.name!r} producer thread exited without "
                        "delivering an item or an error")
                if time.monotonic() >= deadline:
                    raise TimeoutError(
                        f"{self.name!r} produced nothing for "
                        f"{timeout:.1f} s with its thread still alive")
                continue
            if isinstance(item, BaseException):
                raise item
            return item

    def alive(self) -> bool:
        """Whether the producer thread still runs."""
        return self._thread.is_alive()

    def depth(self) -> int:
        """Items buffered now (approximate: the worker appends
        concurrently)."""
        return self._q.qsize()

    def close(self, join_timeout: float = 5.0) -> bool:
        """Stop the producer and drop the queued items; True when the
        thread exited within ``join_timeout`` (False: it is still inside
        one ``produce_fn`` call and exits at its next put). Idempotent."""
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=join_timeout)
        return not self._thread.is_alive()
