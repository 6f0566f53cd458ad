"""Checkpoint / resume (port of ``fedtorch_tpu/utils/checkpoint.py``).

As in the JAX package the FULL round state is written — the server's
params, optimizer state and aux, the round counter and the generator the
round plans are drawn from, and every client's state — so a resumed run
continues exactly, bitwise, where the reference's checkpoint of the
server model alone (logs/checkpoint.py:68-82) loses the client aux.

Kept as the JAX package has it:

* the run directory (:func:`init_checkpoint_dir`, checkpoint.py:12-45's
  hyperparam-encoding name, or ``--run_dir`` exactly);
* the ``FTCK1`` integrity frame: magic, 8-byte big-endian payload
  length, sha256, payload, in one file (the JAX package's
  ``_unframe_payload``, ``frame_quick_ok`` and ``collect_round_keeps``
  read the port's files);
* :func:`_atomic_write`: tmp, fsync, rename, under the bounded
  ``ckpt.write`` retry, with the ``ckpt.torn`` drill seam;
* the per-round keeps ``checkpoint_r{N}.ckpt`` with ``keep_last_n``
  retention, and ``model_best``;
* :func:`_compat_meta` and its refusals on resume;
* :class:`AsyncCheckpointer`: its drain, its ``atexit`` close and its
  degraded (synchronous) mode;
* :func:`maybe_resume`, which skips corrupt and torn files.

The payload is the port's own: ``torch.save`` of plain dicts and lists of
host tensors and ints (``{"format", "server": {"params", "opt", "aux",
"round", "rng_state"}, "clients": {"params", "opt", "aux", "epoch",
"local_index"}}``), read back with ``torch.load(weights_only=True)`` and
copied into a freshly initialized state of the same structure. The
server's generator is ``server.rng.get_state()``. A JAX payload (flax
msgpack, with a threefry key where the port keeps a ``torch.Generator``)
cannot continue the port's draws: it is refused by name, never loaded
and continued with other draws.

Where trouble lies, and what the module does about it:

* **The round writes client state in place** (``core/state.py``), where
  the JAX round is functional. A snapshot that aliased live memory would
  be rewritten by the next round while the async writer serializes it —
  a torn checkpoint whose sha256 frame is computed over the torn bytes
  and so verifies. :func:`_snapshot` therefore makes an OWNING host copy
  before ``save`` returns: device tensors are copied into pinned host
  memory on the current stream, an event is recorded after the copies
  and waited on (the JAX package's ``_owning_host_copy``); CPU tensors
  are cloned.
* **Sharded client state.** On several ranks each holds its own rows of
  the client trees (``parallel/mesh.py`` ``owned_client_rows``). The
  snapshot is then a collective, as the JAX package's ``_snapshot`` is:
  every rank calls :func:`save_checkpoint` (and
  :meth:`AsyncCheckpointer.save`), one ``gather`` brings every rank's
  rows to rank 0 (:func:`_gather_clients`), and rank 0 alone writes the
  whole real ``[C]`` state, the padding left out. The file is the same
  as one process writes: it loads in one process, and a resume on any
  number of ranks keeps each rank's own rows of it
  (:func:`_owned_clients`).
* **Size.** At the ResNet-20 main path the client state is 100 clients
  x (params + 2 momentum buffers) x 272,474 x 4 B ≈ 327 MB; a sync save
  is that copy, one ``torch.save`` into memory, one sha256 pass and one
  write + fsync: ``checkpoint.ckpt``, ``model_best.ckpt`` and the round's
  keep hold the same frame, so the first is written and the others are
  hard links to it (each a tmp link renamed into place; a file the
  ``ckpt.torn`` seam tears is written on its own).
"""
from __future__ import annotations

import atexit
import dataclasses
import errno
import hashlib
import io
import json
import os
import re
import time
import warnings
from typing import Optional, Tuple

import torch

from fedtorch_tpu_torch import telemetry
from fedtorch_tpu_torch.config import ExperimentConfig
from fedtorch_tpu_torch.core.state import (
    ClientState, ServerState, tree_fill, tree_leaves,
)
from fedtorch_tpu_torch.telemetry import faults as _tel_faults

#: the payload's format tag (the JAX package's payload is flax msgpack)
PAYLOAD_FORMAT = "fedtorch_tpu_torch.checkpoint/v1"


def get_checkpoint_folder_name(cfg: ExperimentConfig) -> str:
    """Hyperparam-encoding run directory name (checkpoint.py:12-45)."""
    fed = cfg.federated
    parts = [
        time.strftime("%Y-%m-%d_%H-%M-%S"),
        f"l2-{cfg.optim.weight_decay}",
        f"lr-{cfg.optim.lr}",
        f"momentum-{cfg.optim.in_momentum_factor}",
        f"batchsize-{cfg.data.batch_size}",
        f"arch-{cfg.model.arch}",
        f"data-{cfg.data.dataset}",
    ]
    if fed.federated:
        parts += [f"alg-{cfg.effective_algorithm}",
                  f"clients-{fed.num_clients}",
                  f"rate-{fed.online_client_rate}"]
    return "_".join(parts)


def init_checkpoint_dir(cfg: ExperimentConfig) -> str:
    """Run directory, which holds the log (``record0``), the telemetry
    files and the checkpoints. ``checkpoint.run_dir`` (when set) is used
    EXACTLY — an elastically restarted process must land in the same
    directory as the attempt it resumes (robustness/harness.py
    relaunches with ``--resume <this dir>``); else
    ``<checkpoint>/<dataset>/<arch>/<time>_l2-..._lr-..._...``."""
    if cfg.checkpoint.run_dir:
        os.makedirs(cfg.checkpoint.run_dir, exist_ok=True)
        return cfg.checkpoint.run_dir
    root = os.path.join(cfg.checkpoint.checkpoint_dir, cfg.data.dataset,
                        cfg.model.arch, get_checkpoint_folder_name(cfg))
    os.makedirs(root, exist_ok=True)
    return root


def _compat_meta(cfg: ExperimentConfig) -> dict:
    return {
        "dataset": cfg.data.dataset,
        "batch_size": cfg.data.batch_size,
        "arch": cfg.model.arch,
        "num_epochs": cfg.train.num_epochs,
        "algorithm": cfg.effective_algorithm,
        "num_clients": cfg.federated.num_clients,
        "sync_mode": cfg.federated.sync_mode,
        # the server aux wraps the norm_bound momentum and the DP noise
        # scale: a structural incompatibility either way
        "robust_momentum": cfg.fault.robust_agg == "norm_bound",
        "dp_aggregation": cfg.fault.dp_armed,
    }


# -- the payload: plain containers of host tensors --------------------------
def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _plain(tree, copy):
    """``tree`` as dicts, lists and leaves (``torch.load(weights_only=
    True)`` reads no NamedTuple): a NamedTuple becomes the dict of its
    fields, a tuple a list, a tensor ``copy(tensor)``."""
    if isinstance(tree, dict):
        return {k: _plain(v, copy) for k, v in tree.items()}
    if _is_namedtuple(tree):
        return {f: _plain(getattr(tree, f), copy) for f in tree._fields}
    if isinstance(tree, (tuple, list)):
        return [_plain(v, copy) for v in tree]
    if isinstance(tree, torch.Tensor):
        return copy(tree)
    return tree


def _graft(template, plain, where: str = "", write: bool = True):
    """``plain`` (a :func:`_plain` payload) copied into the structure of
    ``template``: tensors in place (``template.copy_``, so a resumed
    client state costs no second copy on the card), other leaves taken
    from the payload. Raises ``ValueError`` naming the first leaf whose
    structure, shape or dtype differs; ``write=False`` only checks."""
    if isinstance(template, dict) or _is_namedtuple(template):
        keys = list(template) if isinstance(template, dict) \
            else list(template._fields)
        if not isinstance(plain, dict) or sorted(plain) != sorted(keys):
            raise ValueError(f"checkpoint structure differs at {where or '/'}"
                             f": {sorted(plain) if isinstance(plain, dict) else type(plain).__name__} "
                             f"vs {sorted(keys)}")
        out = {k: _graft(template[k] if isinstance(template, dict)
                         else getattr(template, k), plain[k],
                         f"{where}/{k}", write) for k in keys}
        return out if isinstance(template, dict) else type(template)(**out)
    if isinstance(template, (tuple, list)):
        if not isinstance(plain, list) or len(plain) != len(template):
            raise ValueError(f"checkpoint structure differs at {where}")
        return type(template)(_graft(t, p, f"{where}/{i}", write)
                              for i, (t, p) in enumerate(zip(template,
                                                             plain)))
    if isinstance(template, torch.Tensor):
        if not isinstance(plain, torch.Tensor) \
                or plain.shape != template.shape \
                or plain.dtype != template.dtype:
            got = (tuple(plain.shape), plain.dtype) \
                if isinstance(plain, torch.Tensor) else type(plain).__name__
            raise ValueError(f"checkpoint leaf {where} is {got}, the run's "
                             f"{(tuple(template.shape), template.dtype)}")
        if write:
            with torch.no_grad():
                template.copy_(plain)
        return template
    return plain


_SHARDED = ("params", "opt", "aux")


def _gather_clients(clients: ClientState, num_clients: int):
    """The whole real ``[C]`` client state on rank 0, from every rank's
    rows of the sharded trees (``params``, ``opt``, ``aux``): one
    ``gather`` of each rank's rows as raw bytes (staged through pinned
    host memory on gloo); ``epoch`` and ``local_index`` are replicated
    and taken as they are. A collective: every rank calls it; None on
    the other ranks."""
    import torch.distributed as dist
    from fedtorch_tpu_torch.parallel.mesh import rank, world_size
    from fedtorch_tpu_torch.parallel.podscale import (
        bytes_as_rows, host_staged, rows_as_bytes,
    )
    trees = [getattr(clients, f) for f in _SHARDED]
    leaves = [t for tree in trees for t in tree_leaves(tree)]
    per = leaves[0].shape[0]
    with torch.no_grad():
        buf = host_staged(rows_as_bytes(leaves, per).reshape(-1),
                          dist.group.WORLD)
    W = world_size()
    parts = [torch.empty_like(buf) for _ in range(W)] \
        if rank() == 0 else None
    dist.gather(buf, parts, dst=0)
    if parts is None:
        return None
    whole = torch.cat(parts).reshape(W * per, -1)[:num_clients].cpu()
    it = iter(bytes_as_rows(whole, [(t.shape[1:], t.dtype)
                                    for t in leaves]))
    full = {f: tree_fill(tree, it) for f, tree in zip(_SHARDED, trees)}
    return clients._replace(**full)


def _client_state_sharded() -> bool:
    """Whether the client trees are sharded over ranks: on every
    multi-rank run (``parallel/mesh.py``)."""
    from fedtorch_tpu_torch.parallel.mesh import world_size
    return world_size() > 1


def _snapshot(server: ServerState, clients: ClientState,
              num_clients: Optional[int] = None) -> Optional[dict]:
    """The serializable round state as an OWNING host copy (see the
    module docstring): device tensors copied into pinned host memory on
    the current stream, then an event after the copies is waited on, so
    the next round may rewrite the state in place as soon as this
    returns; CPU tensors cloned. With the client state sharded over
    ranks it is a collective (:func:`_gather_clients`, ``num_clients``
    the real client count) and only rank 0 gets the state (None
    elsewhere)."""
    if _client_state_sharded():
        clients = _gather_clients(clients, num_clients)
        if clients is None:
            return None
    events = {}

    def copy(x):
        if x.device.type == "cuda":
            out = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
            out.copy_(x.detach(), non_blocking=True)
            events.setdefault(x.device, None)
            return out
        return x.detach().clone()

    state = {
        "format": PAYLOAD_FORMAT,
        "server": {"params": _plain(server.params, copy),
                   "opt": _plain(server.opt, copy),
                   "aux": _plain(server.aux, copy),
                   "round": int(server.round),
                   "rng_state": server.rng.get_state()},
        "clients": _plain(clients, copy),
    }
    for device in events:
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(device))
        ev.synchronize()
    return state


def _to_bytes(host_state: dict) -> memoryview:
    """The ``torch.save`` payload, as a view of its buffer (no copy)."""
    buf = io.BytesIO()
    torch.save(host_state, buf)
    return buf.getbuffer()


# self-describing checkpoint framing: magic + payload length + sha256
# prepended to the payload in the SAME file, so the integrity record can
# never go stale relative to its payload, and every per-round keep
# carries its own (the JAX package's frame, byte for byte)
_CKPT_MAGIC = b"FTCK1\x00"
_CKPT_LEN_OFF = len(_CKPT_MAGIC)
_CKPT_DIGEST_OFF = _CKPT_LEN_OFF + 8
_CKPT_HEADER = _CKPT_DIGEST_OFF + 32


def _frame_header(payload) -> bytes:
    return (_CKPT_MAGIC + len(payload).to_bytes(8, "big")
            + hashlib.sha256(payload).digest())


def _frame_want_len(head: bytes) -> int:
    """The payload length a frame header claims (``head`` must hold at
    least ``_CKPT_HEADER`` bytes)."""
    return int.from_bytes(head[_CKPT_LEN_OFF:_CKPT_DIGEST_OFF], "big")


def _unframe_payload(blob: bytes):
    """Returns (payload, why_corrupt). ``why_corrupt`` is None for a
    verified frame AND for unframed blobs (no record to check —
    deserialization is their only guard)."""
    if not blob.startswith(_CKPT_MAGIC):
        return blob, None
    if len(blob) < _CKPT_HEADER:
        return None, "truncated header"
    want_len = _frame_want_len(blob)
    digest = blob[_CKPT_DIGEST_OFF:_CKPT_HEADER]
    payload = blob[_CKPT_HEADER:]
    if len(payload) != want_len:
        return None, (f"{len(payload)} payload bytes on disk, expected "
                      f"{want_len} (truncated write?)")
    if hashlib.sha256(payload).digest() != digest:
        return None, "sha256 mismatch (bit rot or torn write)"
    return payload, None


def _atomic_write(path: str, data, link_from: Optional[str] = None
                  ) -> None:
    """tmp + fsync + rename so a crash (including power loss) never
    corrupts the previous checkpoint, each write under the bounded
    ``ckpt.write`` retry: a transient ``OSError`` (ENOSPC racing a log
    rotation, an NFS hiccup, the injected drill fault) is retried with
    backoff; exhaustion raises a seam-named error. ``data`` is bytes or
    a tuple of byte chunks written in order. ``link_from`` names a file
    this save already wrote, fsynced, with the same bytes: the tmp is a
    hard link to it (the checkpoint, ``model_best`` and the round's keep
    hold one payload; the next save replaces the names, not the inode),
    or, where the filesystem refuses links, a write of ``data``."""
    # lazy: the robustness package imports the round's modules
    from fedtorch_tpu_torch.robustness import host_chaos, host_recovery
    chunks = data if isinstance(data, tuple) else (data,)

    def attempt():
        host_chaos.maybe_raise_io("ckpt.write")
        tmp = path + ".tmp"
        if link_from is not None:
            if os.path.lexists(tmp):
                os.remove(tmp)
            try:
                os.link(link_from, tmp)
                os.replace(tmp, path)
                return
            except OSError as e:
                if e.errno not in (errno.EXDEV, errno.EPERM, errno.EMLINK,
                                   errno.ENOTSUP, errno.EOPNOTSUPP):
                    raise
        with open(tmp, "wb") as f:
            for chunk in chunks:
                f.write(chunk)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    host_recovery.retry_io(attempt, "ckpt.write")


_ROUND_KEEP_RE = re.compile(r"^checkpoint_r(\d+)\.ckpt$")


def _frame_probe(path: str):
    """Tri-state header probe: True = frame (or unframed blob) looks
    intact, False = CONFIRMED torn (size disagrees with the in-frame
    length), None = could not read — a transient probe error must be
    treated as "don't know", never as "torn"."""
    try:
        size = os.path.getsize(path)
        with open(path, "rb") as f:
            head = f.read(_CKPT_HEADER)
    except OSError:
        return None
    if len(head) < len(_CKPT_MAGIC):
        return False
    if not head.startswith(_CKPT_MAGIC):
        return True  # unframed
    if len(head) < _CKPT_HEADER:
        return False
    return size == _CKPT_HEADER + _frame_want_len(head)


def frame_quick_ok(path: str) -> bool:
    """Cheap integrity check for GC/tests: True only when the frame
    header verifiably matches the on-disk size. Header-only read; resume
    still runs the full digest check."""
    return _frame_probe(path) is True


def collect_round_keeps(directory: str, keep_last_n: int) -> list:
    """Bounded retention for the per-round ``checkpoint_r{N}.ckpt``
    keeps: retain the newest ``keep_last_n`` VALID frames (by round
    number) and delete the rest — torn frames never count against the
    budget. ``keep_last_n <= 0`` keeps everything; ``checkpoint.ckpt``
    and ``model_best.*`` are never candidates. Returns the removed
    paths."""
    if keep_last_n <= 0:
        return []
    keeps = []
    try:
        names = os.listdir(directory)
    except OSError:
        return []
    for name in names:
        m = _ROUND_KEEP_RE.match(name)
        if m:
            keeps.append((int(m.group(1)), name))
    keeps.sort()
    probes = {name: _frame_probe(os.path.join(directory, name))
              for _, name in keeps}
    valid = [name for _, name in keeps if probes[name] is True]
    retained = set(valid[max(len(valid) - keep_last_n, 0):])
    removed = []
    for _, name in keeps:
        if name in retained or probes[name] is None:
            continue
        path = os.path.join(directory, name)
        try:
            os.remove(path)
            removed.append(path)
        except OSError:  # raced with an external cleaner
            pass
    return removed


def _write_checkpoint(directory: str, host_state, meta: dict,
                      is_best: bool, round_idx: int, save_all: bool,
                      save_some_rounds: Tuple[int, ...],
                      keep_last_n: int = 0) -> str:
    """Serialize + write an already-host-resident snapshot (the worker
    half of both the sync and async paths). The ``ckpt.torn`` drill seam
    truncates individual payload writes (each file draws on its own)
    but lets the rename land: the torn frame resume and GC must catch."""
    from fedtorch_tpu_torch.robustness import host_chaos  # lazy: see above
    os.makedirs(directory, exist_ok=True)
    payload = _to_bytes(host_state)
    framed = (_frame_header(payload), payload)
    intact = []  # the file this save wrote whole, for the others' links

    def put(name):
        path = os.path.join(directory, name)
        # each file draws the torn seam on its own (the JAX package's
        # maybe_truncate of the framed bytes: their first half lands)
        total = sum(len(c) for c in framed)
        if host_chaos.fire("ckpt.torn") and total > 1:
            _atomic_write(path, b"".join(bytes(c) for c in framed)
                          [:total // 2])
            return
        _atomic_write(path, framed, link_from=intact[0] if intact
                      else None)
        intact.append(path)

    put("checkpoint.ckpt")
    meta_bytes = json.dumps(meta, default=str).encode()
    _atomic_write(os.path.join(directory, "checkpoint.json"), meta_bytes)
    if is_best:
        put("model_best.ckpt")
        _atomic_write(os.path.join(directory, "model_best.json"),
                      meta_bytes)
    if save_all or round_idx in save_some_rounds:
        put(f"checkpoint_r{round_idx}.ckpt")
        collect_round_keeps(directory, keep_last_n)
    return os.path.join(directory, "checkpoint.ckpt")


def _meta_for(cfg: ExperimentConfig, round_idx: int,
              best_prec1: float) -> dict:
    return {
        "arguments": _compat_meta(cfg),
        "round": round_idx,
        "best_prec1": best_prec1,
        "config": dataclasses.asdict(cfg),
    }


def is_writer_process() -> bool:
    """Only rank 0 writes (the reference's rank-0 checkpointing,
    eval.py:120-144): under client sharding the snapshot gathers every
    rank's client rows to rank 0, and N writers would race on the same
    files."""
    from fedtorch_tpu_torch.parallel.mesh import rank
    return rank() == 0


def save_checkpoint(directory: str, server, clients,
                    cfg: ExperimentConfig, best_prec1: float,
                    is_best: bool, save_all: bool = False,
                    save_some_rounds: Tuple[int, ...] = ()) -> str:
    """Write the full round state (checkpoint.py:68-82 semantics),
    synchronously. See :class:`AsyncCheckpointer` for the non-blocking
    variant. Every rank of a process group calls it (the snapshot
    gathers the sharded client state, :func:`_snapshot`); only rank 0
    writes (:func:`is_writer_process`)."""
    with telemetry.span("checkpoint.snapshot"):
        host_state = _snapshot(server, clients, cfg.federated.num_clients)
    if not is_writer_process():
        return os.path.join(directory, "checkpoint.ckpt")
    round_idx = int(server.round)
    with telemetry.span("checkpoint.write", round=round_idx):
        return _write_checkpoint(
            directory, host_state, _meta_for(cfg, round_idx, best_prec1),
            is_best, round_idx, save_all, save_some_rounds,
            cfg.checkpoint.keep_last_n)


class AsyncCheckpointer:
    """Non-blocking checkpoint writer: :meth:`save` takes the owning
    host snapshot on the caller thread (:func:`_snapshot` waits for the
    device copies, so the snapshot is consistent and the next round may
    rewrite the state in place), then one worker thread serializes and
    atomically writes it. Bounded backpressure: one snapshot being
    written + one queued; a third ``save`` builds its snapshot then
    blocks in the queue until the oldest write finishes. Every requested
    checkpoint is durably written.

    Degraded mode: a background write that still fails after the
    per-write ``ckpt.write`` retries emits one ``ckpt.degraded`` event,
    counts the lost write, and every later ``save`` writes synchronously
    on the caller thread, so a persistent disk fault surfaces at the save
    that hit it.

    Call :meth:`wait` before reading checkpoints back or at run end.
    :meth:`close` is idempotent, runs on interpreter exit as an
    ``atexit`` fallback, and unregisters itself once closed."""

    def __init__(self):
        import queue
        import threading
        self._q: "queue.Queue" = queue.Queue(maxsize=1)
        self._closed = False
        # write-latency/queue gauges: written by the worker, read by
        # stats()/save() on the caller thread, both under _gauges
        self._gauges = _tel_faults.new_lock("AsyncCheckpointer._gauges")
        self.writes = 0
        self.last_write_s = 0.0
        self.total_write_s = 0.0
        self.degraded = False
        self.lost_writes = 0
        self._thread = threading.Thread(target=self._worker, daemon=True,
                                        name="async-checkpointer")
        self._thread.start()
        atexit.register(self._atexit_close)

    def _worker(self):
        while True:
            job = self._q.get()
            if job is None:
                self._q.task_done()
                return
            t0 = time.perf_counter()
            try:
                # job[4] is round_idx (the _write_checkpoint signature)
                with telemetry.span("checkpoint.write", round=job[4]):
                    _write_checkpoint(*job)
                with self._gauges:
                    self.writes += 1
            except Exception as e:
                self._note_degraded(job[4], e)
            finally:
                dt = time.perf_counter() - t0
                with self._gauges:
                    self.last_write_s = dt
                    self.total_write_s += dt
                self._q.task_done()

    def _note_degraded(self, round_idx, exc) -> None:
        """A write was durably lost: record it once, loudly, and flip to
        synchronous writes."""
        import sys
        with self._gauges:
            self.lost_writes += 1
            first = not self.degraded
            self.degraded = True
        print(f"AsyncCheckpointer: write for round {round_idx} lost "
              f"after retries ({exc!r}); degrading to synchronous "
              "checkpoint writes", file=sys.stderr, flush=True)
        if first:
            from fedtorch_tpu_torch.robustness import host_recovery
            host_recovery.get_active().note_degraded("ckpt.write")
        telemetry.event("ckpt.degraded", round=round_idx,
                        error=repr(exc), lost_writes=self.lost_writes)

    def stats(self) -> dict:
        """Telemetry gauges: durable writes, last/total write wall, the
        queue depth behind the worker and the degraded-mode pair."""
        with self._gauges:
            return {
                "ckpt_queue_depth": float(self._q.qsize()),
                "ckpt_writes": float(self.writes),
                "ckpt_last_write_s": self.last_write_s,
                "ckpt_total_write_s": self.total_write_s,
                "ckpt_degraded": float(self.degraded),
                "ckpt_lost_writes": float(self.lost_writes),
            }

    def save(self, directory: str, server, clients,
             cfg: ExperimentConfig, best_prec1: float, is_best: bool,
             save_all: bool = False,
             save_some_rounds: Tuple[int, ...] = ()) -> None:
        with telemetry.span("checkpoint.snapshot"):
            host_state = _snapshot(server, clients,
                                   cfg.federated.num_clients)
        if not is_writer_process():
            return
        round_idx = int(server.round)
        job = (directory, host_state,
               _meta_for(cfg, round_idx, best_prec1), is_best,
               round_idx, save_all, save_some_rounds,
               cfg.checkpoint.keep_last_n)
        with self._gauges:
            degraded = self.degraded
        if degraded:
            # synchronous fallback; drain the worker first so an older
            # queued job cannot land after this newer one
            self._q.join()
            from fedtorch_tpu_torch.robustness import host_recovery
            t0 = time.perf_counter()
            try:
                with telemetry.span("checkpoint.write", round=round_idx,
                                    degraded=True):
                    host_recovery.retry_io(
                        lambda: _write_checkpoint(*job), "ckpt.write")
                with self._gauges:
                    self.writes += 1
            finally:
                dt = time.perf_counter() - t0
                with self._gauges:
                    self.last_write_s = dt
                    self.total_write_s += dt
            return
        self._q.put(job)

    def wait(self) -> None:
        """Block until every enqueued checkpoint is on disk (or was
        recorded lost — see ``degraded``/``lost_writes``)."""
        self._q.join()

    def close(self) -> None:
        """Drain pending writes and stop the worker. Idempotent."""
        if self._closed:
            return
        self._closed = True
        atexit.unregister(self._atexit_close)
        try:
            self.wait()
        finally:
            self._q.put(None)
            self._thread.join(timeout=30)

    def _atexit_close(self) -> None:
        try:
            self.close()
        except Exception as e:
            import sys
            print(f"AsyncCheckpointer: atexit flush failed: {e!r}",
                  file=sys.stderr, flush=True)


def _corrupt_skip(path: str, why: str, server, clients):
    """A corrupt/truncated checkpoint is a recoverable condition: warn
    and start fresh instead of dying on an opaque error."""
    warnings.warn(
        f"checkpoint at {path} is corrupt or truncated ({why}); "
        "skipping resume and starting from the initialized state",
        RuntimeWarning, stacklevel=3)
    return server, clients, 0.0, False


class ForeignCheckpointError(ValueError):
    """The checkpoint holds a payload the port cannot continue (the JAX
    package's flax msgpack, with a threefry key in place of the port's
    generator)."""


def _load_payload(data: bytes, path: str) -> dict:
    if not data.startswith(b"PK"):
        # torch.save writes a zip archive; a flax msgpack payload opens
        # with a map marker (fixmap 0x80-0x8f, map16 0xde, map32 0xdf)
        if data[:1] and (0x80 <= data[0] <= 0x8F or data[0] in (0xDE,
                                                                0xDF)):
            raise ForeignCheckpointError(
                f"checkpoint at {path} is a JAX package checkpoint (flax "
                "msgpack with a threefry PRNG key): the port's round plans "
                "are drawn from a torch.Generator it cannot continue — "
                "start the port's run fresh, or resume it in the JAX "
                "package")
    state = torch.load(io.BytesIO(data), map_location="cpu",
                       weights_only=True)
    if not isinstance(state, dict) or state.get("format") != PAYLOAD_FORMAT:
        raise ValueError(f"payload format "
                         f"{state.get('format') if isinstance(state, dict) else type(state).__name__!r}"
                         f" != {PAYLOAD_FORMAT!r}")
    return state


def _owned_clients(plain, num_clients: int):
    """The payload's client state cut to this rank's rows of the sharded
    trees (``parallel/mesh.py`` ``owned_client_rows``; the whole payload
    on one rank), zero rows standing for the padding past the real
    clients (never read)."""
    if not _client_state_sharded() or not isinstance(plain, dict):
        return plain
    from fedtorch_tpu_torch.parallel.mesh import owned_client_rows
    lo, hi = owned_client_rows(num_clients)

    def cut(p):
        if isinstance(p, dict):
            return {k: cut(v) for k, v in p.items()}
        if isinstance(p, list):
            return [cut(v) for v in p]
        if not isinstance(p, torch.Tensor):
            return p
        mine = p[lo:min(hi, num_clients)]
        pad = mine.new_zeros((hi - lo - mine.shape[0],) + mine.shape[1:])
        return torch.cat([mine, pad]) if pad.shape[0] else mine
    return {f: cut(v) if f in _SHARDED else v for f, v in plain.items()}


def maybe_resume(directory: Optional[str], server, clients,
                 cfg: ExperimentConfig,
                 checkpoint_index: Optional[str] = None):
    """Restore full state into freshly-initialized ``(server, clients)``
    (their tensors are overwritten in place); validates the config
    compatibility rules of checkpoint.py:93-139. Returns (server,
    clients, best_prec1, resumed: bool).

    Corrupt or truncated checkpoints (frame length/sha256 mismatch,
    undecodable meta JSON, a payload that fails to load or to graft) are
    SKIPPED with a warning that names each skipped file — a torn latest
    checkpoint falls back to the newest valid per-round keep. A MISSING
    checkpoint/meta file, a config INCOMPATIBILITY and a JAX package
    payload (:class:`ForeignCheckpointError`) raise."""
    if directory is None:
        return server, clients, 0.0, False
    name = "checkpoint.ckpt" if checkpoint_index is None \
        else f"checkpoint_r{checkpoint_index}.ckpt"
    path = os.path.join(directory, name)
    meta_path = os.path.join(
        directory, name.replace(".ckpt", ".json")
        if checkpoint_index is None else "checkpoint.json")
    if not os.path.exists(path):
        raise FileNotFoundError(f"No checkpoint at {path}")
    try:
        with open(meta_path) as f:
            meta = json.load(f)
    except json.JSONDecodeError as e:
        # a torn checkpoint.json beside a healthy payload: model_best.json
        # carries the same compat block (default path only)
        meta = None
        if checkpoint_index is None:
            try:
                with open(os.path.join(directory, "model_best.json")) \
                        as f:
                    meta = json.load(f)
                warnings.warn(
                    f"checkpoint meta at {meta_path} is undecodable "
                    f"({e}); validated compat against model_best.json "
                    "instead", RuntimeWarning, stacklevel=2)
            except (OSError, json.JSONDecodeError):
                meta = None
        if meta is None:
            return _corrupt_skip(meta_path,
                                 f"undecodable meta JSON: {e}",
                                 server, clients)
    old = meta["arguments"]
    new = _compat_meta(cfg)
    legacy_defaults = {"sync_mode": "sync", "robust_momentum": False,
                       "dp_aggregation": False}
    for key in ("dataset", "batch_size", "arch", "algorithm",
                "num_clients", "sync_mode", "robust_momentum",
                "dp_aggregation"):
        was = old.get(key, legacy_defaults[key]) \
            if key in legacy_defaults else old[key]
        if was != new[key]:
            raise ValueError(
                f"Checkpoint incompatible: {key} was {was!r}, "
                f"config has {new[key]!r} (checkpoint.py:104-120 rule)")
    if new["num_epochs"] is not None and old["num_epochs"] is not None \
            and new["num_epochs"] < old["num_epochs"]:
        raise ValueError(
            "Checkpoint incompatible: num_epochs must not shrink "
            f"({old['num_epochs']} -> {new['num_epochs']})")

    def _try(file_path):
        try:
            with open(file_path, "rb") as f:
                raw = f.read()
        except OSError as e:
            return None, f"unreadable: {e}"
        data, bad = _unframe_payload(raw)
        if bad is not None:
            return None, bad
        try:
            state = _load_payload(data, file_path)
        except ForeignCheckpointError:
            raise
        except Exception as e:
            return None, f"deserialization failed: {e}"
        return state, None

    restored, why = _try(path)
    if restored is None and checkpoint_index is None:
        # the LATEST checkpoint is torn; resume from the newest valid
        # per-round keep (the compat meta was validated above: the same
        # run, an earlier durable round)
        keeps = []
        for keep in os.listdir(directory):
            m = _ROUND_KEEP_RE.match(keep)
            if m:
                keeps.append((int(m.group(1)), keep))
        skipped = [f"{path} ({why})"]
        for _, keep in sorted(keeps, reverse=True):
            keep_path = os.path.join(directory, keep)
            restored, keep_why = _try(keep_path)
            if restored is not None:
                warnings.warn(
                    "skipped corrupt or truncated checkpoint(s) "
                    + "; ".join(skipped)
                    + f"; resumed from the newest valid per-round keep "
                    f"{keep_path} instead", RuntimeWarning, stacklevel=2)
                break
            skipped.append(f"{keep_path} ({keep_why})")
    if restored is None:
        return _corrupt_skip(path, why, server, clients)
    pairs = ((server.params, "params"), (server.opt, "opt"),
             (server.aux, "aux"))
    try:
        s = restored["server"]
        # check every leaf before the first in-place copy
        for write in (False, True):
            params, opt, aux = (_graft(t, s[k], f"server/{k}", write)
                                for t, k in pairs)
            new_clients = _graft(clients, _owned_clients(
                restored["clients"], cfg.federated.num_clients),
                "clients", write)
        rng = torch.Generator(device=server.rng.device)
        rng.set_state(s["rng_state"])
        round_idx = int(s["round"])
    except (KeyError, ValueError, RuntimeError) as e:
        return _corrupt_skip(path, f"payload does not fit the run's state: "
                             f"{e}", server, clients)
    server = ServerState(params=params, opt=opt, aux=aux, round=round_idx,
                         rng=rng)
    return (server, new_clients, float(meta.get("best_prec1", 0.0)), True)
