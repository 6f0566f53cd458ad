"""Streaming data plane: a host client store and round-ahead feeds (port
of ``fedtorch_tpu/data/streaming.py``).

On the device plane the trainer copies the whole ``[C, n_max, ...]``
population to the device at construction, although a round reads only
its k online clients' K*B rows. ``cfg.data.data_plane='stream'`` keeps
the population on the host, in RAM (:class:`HostClientStore`) or on
disk (:class:`MmapClientStore`, written by :func:`save_client_store` or
:class:`MmapStoreWriter`), and turns each round's working set into a
packed :class:`RoundFeed` that a background thread
(:class:`StreamFeedProducer`) builds and copies to the device while the
round before it runs.

* **Schedule.** The JAX package replays a round's plan from
  ``fold_in(key, round)``. The port draws its plans from the server's
  stateful ``torch.Generator``, so :class:`RoundSchedule` draws ahead on
  a private clone of it, through the trainer's own plan drawer, and
  hands each plan over with the generator's state before and after its
  draws. The trainer consumes a feed only when the state before equals
  the live generator's, then sets the generator to the state after: a
  streamed run draws the plans of a resident run from the same seed and
  leaves the generator byte-identical after every round.
* **Packed gather.** One ``index_select`` per tensor over the store's
  flat ``[C * n_max, ...]`` rows (``native/host_pipeline.py``), into
  pinned host buffers when the feed goes to a GPU.
* **H2D.** Each feed's tensors are copied with ``non_blocking=True`` on
  a side CUDA stream and an event is recorded after them. The producer
  waits for that event before it queues the feed, so a feed in the
  queue is already on the device and its pinned buffers are no longer
  read; they are allocated anew for every feed (PyTorch's pinned-memory
  cache hands them back once the copy's event has completed). The
  consumer's stream waits on the event and ``record_stream`` marks each
  feed tensor as used there, so the caching allocator does not give a
  live feed's memory to the next one.
* **Windows.** With ``window = R`` each item packs R consecutive rounds
  in one gather per tensor (``[R, k, ...]``): the feed source of the
  scan dispatch (``parallel/round_program.py``).
* **Self-healing.** The gather (host-chaos seams ``stream.delay`` and
  ``stream.gather``) and the copy to the device (``stream.h2d``) each
  run under the bounded ``host_recovery.retry`` (the JAX package's
  ``streaming.py:742-810``): both are pure over the drawn plan, so a
  retry is an exact replay. A gather that exhausts its retries kills the
  producer with a seam-named ``HostSeamError``; the trainer then
  rebuilds the producer from the live (generator, round)
  (``FederatedTrainer._pop_stream_with_rebuild``).

The trainer side is ``FederatedTrainer.round_stream_fn``, which runs the
same round core as the device plane's ``round_fn``.
"""
from __future__ import annotations

import json
import os
import pathlib
import time
from typing import Callable, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from fedtorch_tpu_torch import telemetry
from fedtorch_tpu_torch.data.batching import ClientData
from fedtorch_tpu_torch.native.host_pipeline import (
    HostPrefetcher, gather_rows,
)

#: manifest schema of the on-disk sharded client store (MmapClientStore);
#: the JAX package's writer and reader use the same layout
STORE_FORMAT = "fedtorch-client-store"
STORE_VERSION = 1
MANIFEST_NAME = "manifest.json"
SIZES_NAME = "sizes.int32.bin"
FEED_LAYOUTS = ("batch", "shard")
# the tensors a feed moves to the device; the rest are small host tensors
DEVICE_FIELDS = ("x", "y", "pre_x", "pre_y", "probe_x", "probe_y")


class RoundFeed(NamedTuple):
    """One round's inputs on the stream plane (a window's, with a leading
    ``[R]`` axis on every tensor).

    ``x``/``y`` hold the round's rows in plan order (the 'batch' layout)
    or each online client's whole padded shard in storage order (the
    'shard' layout, for qFFL's full-data loss); ``pre_x``/``pre_y`` each
    online client's first B storage rows (``pre_round``'s batch);
    ``probe_*`` the post-round probe batches (DRFA's dual phase). The
    rest is the round plan beside the rows: the rows themselves, the
    augmentation draws, DRFA's snapshot step and probe rows, the
    dropout keys and the armed fault planes' uniforms and seeds (``k``
    is the round's dispatched clients, ``k'`` under over-selection)."""
    idx: torch.Tensor      # [k] int32 online client ids
    sizes: torch.Tensor    # [k] int32 their sample counts
    x: torch.Tensor        # [k, K*B, ...] (batch) or [k, n_max, ...] (shard)
    y: torch.Tensor
    pre_x: torch.Tensor    # [k, B, ...]
    pre_y: torch.Tensor
    probe_idx: Optional[torch.Tensor] = None   # [k2] int32
    probe_x: Optional[torch.Tensor] = None     # [k2, B, ...]
    probe_y: Optional[torch.Tensor] = None
    rows: Optional[torch.Tensor] = None        # [k, K*B] int64
    flip: Optional[torch.Tensor] = None        # [k, K, B] bool
    tops: Optional[torch.Tensor] = None        # [k, K, B] int64
    lefts: Optional[torch.Tensor] = None
    k_rand: Optional[torch.Tensor] = None      # 0-d int64
    probe_rows: Optional[torch.Tensor] = None  # [k2, B] int64
    drop_keys: Optional[torch.Tensor] = None   # [k, K] int64
    u_crash: Optional[torch.Tensor] = None     # [k] float32
    u_strag: Optional[torch.Tensor] = None     # [k] float32
    u_nan: Optional[torch.Tensor] = None       # [k] float32
    u_avail: Optional[torch.Tensor] = None     # [k, 2] float32
    u_drop: Optional[torch.Tensor] = None      # [k] float32
    byz_seed: Optional[torch.Tensor] = None    # 0-d int64
    dp_seed: Optional[torch.Tensor] = None     # 0-d int64

# the plan's fault fields a feed carries: tensors as they are, seeds as
# 0-d int64 tensors
FAULT_TENSORS = ("u_crash", "u_strag", "u_nan", "u_avail", "u_drop")
FAULT_SEEDS = ("byz_seed", "dp_seed")


def feed_nbytes(feed: RoundFeed) -> int:
    """Bytes of every tensor of a feed."""
    return int(sum(t.numel() * t.element_size() for t in feed
                   if isinstance(t, torch.Tensor)))


def window_round(feed: RoundFeed, r: int) -> RoundFeed:
    """Round ``r`` of a window feed (views, no copy)."""
    return RoundFeed(*(t[r] if isinstance(t, torch.Tensor) else t
                       for t in feed))


def np_dtype(dtype: torch.dtype) -> np.dtype:
    """The numpy dtype of a torch dtype (a store's manifest names it)."""
    return torch.empty(0, dtype=dtype).numpy().dtype


def _torch_dtype(dtype) -> torch.dtype:
    return torch.from_numpy(np.empty(0, np.dtype(dtype))).dtype


def _host_tensor(a) -> torch.Tensor:
    """A contiguous CPU tensor of ``a``, without a copy when ``a`` already
    is one (a store must not double the population's host memory)."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().contiguous()
    return torch.from_numpy(np.ascontiguousarray(a))


def _as_numpy(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _alloc_plain(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype)


def _alloc_pinned(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, pin_memory=True)


class ClientStore:
    """What the feed producer needs of a population, behind one flat-row
    gather (:meth:`_gather_flat`). The packing arithmetic (flat row ids,
    the clamped ``pre_round`` columns, the window flatten) lives here,
    shared by both stores and bitwise the JAX package's.

    Every ``pack*`` method takes ``alloc(shape, dtype)``, which makes the
    buffers the rows are gathered into (pinned ones for a GPU feed)."""

    num_clients: int
    n_max: int
    sizes: np.ndarray  # [C] int32, in RAM
    _feat: dict        # tensor name -> trailing feature shape
    _dtypes: dict      # tensor name -> np.dtype

    def _gather_flat(self, tensor: str, flat_rows: np.ndarray,
                     out: torch.Tensor) -> None:
        """``out[i] = store[tensor].reshape(C * n_max, ...)[flat_rows[i]]``."""
        raise NotImplementedError

    def feat(self, tensor: str) -> tuple:
        """Trailing per-sample shape of ``tensor``."""
        return tuple(self._feat[tensor])

    def dtype(self, tensor: str) -> np.dtype:
        return self._dtypes[tensor]

    @property
    def resident_nbytes(self) -> int:
        """Bytes this store keeps in host RAM."""
        raise NotImplementedError

    @property
    def mapped_nbytes(self) -> int:
        """Bytes reachable through memory maps (paged in on demand)."""
        raise NotImplementedError

    def _gather(self, tensor: str, flat: np.ndarray, lead: tuple,
                alloc: Callable) -> torch.Tensor:
        feat = self.feat(tensor)
        out = alloc(lead + feat, _torch_dtype(self._dtypes[tensor]))
        self._gather_flat(tensor, flat, out.view((flat.shape[0],) + feat))
        return out

    def pack(self, idx, rows, batch_size: int,
             alloc: Callable = _alloc_plain) -> RoundFeed:
        """One round's feed: client ``idx[i]``'s rows ``rows[i]`` and its
        first ``batch_size`` storage rows (``pre_round``'s batch)."""
        idx = np.asarray(idx, np.int64)
        rows = np.asarray(rows, np.int64)
        k, num_rows = rows.shape
        flat = (idx[:, None] * self.n_max + rows).reshape(-1)
        # clamped as the device plane's gather clamps: with batch_size >
        # n_max the hook batch repeats the last row instead of walking
        # into the next client's shard
        pre_cols = np.minimum(np.arange(batch_size, dtype=np.int64),
                              self.n_max - 1)
        pre = (idx[:, None] * self.n_max + pre_cols[None, :]).reshape(-1)
        return RoundFeed(
            idx=torch.from_numpy(idx.astype(np.int32)),
            sizes=torch.from_numpy(self.sizes[idx]),
            x=self._gather("x", flat, (k, num_rows), alloc),
            y=self._gather("y", flat, (k, num_rows), alloc),
            pre_x=self._gather("x", pre, (k, batch_size), alloc),
            pre_y=self._gather("y", pre, (k, batch_size), alloc))

    def pack_shards(self, idx, batch_size: int,
                    alloc: Callable = _alloc_plain) -> RoundFeed:
        """The 'shard' layout: each online client's whole padded shard in
        storage order."""
        idx = np.asarray(idx, np.int64)
        rows = np.broadcast_to(np.arange(self.n_max, dtype=np.int64),
                               (idx.shape[0], self.n_max))
        return self.pack(idx, rows, batch_size, alloc)

    def pack_probe(self, idx2, rows2, alloc: Callable = _alloc_plain
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """The post-round probe batches: client ``idx2[i]``'s storage rows
        ``rows2[i]``; returns (idx2 as int32, x, y)."""
        idx2 = np.asarray(idx2, np.int64)
        rows2 = np.asarray(rows2, np.int64)
        k2, b = rows2.shape
        flat = (idx2[:, None] * self.n_max + rows2).reshape(-1)
        return (torch.from_numpy(idx2.astype(np.int32)),
                self._gather("x", flat, (k2, b), alloc),
                self._gather("y", flat, (k2, b), alloc))

    def pack_window(self, idxs, rowss, batch_size: int,
                    alloc: Callable = _alloc_plain) -> RoundFeed:
        """R rounds' feeds stacked on a leading ``[R]`` axis, in one
        gather per tensor: the ``[R, k]`` ids and ``[R, k, rows]`` plans
        flatten to one ``[R*k]``-client pack."""
        R, k = np.asarray(idxs).shape
        feed = self.pack(np.asarray(idxs).reshape(-1),
                         np.asarray(rowss).reshape(R * k, -1),
                         batch_size, alloc)
        return RoundFeed(*(t.view((R, k) + t.shape[1:])
                           if t is not None else None for t in feed))


class HostClientStore(ClientStore):
    """The population in host RAM: ``[C, n_max, ...]`` CPU tensors and
    their flat row views. ``data``'s tensors are used in place when they
    already are contiguous CPU tensors."""

    def __init__(self, data: ClientData):
        self.x = _host_tensor(data.x)
        self.y = _host_tensor(data.y)
        self.sizes = _as_numpy(data.sizes).astype(np.int32)
        self.num_clients, self.n_max = self.x.shape[:2]
        self._feat = {"x": tuple(self.x.shape[2:]),
                      "y": tuple(self.y.shape[2:])}
        self._dtypes = {"x": np_dtype(self.x.dtype),
                        "y": np_dtype(self.y.dtype)}
        C, n = self.num_clients, self.n_max
        self._flat = {"x": self.x.view((C * n,) + self._feat["x"]),
                      "y": self.y.view((C * n,) + self._feat["y"])}

    @property
    def resident_nbytes(self) -> int:
        return int(self.x.numel() * self.x.element_size()
                   + self.y.numel() * self.y.element_size())

    @property
    def mapped_nbytes(self) -> int:
        return 0

    def _gather_flat(self, tensor, flat_rows, out):
        gather_rows(self._flat[tensor], flat_rows, out=out)


class MmapClientStore(ClientStore):
    """The population on disk: memory maps over a manifest-described
    shard layout (:func:`save_client_store`, :class:`MmapStoreWriter`),
    so host RAM holds the sizes (4 bytes a client) and what the page
    cache keeps. Clients are split into consecutive shards of
    ``clients_per_shard``; each shard is one raw C-order file of
    ``[clients_in_shard * n_max, ...feat]`` rows per tensor, mapped on
    first use and indexed with int32 local row ids. A torn or truncated
    shard file raises when a gather first maps it."""

    def __init__(self, store_dir: str):
        self._dir = pathlib.Path(store_dir)
        mpath = self._dir / MANIFEST_NAME
        if not mpath.is_file():
            raise ValueError(
                f"no client-store manifest at {mpath} — materialize "
                "one with fedtorch_tpu_torch.data.streaming."
                "save_client_store (or MmapStoreWriter) and point "
                "data.store_dir at it")
        with open(mpath, "r", encoding="utf-8") as f:
            man = json.load(f)
        if man.get("format") != STORE_FORMAT:
            raise ValueError(
                f"{mpath}: format {man.get('format')!r} is not "
                f"{STORE_FORMAT!r}")
        if int(man.get("version", -1)) != STORE_VERSION:
            raise ValueError(
                f"{mpath}: version {man.get('version')!r} unsupported "
                f"(this build reads version {STORE_VERSION})")
        self.num_clients = int(man["num_clients"])
        self.n_max = int(man["n_max"])
        self.clients_per_shard = int(man["clients_per_shard"])
        if self.clients_per_shard * self.n_max > np.iinfo(np.int32).max:
            raise ValueError(
                f"{mpath}: clients_per_shard * n_max "
                f"({self.clients_per_shard} * {self.n_max}) overflows "
                "int32 — the per-shard native gather contract")
        num_shards = -(-self.num_clients // self.clients_per_shard)
        self.sizes = np.fromfile(str(self._dir / man["sizes_file"]),
                                 dtype=np.int32)
        if self.sizes.shape[0] != self.num_clients:
            raise ValueError(
                f"{self._dir / man['sizes_file']}: {self.sizes.shape[0]} "
                f"sizes for {self.num_clients} clients")
        self._feat, self._dtypes, self._paths = {}, {}, {}
        for name, spec in man["tensors"].items():
            self._feat[name] = tuple(int(d) for d in spec["feat"])
            self._dtypes[name] = np.dtype(spec["dtype"])
            paths = [self._dir / p for p in spec["shards"]]
            if len(paths) != num_shards:
                raise ValueError(
                    f"{mpath}: tensor {name!r} lists {len(paths)} "
                    f"shards, layout needs {num_shards}")
            self._paths[name] = paths
        self._maps: dict = {}  # (tensor, shard id) -> CPU tensor view

    @property
    def resident_nbytes(self) -> int:
        return int(self.sizes.nbytes)

    @property
    def mapped_nbytes(self) -> int:
        total = 0
        for name in self._paths:
            row = self._dtypes[name].itemsize * int(
                np.prod(self._feat[name], initial=1))
            total += self.num_clients * self.n_max * row
        return int(total)

    def _shard_clients(self, sid: int) -> int:
        lo = sid * self.clients_per_shard
        return min(self.clients_per_shard, self.num_clients - lo)

    def _shard(self, tensor: str, sid: int) -> torch.Tensor:
        key = (tensor, sid)
        view = self._maps.get(key)
        if view is None:
            shape = ((self._shard_clients(sid) * self.n_max,)
                     + self._feat[tensor])
            path = self._paths[tensor][sid]
            try:
                # copy-on-write: a writable array that torch can view
                # without a copy and without warning; nothing writes to
                # it, so no page is ever copied and the file never changes
                mm = np.memmap(str(path), dtype=self._dtypes[tensor],
                               mode="c", shape=shape)
            except (ValueError, OSError) as e:
                raise ValueError(
                    f"client-store shard {sid} of tensor {tensor!r} is "
                    f"torn or truncated at {path} — expected "
                    f"{int(np.prod(shape))} x {self._dtypes[tensor]} "
                    f"elements; {e}") from e
            view = self._maps[key] = torch.from_numpy(mm)
        return view

    def _gather_flat(self, tensor, flat_rows, out):
        rows_per_shard = self.clients_per_shard * self.n_max
        sid = flat_rows // rows_per_shard
        shards = np.unique(sid)
        if shards.shape[0] == 1:
            s = int(shards[0])
            gather_rows(self._shard(tensor, s),
                        (flat_rows - s * rows_per_shard).astype(np.int32),
                        out=out)
            return
        for s in shards.tolist():
            where = np.flatnonzero(sid == s)
            local = (flat_rows[where] - s * rows_per_shard).astype(np.int32)
            out.index_copy_(0, torch.from_numpy(where),
                            gather_rows(self._shard(tensor, s), local))

    def as_client_data(self) -> ClientData:
        """A ``ClientData`` that holds no rows: ``sizes`` is the real
        vector, ``x``/``y`` are stride-0 views of the true shape and dtype
        (trainer construction on the stream plane reads only those)."""
        C, n = self.num_clients, self.n_max
        x = torch.zeros((), dtype=_torch_dtype(self._dtypes["x"])).expand(
            (C, n) + self._feat["x"])
        y = torch.zeros((), dtype=_torch_dtype(self._dtypes["y"])).expand(
            (C, n) + self._feat["y"])
        return ClientData(x=x, y=y, sizes=torch.from_numpy(self.sizes))


class MmapStoreWriter:
    """Builds the on-disk store chunk by chunk: :meth:`append`
    ``[c, n_max, ...]`` client chunks (a population larger than RAM
    never needs to be whole in memory), then :meth:`finalize` writes the
    sizes file and the manifest. The files are byte for byte the JAX
    package's writer's for the same arrays."""

    def __init__(self, store_dir: str, *, n_max: int,
                 x_feat: Tuple[int, ...], y_feat: Tuple[int, ...],
                 x_dtype, y_dtype, clients_per_shard: int = 65536):
        if clients_per_shard < 1:
            raise ValueError("clients_per_shard must be >= 1")
        if clients_per_shard * n_max > np.iinfo(np.int32).max:
            raise ValueError(
                f"clients_per_shard * n_max ({clients_per_shard} * "
                f"{n_max}) overflows int32 — shrink the shard so the "
                "per-shard native gather stays legal")
        self._dir = pathlib.Path(store_dir)
        self._dir.mkdir(parents=True, exist_ok=True)
        self.n_max = int(n_max)
        self.clients_per_shard = int(clients_per_shard)
        self._feat = {"x": tuple(x_feat), "y": tuple(y_feat)}
        self._dtypes = {"x": np.dtype(x_dtype), "y": np.dtype(y_dtype)}
        self._count = 0
        self._sizes: list = []
        self._shards: dict = {"x": [], "y": []}

    def _shard_path(self, tensor: str, sid: int) -> pathlib.Path:
        return self._dir / f"{tensor}.{sid:05d}.bin"

    def append(self, x_chunk, y_chunk, sizes_chunk) -> None:
        x_chunk = _as_numpy(x_chunk)
        y_chunk = _as_numpy(y_chunk)
        sizes_chunk = _as_numpy(sizes_chunk).astype(np.int32)
        c = x_chunk.shape[0]
        if (x_chunk.shape[:2] != (c, self.n_max)
                or y_chunk.shape[:2] != (c, self.n_max)
                or sizes_chunk.shape != (c,)):
            raise ValueError(
                f"chunk shapes disagree: x {x_chunk.shape}, "
                f"y {y_chunk.shape}, sizes {sizes_chunk.shape} "
                f"(n_max={self.n_max})")
        S = self.clients_per_shard
        pos = 0
        while pos < c:
            sid = self._count // S
            take = min(S - self._count % S, c - pos)
            for name, chunk in (("x", x_chunk), ("y", y_chunk)):
                path = self._shard_path(name, sid)
                if len(self._shards[name]) <= sid:
                    self._shards[name].append(path.name)
                part = np.ascontiguousarray(
                    chunk[pos:pos + take], dtype=self._dtypes[name])
                with open(path, "ab") as f:
                    part.tofile(f)
            self._sizes.append(sizes_chunk[pos:pos + take])
            self._count += take
            pos += take

    def finalize(self) -> pathlib.Path:
        sizes = (np.concatenate(self._sizes) if self._sizes
                 else np.zeros((0,), np.int32))
        sizes.astype(np.int32).tofile(str(self._dir / SIZES_NAME))
        manifest = {
            "format": STORE_FORMAT,
            "version": STORE_VERSION,
            "num_clients": self._count,
            "n_max": self.n_max,
            "clients_per_shard": self.clients_per_shard,
            "sizes_file": SIZES_NAME,
            "tensors": {
                name: {"dtype": self._dtypes[name].name,
                       "feat": list(self._feat[name]),
                       "shards": self._shards[name]}
                for name in ("x", "y")
            },
        }
        # the manifest marks a whole store: write it to a temporary file
        # and rename, so a crash mid-write leaves no torn manifest
        mpath = self._dir / MANIFEST_NAME
        tmp = self._dir / (MANIFEST_NAME + ".tmp")
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(manifest, f, indent=1, sort_keys=True)
        os.replace(tmp, mpath)
        return mpath


def save_client_store(store_dir: str, data: ClientData,
                      clients_per_shard: int = 65536,
                      chunk_clients: int = 4096) -> pathlib.Path:
    """Write a ``ClientData`` (torch tensors or numpy arrays) to the
    on-disk layout :class:`MmapClientStore` reads; returns the
    manifest's path."""
    x, y = _as_numpy(data.x), _as_numpy(data.y)
    sizes = _as_numpy(data.sizes).astype(np.int32)
    writer = MmapStoreWriter(
        store_dir, n_max=x.shape[1], x_feat=x.shape[2:],
        y_feat=y.shape[2:], x_dtype=x.dtype, y_dtype=y.dtype,
        clients_per_shard=clients_per_shard)
    for lo in range(0, x.shape[0], chunk_clients):
        hi = lo + chunk_clients
        writer.append(x[lo:hi], y[lo:hi], sizes[lo:hi])
    return writer.finalize()


class RoundSchedule:
    """The host's copy of the round plans: ``draw_fn(generator, round)``
    (the trainer's plan drawer) on a private clone of the server's
    generator, one round after another from ``start_round``. Each call
    returns the plan and the generator's state before and after its
    draws, which the trainer checks against and sets on the live
    generator when it consumes the round."""

    def __init__(self, draw_fn: Callable, generator: torch.Generator,
                 start_round: int):
        self._gen = torch.Generator()
        self._gen.set_state(generator.get_state())
        self._draw = draw_fn
        self._next = int(start_round)

    def __call__(self, round_idx: int):
        if round_idx != self._next:
            raise RuntimeError(
                f"round schedule asked for round {round_idx}, but its "
                f"generator stands before round {self._next}")
        before = self._gen.get_state()
        plan = self._draw(self._gen, round_idx)
        self._next += 1
        return plan, (before, self._gen.get_state())


class StreamItem(NamedTuple):
    """What :meth:`StreamFeedProducer.next_feed` hands over: the feed's
    first round, the feed, and per round its (before, after) generator
    states (None for a ``plan_fn`` producer)."""
    label: int
    feed: RoundFeed
    rng: Optional[List[Tuple[torch.Tensor, torch.Tensor]]]


class StreamFeedProducer:
    """The round-ahead feed pipeline on one background thread
    (:class:`~fedtorch_tpu_torch.native.host_pipeline.HostPrefetcher`):
    plan, gather, copy to ``device``, up to ``depth`` feeds ahead.

    The plans come from a :class:`RoundSchedule` (``schedule``; the
    feed's label is its round) or from ``plan_fn(step) -> (label,
    RoundPlan)`` (tests inject another package's plans through it).
    ``window = R >= 1`` packs R consecutive rounds per item on a leading
    ``[R]`` axis (the scan dispatch; schedule producers only);
    ``feed_layout='shard'`` packs whole padded shards. Feeds come out in
    order from ``start_round``; a consumer that sees another label must
    drop the producer (``FederatedTrainer.invalidate_stream``)."""

    def __init__(self, store: ClientStore, *, batch_size: int,
                 start_round: int = 0,
                 schedule: Optional[RoundSchedule] = None,
                 plan_fn: Optional[Callable] = None, depth: int = 2,
                 window: int = 0, feed_layout: str = "batch",
                 device=None, timeout_s: float = 120.0):
        if (schedule is None) == (plan_fn is None):
            raise ValueError("give the producer a schedule or a plan_fn")
        if feed_layout not in FEED_LAYOUTS:
            raise ValueError(f"feed_layout must be one of {FEED_LAYOUTS}, "
                             f"got {feed_layout!r}")
        self.window = int(window)
        if self.window < 0:
            raise ValueError(f"window must be >= 0, got {window}")
        if plan_fn is not None and self.window:
            raise ValueError("plan_fn producers make one feed per step; "
                             "feed windows need a schedule (window 0)")
        self.store = store
        self.batch_size = batch_size
        self.start_round = int(start_round)
        self.feed_layout = feed_layout
        self._schedule, self._plan_fn = schedule, plan_fn
        self._timeout_s = timeout_s
        self._stride = max(self.window, 1)
        self._expected = self.start_round
        self.device = torch.device("cpu" if device is None else device)
        if self.device.type == "cuda":
            self._copy_stream = torch.cuda.Stream(self.device)
            self._alloc = _alloc_pinned
        else:
            self._copy_stream = None
            self._alloc = _alloc_plain
        # host counters (seconds), written by the producer thread, read
        # by the consumer: monotone, one store a feed each
        self.rounds_produced = 0
        self.gather_s = 0.0   # producer: plan draws + row gathers
        self.h2d_s = 0.0      # producer: copy dispatch to the copy's end
        self.wait_s = 0.0     # consumer: blocked in next_feed
        self._prefetcher = HostPrefetcher(self._produce, depth=depth,
                                          name="stream-feed-producer")

    def _pack(self, plan) -> RoundFeed:
        alloc, B = self._alloc, self.batch_size
        idx = plan.idx.numpy()
        if self.feed_layout == "shard":
            feed = self.store.pack_shards(idx, B, alloc)
        else:
            feed = self.store.pack(idx, plan.rows.numpy(), B, alloc)
        if plan.probe_idx is not None:
            qi, qx, qy = self.store.pack_probe(
                plan.probe_idx.numpy(), plan.probe_rows.numpy(), alloc)
            feed = feed._replace(probe_idx=qi, probe_x=qx, probe_y=qy)
        return feed._replace(
            rows=plan.rows, flip=plan.flip, tops=plan.tops,
            lefts=plan.lefts, probe_rows=plan.probe_rows,
            drop_keys=plan.drop_keys,
            k_rand=None if plan.k_rand is None
            else torch.tensor(int(plan.k_rand)),
            **{f: getattr(plan, f) for f in FAULT_TENSORS},
            **{f: None if getattr(plan, f) is None
               else torch.tensor(int(getattr(plan, f)))
               for f in FAULT_SEEDS})

    def _pack_window(self, plans) -> RoundFeed:
        alloc, B, R = self._alloc, self.batch_size, len(plans)
        idxs = np.stack([p.idx.numpy() for p in plans])
        if self.feed_layout == "shard":
            rowss = np.broadcast_to(
                np.arange(self.store.n_max, dtype=np.int64),
                idxs.shape + (self.store.n_max,))
        else:
            rowss = np.stack([p.rows.numpy() for p in plans])
        feed = self.store.pack_window(idxs, rowss, B, alloc)

        def stacked(name):
            ts = [getattr(p, name) for p in plans]
            return None if ts[0] is None else torch.stack(ts)

        if plans[0].probe_idx is not None:
            i2, r2 = stacked("probe_idx"), stacked("probe_rows")
            qi, qx, qy = self.store.pack_probe(
                i2.reshape(-1).numpy(), r2.reshape(-1, r2.shape[-1]).numpy(),
                alloc)
            k2 = i2.shape[1]
            feed = feed._replace(
                probe_idx=qi.view(R, k2),
                probe_x=qx.view((R, k2) + qx.shape[1:]),
                probe_y=qy.view((R, k2) + qy.shape[1:]))
        return feed._replace(
            rows=stacked("rows"), flip=stacked("flip"),
            tops=stacked("tops"), lefts=stacked("lefts"),
            probe_rows=stacked("probe_rows"), drop_keys=stacked("drop_keys"),
            k_rand=None if plans[0].k_rand is None
            else torch.tensor([int(p.k_rand) for p in plans]),
            **{f: stacked(f) for f in FAULT_TENSORS},
            **{f: None if getattr(plans[0], f) is None
               else torch.tensor([int(getattr(p, f)) for p in plans])
               for f in FAULT_SEEDS})

    def _place(self, feed: RoundFeed):
        """The device copies of a packed feed, and the event after them
        (None off the GPU, where the packed tensors are the feed)."""
        if self._copy_stream is None:
            return feed, None
        with torch.cuda.device(self.device), \
                torch.cuda.stream(self._copy_stream):
            moved = {f: getattr(feed, f).to(self.device, non_blocking=True)
                     for f in DEVICE_FIELDS if getattr(feed, f) is not None}
            event = torch.cuda.Event()
            event.record(self._copy_stream)
        # the copy ends before the feed is queued: a queued feed is on the
        # device and its pinned buffers are free for the next feed
        event.synchronize()
        return feed._replace(**moved), event

    def _gather(self, pack, plans):
        """One gather attempt under the bounded retry of the
        ``stream.gather`` seam, with the ``stream.delay`` and
        ``stream.gather`` host-chaos seams inside the retried closure:
        each retry re-draws the injector, and a real transient error (an
        mmap read hiccup) takes the same path. Pure over ``plans``."""
        from fedtorch_tpu_torch.robustness import host_chaos, host_recovery

        def attempt():
            host_chaos.maybe_delay("stream.delay")
            host_chaos.maybe_raise("stream.gather")
            return pack(plans)
        return host_recovery.retry(attempt, "stream.gather")

    def _place_retried(self, feed: RoundFeed):
        """The copy to the device under the ``stream.h2d`` seam's bounded
        retry: another copy of the same host bytes is idempotent."""
        from fedtorch_tpu_torch.robustness import host_chaos, host_recovery

        def attempt():
            host_chaos.maybe_raise("stream.h2d")
            return self._place(feed)
        return host_recovery.retry(attempt, "stream.h2d")

    def _produce(self, step: int):
        t0 = time.perf_counter()
        with telemetry.span("stream.gather", step=step):
            if self._plan_fn is not None:
                label, plan = self._plan_fn(step)
                rng = None
                feed = self._gather(self._pack, plan)
            elif self.window == 0:
                label = self.start_round + step
                plan, states = self._schedule(label)
                rng = [states]
                feed = self._gather(self._pack, plan)
            else:
                label = self.start_round + step * self.window
                drawn = [self._schedule(label + j)
                         for j in range(self.window)]
                rng = [states for _, states in drawn]
                feed = self._gather(self._pack_window,
                                    [plan for plan, _ in drawn])
        t1 = time.perf_counter()
        with telemetry.span("stream.h2d", step=step):
            feed, event = self._place_retried(feed)
        self.gather_s += t1 - t0
        self.h2d_s += time.perf_counter() - t1
        self.rounds_produced += self._stride
        return label, feed, rng, event

    def next_feed(self) -> StreamItem:
        """The next feed, ready for the current CUDA stream."""
        t0 = time.perf_counter()
        label, feed, rng, event = self._prefetcher.next(
            timeout=self._timeout_s)
        self.wait_s += time.perf_counter() - t0
        if label != self._expected:
            self.close()
            raise RuntimeError(
                f"stream feed for round {label} but round "
                f"{self._expected} expected — the producer desynced from "
                "the training state (call invalidate_stream)")
        self._expected += self._stride
        if event is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(event)
            for f in DEVICE_FIELDS:
                t = getattr(feed, f)
                if t is not None:
                    t.record_stream(stream)
        return StreamItem(label, feed, rng)

    def alive(self) -> bool:
        """Whether the producer thread still runs."""
        return self._prefetcher.alive()

    def stats(self) -> dict:
        """Host counters: feeds queued now, rounds produced, the
        producer's cumulative gather and H2D seconds, the consumer's
        cumulative wait, and the store's RAM and mapped megabytes."""
        return {
            "depth": self._prefetcher.depth(),
            "rounds_produced": self.rounds_produced,
            "gather_s": self.gather_s,
            "h2d_s": self.h2d_s,
            "wait_s": self.wait_s,
            "store_resident_mb": self.store.resident_nbytes / 1e6,
            "store_mapped_mb": self.store.mapped_nbytes / 1e6,
        }

    def close(self) -> bool:
        """Stop the producer; True when its thread exited."""
        return self._prefetcher.close()
