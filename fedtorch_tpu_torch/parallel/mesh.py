"""Process groups and the rank mesh for the client axis (port of
``fedtorch_tpu/parallel/mesh.py``).

One process drives one device. :func:`init_multihost` brings up the
default ``torch.distributed`` process group where the JAX package calls
``jax.distributed.initialize``; :func:`make_mesh` lays the ranks out as
a :class:`~torch.distributed.device_mesh.DeviceMesh`, ``[S, world/S]``
under ``mesh.client_shards`` S >= 1 (dimension 0 shards the round's
cohort; the ranks along dimension 1 are replicas of one shard).

**Which backend.** Decided per host: NCCL where each rank on this host
has a card of its own (a CUDA run whose ranks on this host are no more
than its visible cards). The ranks on this host are ``LOCAL_WORLD_SIZE``
where a launcher sets it, else counted at the rendezvous: every rank
writes its host name to the store and reads the others'
(:func:`ranks_on_host`). Gloo on the CPU, and where ranks share a card:
NCCL refuses two ranks on one device (it reports a duplicate GPU). The
choice is printed, and it never changes because a call failed.

**Where the rows live.** The JAX package places arrays with shardings;
here each rank holds tensors:

* the ``[C]`` client state (the params, optimizer and aux trees) and,
  on the device data plane, the ``[C, n_max, ...]`` population: sharded
  over every rank as the JAX package's ``client_sharding`` places them.
  The client axis is padded to ``C_pad``, the smallest multiple of the
  rank count W (:func:`padded_client_count`), and rank r holds rows
  ``[r*C_pad/W, (r+1)*C_pad/W)`` (:func:`owned_client_rows`): the
  row-major flattening of the ``[S, W/S]`` mesh, so a rank's rows do not
  depend on S and a checkpoint re-slices at any S. Pad rows are never
  sampled. A round's cohort rows reach the ranks that run them through
  one exchange (``parallel/podscale.py`` :func:`~fedtorch_tpu_torch.
  parallel.podscale.exchange_rows`); the per-client scalars ``epoch``
  and ``local_index`` ([C], 8 B a client) stay replicated;
* the ``[k]`` cohort (:func:`cohort_sharding`): the contiguous block
  ``[s*k/S, (s+1)*k/S)`` of the rank's shard s; its local loops, its
  feed rows and its level-1 partials. At ``client_shards`` 0 on W > 1
  ranks (the JAX package's 1-D mesh) rank r runs the block of
  ``ceil(k/W)`` rows from ``r*ceil(k/W)`` (:func:`cohort_block`), and
  one gather after the local loops brings every rank the whole cohort
  (``parallel/podscale.py`` :func:`~fedtorch_tpu_torch.parallel.
  podscale.gather_cohort`);
* everything else (the server state, the plan, the ``[k]`` vectors):
  replicated, the same on every rank, since every rank draws the whole
  plan from the same generator.
"""
from __future__ import annotations

import datetime
import os
import socket
import time
from typing import Optional

import torch

from fedtorch_tpu_torch.config import MeshConfig

_MESHES = {}


def choose_backend(device_type: str, local_ranks: int) -> str:
    """The process group's backend (module docstring): 'nccl' where each
    of the ``local_ranks`` ranks on this host has a card of its own,
    else 'gloo'."""
    if device_type != "cuda":
        return "gloo"
    return "nccl" if torch.cuda.device_count() >= local_ranks else "gloo"


def ranks_on_host(store, rank: int, world: int,
                  host: Optional[str] = None) -> int:
    """How many of the ``world`` ranks run on this host: this rank writes
    its host name (``host``, by default ``socket.gethostname()``) to the
    rendezvous ``store`` and reads every rank's (each read waits, up to
    the store's timeout, until that rank has written)."""
    host = socket.gethostname() if host is None else host
    store.set(f"init_multihost/host/{rank}", host)
    return sum(store.get(f"init_multihost/host/{r}").decode() == host
               for r in range(world))


def _local_ranks(device_type: str, store, cfg: MeshConfig) -> int:
    """The ranks on this host, as :func:`choose_backend` reads them:
    ``LOCAL_WORLD_SIZE`` where a launcher set it, else counted through
    the store (only a CUDA run needs the count)."""
    if device_type != "cuda":
        return 1
    if "LOCAL_WORLD_SIZE" in os.environ:
        return int(os.environ["LOCAL_WORLD_SIZE"])
    return ranks_on_host(store, cfg.process_id, cfg.num_processes)


def init_multihost(cfg: MeshConfig, *,
                   timeout_s: Optional[float] = None,
                   backoff_s: Optional[float] = None,
                   _sleep=time.sleep) -> Optional[str]:
    """Bring up the default process group (a no-op without
    ``cfg.coordinator_address``): the rendezvous at ``tcp://ADDRESS``
    (an address that already names a scheme, such as ``file://...``,
    is used as it is), ``world_size`` ``cfg.num_processes``, ``rank``
    ``cfg.process_id``; then ``init_process_group`` on its store with
    the backend by :func:`choose_backend` (the CPU when ``cfg.backend``
    is 'cpu'). Returns the backend, or None.

    Transient connect errors are retried with exponential backoff
    (``cfg.init_backoff_s`` doubling each attempt) until
    ``cfg.init_timeout_s`` is spent, then a ``RuntimeError`` names the
    coordinator, the process id and the process count. Malformed
    arguments (``ValueError``/``TypeError``) and a second
    initialization fail at once. ``init_timeout_s`` is also the group's
    collective timeout. ``_sleep`` is injectable for tests."""
    if cfg.coordinator_address is None:
        return None
    import torch.distributed as dist
    if dist.is_initialized():
        raise RuntimeError("init_multihost: the default process group is "
                           "already initialized")
    timeout_s = cfg.init_timeout_s if timeout_s is None else timeout_s
    backoff_s = cfg.init_backoff_s if backoff_s is None else backoff_s
    device_type = "cpu" if cfg.backend == "cpu" \
        or not torch.cuda.is_available() else "cuda"
    address = cfg.coordinator_address
    init_method = address if "://" in address else f"tcp://{address}"
    timeout = datetime.timedelta(seconds=timeout_s)

    def connect() -> str:
        store, _, _ = next(dist.rendezvous(
            init_method, rank=cfg.process_id,
            world_size=cfg.num_processes, timeout=timeout))
        store.set_timeout(timeout)
        backend = choose_backend(device_type,
                                 _local_ranks(device_type, store, cfg))
        # the prefix init_process_group gives a store it made itself
        dist.init_process_group(
            backend, store=dist.PrefixStore("default_pg", store),
            world_size=cfg.num_processes, rank=cfg.process_id,
            timeout=timeout)
        return backend

    deadline = time.monotonic() + timeout_s
    attempt = 0
    while True:
        try:
            backend = connect()
            break
        except (ValueError, TypeError):
            raise  # malformed address or ids: permanent, no retry
        except Exception as e:
            msg = str(e).lower()
            if "twice" in msg or "only be called once" in msg or (
                    "already" in msg and "initial" in msg):
                raise
            attempt += 1
            delay = backoff_s * (2.0 ** (attempt - 1))
            if time.monotonic() + delay > deadline:
                raise RuntimeError(
                    f"init_multihost: could not reach coordinator "
                    f"{cfg.coordinator_address!r} within {timeout_s:.0f}s "
                    f"({attempt} attempt(s); process_id="
                    f"{cfg.process_id}, num_processes="
                    f"{cfg.num_processes}). Check that the coordinator "
                    "process is up and the address/port is reachable "
                    f"from this host. Last error: {e!r}") from e
            _sleep(delay)
    if backend == "nccl":
        torch.cuda.set_device(dist.get_rank() % torch.cuda.device_count())
    print(f"init_multihost: backend {backend}, rank {dist.get_rank()} of "
          f"{dist.get_world_size()} ({device_type})", flush=True)
    return backend


def world_size() -> int:
    """Ranks of the default process group (1 without one)."""
    import torch.distributed as dist
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    """This process's rank (0 without a process group)."""
    import torch.distributed as dist
    return dist.get_rank() if dist.is_initialized() else 0


def _device_mesh(shape, names):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    # the mesh's device type follows the backend: gloo's collectives
    # take host tensors
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    # keyed by the group itself (not its id, which a later group could
    # reuse): a mesh of a destroyed group is never handed out again
    key = (dist.group.WORLD, device_type, tuple(shape), tuple(names))
    if key not in _MESHES:
        _MESHES[key] = init_device_mesh(device_type, tuple(shape),
                                        mesh_dim_names=tuple(names))
    return _MESHES[key]


def make_mesh(cfg: MeshConfig):
    """The rank mesh: ``[S, world/S]`` with dimensions ``(axis_name,
    axis_name + '_rep')`` for ``cfg.client_shards`` S >= 1 (S = 1 keeps
    the 2-D layout of its S-shard siblings), else 1-D over every rank.
    None in a single process at S <= 1, which needs no process group.
    The client axis is padded to the rank count
    (:func:`padded_client_count`), so the client count does not
    constrain the mesh."""
    n = world_size()
    if cfg.num_devices is not None and cfg.num_devices != n:
        raise ValueError(
            f"mesh.num_devices={cfg.num_devices} but the process group has "
            f"{n} rank(s): the port drives one device a process, so the "
            "mesh spans every rank (set --num_processes instead)")
    shards = max(int(cfg.client_shards or 0), 0)
    if shards >= 1:
        if n % shards:
            raise ValueError(
                f"mesh.client_shards={shards} does not divide the "
                f"{n}-device mesh — the cohort shards are contiguous "
                "device groups, so the device count must be a "
                "multiple of the shard count")
        if n == 1:
            return None
        return _device_mesh((shards, n // shards),
                            (cfg.axis_name, cfg.axis_name + "_rep"))
    if n == 1:
        return None
    return _device_mesh((n,), (cfg.axis_name,))


def padded_client_count(num_clients: int, world: int) -> int:
    """``C_pad``: the smallest multiple of the rank count ``world`` that
    holds ``num_clients`` (the JAX package's ``padded_client_count``)."""
    return -(-num_clients // world) * world


def owned_client_rows(num_clients: int, world: Optional[int] = None,
                      rank_: Optional[int] = None):
    """``[lo, hi)``: the rows of the padded ``[C_pad]`` client axis that
    rank ``rank_`` of ``world`` holds (by default this process in the
    default process group): ``C_pad/W`` contiguous rows in rank order.
    Rows at or past ``num_clients`` are padding."""
    world = world_size() if world is None else world
    rank_ = rank() if rank_ is None else rank_
    per = padded_client_count(num_clients, world) // world
    return rank_ * per, (rank_ + 1) * per


def client_owner(client: int, num_clients: int,
                 world: Optional[int] = None) -> int:
    """The rank that holds client ``client``'s rows."""
    world = world_size() if world is None else world
    return client // (padded_client_count(num_clients, world) // world)


def mesh_client_shards(mesh) -> int:
    """Shard count of the cohort axis: dimension 0 of a 2-D mesh, 1 on a
    1-D mesh or without one."""
    if mesh is None or mesh.ndim < 2:
        return 1
    return int(mesh.shape[0])


def cohort_block(k: int, world: int, shards: int, rank_: int):
    """``[lo, hi)``, the cohort rows rank ``rank_`` of ``world`` runs:

    * ``shards`` S >= 1 (the ``[S, world/S]`` mesh): shard s = rank //
      (world/S) runs the contiguous block of k/S rows (all k at S = 1);
    * ``shards`` 0 on several ranks (the 1-D mesh): rank r runs the
      contiguous block of ``ceil(k/world)`` rows from ``r*ceil(k/world)``,
      the last ranks' shorter or empty, as GSPMD pads a ``[k]`` axis
      over ``world`` devices (k = 10 on 4 ranks: 3, 3, 3, 1);
    * one rank: all k."""
    if world <= 1 or shards == 1 or (shards > 1 and k % shards):
        return 0, k
    if shards > 1:
        per = k // shards
        s = rank_ // (world // shards)
        return s * per, (s + 1) * per
    per = -(-k // world)
    return min(rank_ * per, k), min((rank_ + 1) * per, k)


def local_cohort_rows(mesh, k: int, shards: int):
    """``[lo, hi)``, the cohort rows this rank runs and packs:
    :func:`cohort_block` of its place on ``mesh`` (S-way client sharding
    on a 2-D mesh, the ``ceil(k/W)`` block on a 1-D mesh of W ranks).
    The full range without a mesh."""
    if mesh is None:
        return 0, k
    if mesh.ndim < 2:
        return cohort_block(k, mesh.size(), 0, mesh.get_local_rank(0))
    # shard s is the rank's coordinate along mesh dimension 0: the block
    # of rank s of S ranks at S shards
    return cohort_block(k, shards, shards, mesh.get_local_rank(0))


def cohort_sharding(mesh, k: int):
    """The ``[k]`` cohort rows a rank runs: its shard's block, or its
    ``ceil(k/W)`` block on a 1-D mesh (:func:`cohort_block`)."""
    return local_cohort_rows(mesh, k, mesh_client_shards(mesh))


__all__ = ["choose_backend", "client_owner", "cohort_block", "cohort_sharding",
           "init_multihost", "local_cohort_rows", "make_mesh",
           "mesh_client_shards", "owned_client_rows", "padded_client_count",
           "rank", "ranks_on_host", "world_size"]
