"""Pod-scale hierarchical aggregation (port of
``fedtorch_tpu/parallel/podscale.py``): the client-axis sharded twin of
the round's weighted payload sum.

The k online clients of a round are split over S contiguous rank groups
(``parallel/mesh.py`` :func:`~fedtorch_tpu_torch.parallel.mesh.
local_cohort_rows`): the ranks of group s run the local loops of cohort
rows ``[s*k/S, (s+1)*k/S)`` and hold those rows of the stacked ``[k,
...]`` payloads. Float addition is not associative, so the sum fixes its
association as a function of k alone:

* the k clients are split into ``G = min(64, largest power of two
  dividing k)`` groups of k/G consecutive clients;
* **level 1**: each group's partial is a left-deep chain over its
  members (``acc = x[0]; acc = acc + x[1]; ...``), on the rank that owns
  the group (S divides G, so no group straddles two ranks);
* **collective**: exactly one ``torch.distributed.all_gather`` over the
  process group of mesh dimension 0 brings every rank the ``[G, P]``
  partials in global order (rank order along that dimension is group
  order, since the cohort blocks are contiguous);
* **level 2**: one left-deep chain over the G partials, the same on
  every rank.

Both chains' lengths and orders depend on k only, so S ranks give the
bytes of the unsharded S=1 twin, and a checkpoint taken at S=4 resumes
on S=2 with the same sums. Integer leaves (the quantized wire formats)
take a plain ``sum`` in their own dtype, as ``jnp.sum`` keeps it:
integer addition is exact in any order.

Where the port differs: the JAX package gathers only the float partials
and lets GSPMD move everything else. Here every rank holds the whole
replicated rest of the round, so what that rest needs of the other
ranks' clients rides the same one gather as raw bytes (``riders``: the
integer leaves' rows and the per-client rows the caller names). The
gather is staged through a pinned host buffer when the process group is
gloo and the rows lie on a card (gloo's all-gather takes host tensors);
NCCL gathers on the card.

More collectives carry what GSPMD moves for the JAX package, each with
a counter and a byte count of its own (the JAX ``collective_budget``,
and so :func:`collective_count`, counts the seam's gather alone):

* **the exchange** (:func:`exchange_rows`): the client state and, on the
  device data plane, the population are sharded over the ranks
  (``parallel/mesh.py`` :func:`~fedtorch_tpu_torch.parallel.mesh.
  owned_client_rows`), so once a round, before the local loops, one
  ``all_to_all_single`` over every rank brings each rank its cohort
  block's rows from their owners;
* **the guards' norm gather** (:func:`gather_row_stats`): the update
  guards take the median over the whole cohort's update norms, so each
  rank's ``[k/S]`` norms and candidate flags are gathered to every rank
  of its shard group before the screen;
* **the cohort gather** (:func:`gather_cohort`), at ``client_shards`` 0
  on W > 1 ranks (the JAX package's 1-D mesh, where GSPMD places every
  cross-client reduction and no seam runs): each rank runs its
  ``ceil(k/W)`` rows of the cohort, then one ``all_gather`` brings
  every rank every client's rows of what the rest of the round reads,
  and every rank runs that rest on the whole cohort, as one rank does.
  Where a rank's block is empty (k not above ``(W-1)*ceil(k/W)``) it
  cannot know the rows' layout: rank 0 sends it once, by one
  ``broadcast_object_list`` (:func:`cohort_layout`, counted under
  'layout').
"""
from __future__ import annotations

import math

import numpy as np
import torch

from fedtorch_tpu_torch.core.state import tree_fill, tree_leaves, tree_map
from fedtorch_tpu_torch.parallel.mesh import cohort_block

# cap on the group count: bounds the level-2 chain while leaving every
# shard count up to 64 a whole number of groups per shard
MAX_AGG_GROUPS = 64

# [collectives, bytes] this rank has issued and received, by kind:
# 'seam' the all_gathers of :func:`cohort_hierarchical_sum` (the tests,
# the chip check and the trainer's ``cohort_gather_bytes`` gauge read
# them), 'exchange' :func:`exchange_rows`, 'norms'
# :func:`gather_row_stats`, 'cohort' :func:`gather_cohort`, 'layout'
# :func:`cohort_layout`
_COUNTS = {"seam": [0, 0], "exchange": [0, 0], "norms": [0, 0],
           "cohort": [0, 0], "layout": [0, 0]}


def reset_collective_count() -> None:
    for c in _COUNTS.values():
        c[0] = c[1] = 0


def collective_count(kind: str = "seam") -> int:
    """Collectives of ``kind`` issued since the last reset: by default
    the seam's gathers, the count the JAX ``collective_budget`` gives."""
    return _COUNTS[kind][0]


def gathered_bytes(kind: str = "seam") -> int:
    """Bytes the collectives of ``kind`` brought this rank. The seam's:
    the whole ``[S, n]`` buffers, the partials and every rider, this
    rank's own rows included; the exchange's: the rows that came from
    other ranks; the norm gather's: the whole ``[S, n]`` buffers."""
    return _COUNTS[kind][1]


def _count(kind: str, nbytes: int) -> None:
    _COUNTS[kind][0] += 1
    _COUNTS[kind][1] += int(nbytes)


def cohort_group_count(k: int) -> int:
    """G, the shard-invariant group count of a k-wide cohort: the
    largest power of two dividing k, capped at :data:`MAX_AGG_GROUPS`."""
    if k <= 0:
        raise ValueError(f"cohort width must be positive, got {k}")
    return min(MAX_AGG_GROUPS, k & -k)


def _left_deep(rows: torch.Tensor) -> torch.Tensor:
    """Left-deep add chain over the leading axis."""
    acc = rows[0]
    for i in range(1, rows.shape[0]):
        acc = acc + rows[i]
    return acc


def _group_partials(flat: torch.Tensor, groups: int) -> torch.Tensor:
    """[rows, P] -> [groups, P]: left-deep over each group's
    rows/groups consecutive members."""
    per = flat.shape[0] // groups
    xg = flat.reshape(groups, per, flat.shape[1])
    acc = xg[:, 0]
    for j in range(1, per):
        acc = acc + xg[:, j]
    return acc


def cohort_allreduce_bytes(payloads, k: int) -> float:
    """Bytes of the ``[G, P]`` float partial stack the seam's one gather
    brings each rank a round (the ``cohort_allreduce_bytes`` gauge, the
    JAX package's definition: the float payload leaves only). The
    riders make the gather larger: :func:`gathered_bytes` counts the
    whole buffer."""
    total = 0
    for leaf in tree_leaves(payloads):
        if leaf.is_floating_point():
            n = int(np.prod(leaf.shape[1:])) if leaf.dim() > 1 else 1
            total += n * leaf.element_size()
    return float(cohort_group_count(k) * total)


def _as_bytes(t: torch.Tensor) -> torch.Tensor:
    """A tensor's raw bytes as a flat uint8 tensor."""
    t = t.contiguous()
    if t.dtype == torch.bool:
        t = t.to(torch.uint8)
    return t.reshape(-1).view(torch.uint8)


def _from_bytes(b: torch.Tensor, like: torch.Tensor, lead: int):
    """The inverse of :func:`_as_bytes` for ``lead`` rows shaped as
    ``like``'s rows."""
    shape = (lead,) + tuple(like.shape[1:])
    # a fresh copy: a slice of the gathered bytes need not be aligned
    # for ``like``'s dtype
    b = b.clone()
    if like.dtype == torch.bool:
        return b.view(torch.uint8).reshape(shape).to(torch.bool)
    return b.view(like.dtype).reshape(shape)


def host_staged(buf: torch.Tensor, group) -> torch.Tensor:
    """``buf`` where the group's collectives take it: a gloo group takes
    host tensors, so rows on a card are copied into a pinned host
    buffer."""
    import torch.distributed as dist
    if buf.device.type == "cuda" \
            and dist.get_backend(group) == dist.Backend.GLOO:
        src = torch.empty(buf.shape, dtype=torch.uint8, pin_memory=True)
        src.copy_(buf)
        return src
    return buf


def _all_gather_bytes(buf: torch.Tensor, group, shards: int,
                      kind: str = "seam") -> torch.Tensor:
    """[n] uint8 on this rank -> [shards, n] uint8, rank order along the
    group: one ``all_gather`` (staged through host memory on gloo,
    :func:`host_staged`), counted under ``kind``."""
    import torch.distributed as dist
    src = host_staged(buf, group)
    out = torch.empty((shards,) + tuple(src.shape), dtype=torch.uint8,
                      device=src.device)
    dist.all_gather(list(out.unbind(0)), src, group=group)
    _count(kind, out.numel())
    return out.to(buf.device)


def rows_as_bytes(tensors, n: int) -> torch.Tensor:
    """Tensors of ``n`` leading rows -> ``[n, row_bytes]`` uint8, each
    row the concatenation of every tensor's row bytes."""
    parts = []
    for t in tensors:
        t = t.contiguous()
        if t.dtype == torch.bool:
            t = t.to(torch.uint8)
        parts.append(t.reshape(n, math.prod(t.shape[1:])).view(torch.uint8))
    return torch.cat(parts, dim=1) if parts \
        else torch.empty((n, 0), dtype=torch.uint8)


def row_bytes(likes) -> int:
    """Bytes of one row of :func:`rows_as_bytes` over tensors of the
    ``(row_shape, dtype)`` of ``likes`` (a bool as one byte)."""
    return sum(math.prod(shape) * torch.empty((), dtype=dtype).element_size()
               for shape, dtype in likes)


def bytes_as_rows(rows: torch.Tensor, likes) -> list:
    """The inverse of :func:`rows_as_bytes`: ``[n, row_bytes]`` uint8 ->
    one tensor a ``(row_shape, dtype)`` of ``likes``, ``n`` rows each."""
    n, out, off = rows.shape[0], [], 0
    for shape, dtype in likes:
        width = row_bytes([(shape, dtype)])
        # a fresh copy: a column slice is neither contiguous nor aligned
        # for ``dtype``
        b = rows[:, off:off + width].contiguous()
        t = b.view(torch.uint8 if dtype == torch.bool else dtype)
        t = t.reshape((n,) + tuple(shape))
        out.append(t.to(torch.bool) if dtype == torch.bool else t)
        off += width
    return out


def gather_row_stats(norms: torch.Tensor, flags: torch.Tensor, mesh,
                     shards: int):
    """This rank's ``[k/S]`` float32 ``norms`` and bool ``flags`` ->
    the whole cohort's ``[k]`` of each, in cohort order: one
    ``all_gather`` over mesh dimension 0 (the guards' norm gather,
    counted under 'norms')."""
    n = norms.shape[0]
    buf = rows_as_bytes([norms.to(torch.float32), flags.to(torch.bool)], n)
    full = _all_gather_bytes(buf.reshape(-1), mesh.get_group(0), shards,
                             kind="norms")
    norms_k, flags_k = bytes_as_rows(
        full.reshape(shards * n, -1), [((), torch.float32),
                                       ((), torch.bool)])
    return norms_k, flags_k


def exchange_rows(pack, sizes, want, owner, me: int, world: int,
                  device) -> torch.Tensor:
    """Each rank's rows from their owners: one ``all_to_all_single`` over
    the default process group (counted under 'exchange'; staged through
    pinned host memory on gloo).

    ``want[r]`` lists the keys rank r needs, in its order, the same
    lists on every rank; ``owner[key]`` the rank that holds each key's
    row and ``sizes[key]`` its bytes; ``pack(keys)`` gives this rank's
    rows of ``keys`` (all its own), concatenated as flat uint8 on
    ``device``. Returns the rows of ``want[me]``, concatenated in its
    order. The byte count is of the rows that came from other ranks."""
    import torch.distributed as dist
    send_keys = [key for r in range(world) for key in want[r]
                 if owner[key] == me]
    send_split = [sum(sizes[key] for key in want[r] if owner[key] == me)
                  for r in range(world)]
    # what arrives: grouped by the sending rank, each group in want[me]'s
    # order
    arrive = [i for o in range(world) for i, key in enumerate(want[me])
              if owner[key] == o]
    recv_split = [sum(sizes[key] for key in want[me] if owner[key] == o)
                  for o in range(world)]
    send = pack(send_keys) if send_keys \
        else torch.empty(0, dtype=torch.uint8, device=device)
    group = dist.group.WORLD
    src = host_staged(send, group)
    recv = torch.empty(sum(recv_split), dtype=torch.uint8,
                       device=src.device)
    dist.all_to_all_single(recv, src, recv_split, send_split, group=group)
    _count("exchange", sum(recv_split) - recv_split[me])
    recv = recv.to(device)
    rows, off = [None] * len(want[me]), 0
    for i in arrive:
        n = sizes[want[me][i]]
        rows[i] = recv[off:off + n]
        off += n
    return torch.cat(rows) if rows \
        else torch.empty(0, dtype=torch.uint8, device=device)


def cohort_layout(parts):
    """The tree ``parts`` as rank 0 holds it, with zero-row host leaves:
    what a rank with an empty cohort block needs to read the cohort
    gather's rows (one ``broadcast_object_list`` from rank 0, counted
    under 'layout'; ``parts`` is read on rank 0 only)."""
    import torch.distributed as dist
    box = [None]
    if dist.get_rank() == 0:
        box[0] = tree_map(lambda t: t[:0].cpu()
                          if isinstance(t, torch.Tensor) else t, parts)
    dist.broadcast_object_list(box, src=0)
    _count("layout", 0)
    return box[0]


def gather_cohort(parts, k: int, device, layout=None):
    """The whole ``[k]`` cohort's rows of a tree on every rank of a 1-D
    mesh: ``parts`` holds this rank's rows, its block of
    :func:`~fedtorch_tpu_torch.parallel.mesh.cohort_block` (None where
    the block is empty; ``layout``, from :func:`cohort_layout`, then
    gives the tree). One ``all_gather`` over the default process group
    of ``ceil(k/W)`` rows a rank, each row every leaf's row bytes, the
    short blocks padded (counted under 'cohort', the whole buffer);
    returns the tree with every leaf's k rows in cohort order, on
    ``device``."""
    import torch.distributed as dist
    world, me = dist.get_world_size(), dist.get_rank()
    blocks = [cohort_block(k, world, 0, r) for r in range(world)]
    tree = parts if parts is not None else layout
    likes = [(tuple(t.shape[1:]), t.dtype) for t in tree_leaves(tree)]
    per, width = -(-k // world), row_bytes(likes)
    lo, hi = blocks[me]
    buf = torch.zeros((per, width), dtype=torch.uint8, device=device)
    if hi > lo:
        buf[:hi - lo] = rows_as_bytes(tree_leaves(parts), hi - lo)
    full = _all_gather_bytes(buf.reshape(-1), dist.group.WORLD, world,
                             kind="cohort").reshape(world, per, width)
    rows = torch.cat([full[r, :b - a] for r, (a, b) in enumerate(blocks)])
    return tree_fill(tree, bytes_as_rows(rows, likes))


def cohort_hierarchical_sum(payloads, mesh=None, shards: int = 1,
                            riders=None):
    """Sum the stacked payload tree over the cohort axis with the
    shard-invariant grouped association (module docstring).

    ``shards <= 1``: ``payloads`` holds all k rows and the same chains
    run with no collective (the twin every sharded run is held to).
    ``shards > 1``: ``payloads`` holds this rank's k/S rows, ``mesh``
    is the rank's :class:`~torch.distributed.device_mesh.DeviceMesh`
    (the gather runs over its dimension 0), and ``riders`` (a tree of
    tensors with a leading axis of this rank's k/S rows, or None) rides
    the same gather; the call then returns ``(sum, riders' [k] rows in
    cohort order)``. Without ``riders`` it returns the sum alone."""
    leaves = tree_leaves(payloads)
    float_ix = [i for i, leaf in enumerate(leaves)
                if leaf.is_floating_point()]
    int_ix = [i for i, leaf in enumerate(leaves)
              if not leaf.is_floating_point()]
    rider_leaves = tree_leaves(riders) if riders is not None else []
    if not leaves and not rider_leaves:
        return payloads if riders is None else (payloads, riders)
    k_loc = (leaves or rider_leaves)[0].shape[0]
    k = k_loc * max(shards, 1)
    out = [None] * len(leaves)
    summed = None
    if float_ix:
        groups = cohort_group_count(k)
        if shards > 1 and (k % shards or groups % shards):
            raise ValueError(
                f"cohort width {k} does not shard {shards} ways "
                "(validate_cell refuses this cell)")
        flat = torch.cat([leaves[i].reshape(k_loc, -1) for i in float_ix],
                         dim=1)
        partial = _group_partials(flat, groups // max(shards, 1))
    if shards <= 1:
        if float_ix:
            summed = _left_deep(partial)
        for i in int_ix:
            out[i] = leaves[i].sum(dim=0, dtype=leaves[i].dtype)
        gathered_riders = riders
    else:
        # one buffer of raw bytes: the partials, then every integer
        # leaf's rows, then every rider's rows
        parts = ([partial] if float_ix else []) \
            + [leaves[i] for i in int_ix] + list(rider_leaves)
        pieces = [_as_bytes(t) for t in parts]
        sizes = [p.numel() for p in pieces]
        full = _all_gather_bytes(torch.cat(pieces), mesh.get_group(0),
                                 shards)
        offs = np.concatenate([[0], np.cumsum(sizes)]).tolist()
        per_rank = [[full[s, offs[j]:offs[j + 1]] for j in range(len(parts))]
                    for s in range(shards)]

        def rows_of(j, like):
            lead = like.shape[0]
            return torch.cat([_from_bytes(per_rank[s][j], like, lead)
                              for s in range(shards)])
        j = 0
        if float_ix:
            summed = _left_deep(rows_of(0, partial))
            j = 1
        for i in int_ix:
            out[i] = rows_of(j, leaves[i]).sum(dim=0,
                                               dtype=leaves[i].dtype)
            j += 1
        gathered_riders = tree_fill(riders, [
            rows_of(j + n, t) for n, t in enumerate(rider_leaves)]) \
            if riders is not None else None
    if float_ix:
        off = 0
        for i in float_ix:
            shape = leaves[i].shape[1:]
            size = int(math.prod(shape))
            out[i] = summed[off:off + size].reshape(shape)
            off += size
    total = tree_fill(payloads, out)
    return total if riders is None else (total, gathered_riders)


__all__ = ["MAX_AGG_GROUPS", "bytes_as_rows", "cohort_allreduce_bytes",
           "cohort_group_count", "cohort_hierarchical_sum",
           "cohort_layout", "collective_count", "exchange_rows",
           "gather_cohort", "gather_row_stats",
           "gathered_bytes", "host_staged", "reset_collective_count",
           "row_bytes", "rows_as_bytes"]
