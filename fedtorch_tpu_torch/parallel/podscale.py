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
"""
from __future__ import annotations

import math

import numpy as np
import torch

from fedtorch_tpu_torch.core.state import tree_leaves, tree_map

# cap on the group count: bounds the level-2 chain while leaving every
# shard count up to 64 a whole number of groups per shard
MAX_AGG_GROUPS = 64

# the all_gathers :func:`cohort_hierarchical_sum` has issued and the
# bytes they brought this rank (the tests, the chip check and the
# trainer's ``cohort_gather_bytes`` gauge read them)
_gathers = 0
_gathered_bytes = 0


def reset_collective_count() -> None:
    global _gathers, _gathered_bytes
    _gathers = 0
    _gathered_bytes = 0


def collective_count() -> int:
    return _gathers


def gathered_bytes() -> int:
    """Bytes of the whole ``[S, n]`` buffers the gathers brought this
    rank: the partials and every rider, this rank's own rows included."""
    return _gathered_bytes


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


def _rebuild(tree, values):
    """``tree`` with its tensor leaves replaced by ``values`` in order."""
    it = iter(values)
    return tree_map(lambda x: next(it) if isinstance(x, torch.Tensor)
                    else x, tree)


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


def _all_gather_bytes(buf: torch.Tensor, group, shards: int
                      ) -> torch.Tensor:
    """[n] uint8 on this rank -> [shards, n] uint8, rank order along the
    group: one ``all_gather``. A gloo group takes host tensors, so rows
    on a card are staged through a pinned host buffer and copied back."""
    import torch.distributed as dist
    stage = buf.device.type == "cuda" \
        and dist.get_backend(group) == dist.Backend.GLOO
    src = buf
    if stage:
        src = torch.empty(buf.shape, dtype=torch.uint8, pin_memory=True)
        src.copy_(buf)
    out = torch.empty((shards,) + tuple(src.shape), dtype=torch.uint8,
                      device=src.device)
    dist.all_gather(list(out.unbind(0)), src, group=group)
    global _gathers, _gathered_bytes
    _gathers += 1
    _gathered_bytes += out.numel()
    return out.to(buf.device) if stage else out


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
        gathered_riders = _rebuild(riders, [
            rows_of(j + n, t) for n, t in enumerate(rider_leaves)]) \
            if riders is not None else None
    if float_ix:
        off = 0
        for i in float_ix:
            shape = leaves[i].shape[1:]
            size = int(math.prod(shape))
            out[i] = summed[off:off + size].reshape(shape)
            off += size
    total = _rebuild(payloads, out)
    return total if riders is None else (total, gathered_riders)


__all__ = ["MAX_AGG_GROUPS", "cohort_allreduce_bytes", "cohort_group_count",
           "cohort_hierarchical_sum", "collective_count", "gathered_bytes",
           "reset_collective_count"]
