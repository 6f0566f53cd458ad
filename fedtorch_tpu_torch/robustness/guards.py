"""Server-side update guards (port of ``fedtorch_tpu/robustness/guards.py``):
screen the stacked per-client deltas before aggregation.

* **non-finite rejection**: a delta with any NaN/Inf leaf is dropped;
* **norm screening**: a finite delta whose global l2 norm exceeds
  ``guard_norm_multiplier`` x the median norm of the surviving finite
  deltas is dropped (``guard_mode='reject'``) or scaled onto the
  threshold (``'clip'``, keeping its direction). The median (numpy's:
  the mean of the two middle values of an even count) makes the
  threshold scale-free.

The engine renormalizes the aggregation weights over the accepted
clients (:func:`renormalize_accepted`) and reports the counts in
``RoundMetrics``. Everything stays on the device: no host sync.

Under client sharding a rank holds only its ``[k/S]`` rows of the
deltas: :func:`screen_payloads` takes the gather that brings the whole
cohort's norms (``parallel/podscale.py`` ``gather_row_stats``), takes
the median of the ``[k]`` norms as every rank does, and screens its own
rows. Each row's norm is reduced on its own (:func:`client_delta_stats`),
so its float association does not depend on how many rows a rank holds
and S ranks judge as the unsharded twin does, bit for bit.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from fedtorch_tpu_torch.core.state import tree_leaves, tree_map


class GuardReport(NamedTuple):
    """Per-round guard outcome (device tensors)."""
    accept: torch.Tensor    # [k] float {0,1}; 1 = payload aggregated
    rejected: torch.Tensor  # scalar: candidates dropped (incl. NaN/Inf)
    clipped: torch.Tensor   # scalar: candidates norm-clipped
    norms: torch.Tensor     # [k] per-client delta l2 norm (NaN if !finite)


def mask_bcast(mask: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A [k] per-client vector shaped to broadcast against a [k, ...]
    leaf (the mask convention of the guards and the robust rules)."""
    return mask.reshape((-1,) + (1,) * (x.dim() - 1))


def _is_float(x: torch.Tensor) -> bool:
    return x.is_floating_point()


def nanquantile(x: torch.Tensor, q: float, dim: int = 0) -> torch.Tensor:
    """``jnp.nanquantile(x, q, axis=dim)`` (linear interpolation): the
    non-NaN values of each slice sorted, the value at ``q * (count - 1)``
    as ``low * (1 - w) + high * w``; NaN where a slice has none."""
    srt = torch.sort(x, dim=dim).values  # NaN sorts last
    counts = (~torch.isnan(x)).sum(dim=dim, keepdim=True).to(x.dtype)
    pos = q * (counts - 1.0)
    low, high = torch.floor(pos), torch.ceil(pos)
    w_high = pos - low
    w_low = 1.0 - w_high
    top = torch.clamp(counts - 1.0, min=0.0)
    low = torch.minimum(torch.clamp(low, min=0.0), top).long()
    high = torch.minimum(torch.clamp(high, min=0.0), top).long()
    out = srt.gather(dim, low) * w_low + srt.gather(dim, high) * w_high
    return out.squeeze(dim)


def nanmedian(x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """``jnp.nanmedian`` along ``dim`` (``torch.nanmedian`` takes the
    lower middle value of an even count instead)."""
    return nanquantile(x, 0.5, dim)


def renormalize_accepted(payload_sum, weights: torch.Tensor,
                         accept: torch.Tensor):
    """Rescale the aggregated payload so the ACCEPTED clients carry the
    full round weight (rejected weight redistributed over the survivors;
    an all-rejected round scales to 0 and the server holds).
    ``weights`` are the composed per-client aggregation weights."""
    w_total = weights.sum()
    w_accept = (weights * accept).sum()
    renorm = torch.where(w_accept > 0.0,
                         w_total / torch.clamp(w_accept, min=1e-12),
                         torch.zeros_like(w_total))
    return tree_map(lambda p: p * renorm.to(p.dtype) if _is_float(p)
                    else p, payload_sum)


def all_rejected_scalars(sc: dict) -> bool:
    """Host-side predicate over a round's fetched scalars (``n_online``,
    ``rejected``, ``dropped``): True when the round aggregated nothing,
    every surviving update rejected or every online client crashed."""
    accepted = sc["n_online"] - sc["rejected"]
    return (sc["n_online"] > 0 and accepted <= 0) \
        or (sc["n_online"] <= 0 and sc["dropped"] > 0)


def _row_square_sums(x: torch.Tensor) -> torch.Tensor:
    """[n, P] -> [n]: each row's sum of squares, reduced row by row (a
    batched reduction may split a row's sum by the row count)."""
    return torch.stack([torch.square(r).sum() for r in x.unbind(0)])


def client_delta_stats(deltas) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-client (finite, l2 norm) over a tree of [k]-leading deltas;
    non-float leaves are left out of the norm. A row's norm depends on
    that row alone, bit for bit (:func:`_row_square_sums`)."""
    leaves = [x for x in tree_leaves(deltas) if _is_float(x)]
    if not leaves:
        first = tree_leaves(deltas)[0]
        k = first.shape[0]
        return (torch.ones(k, dtype=torch.bool, device=first.device),
                torch.zeros(k, device=first.device))
    flat = [x.reshape(x.shape[0], -1) for x in leaves]
    finite = torch.stack([torch.isfinite(x).all(dim=1)
                          for x in flat]).all(dim=0)
    sq = sum(_row_square_sums(x) for x in flat)
    return finite, torch.sqrt(sq)


def screen_payloads(deltas, payloads, survive: torch.Tensor, fault,
                    rows=None, gather=None):
    """Screen the round's client updates: ``deltas`` the [k] raw client
    deltas the verdict is judged on, ``payloads`` the [k] wire payloads
    it is applied to, ``survive`` [k] the clients that reported (crashed
    ones stay out of the median). Returns (payloads', GuardReport);
    ``accept`` excludes the crashed clients, so it is the engine's
    aggregation mask.

    Under client sharding ``deltas`` and ``payloads`` hold this rank's
    cohort rows ``rows`` = ``(lo, hi)`` only, and ``gather(norms,
    finite)`` brings the whole cohort's ``[k]`` of each: the report is
    of all k clients, the screened payloads are this rank's rows."""
    finite, norms = client_delta_stats(deltas)
    if gather is not None:
        norms, finite = gather(norms, finite)
    lo, hi = rows if rows is not None else (0, norms.shape[0])
    alive = survive.to(torch.bool)
    candidate = alive & finite
    nan = torch.full_like(norms, float("nan"))
    # an all-NaN median leaves every '>' below False: no norm rejects
    med = nanmedian(torch.where(candidate, norms, nan))
    thresh = fault.guard_norm_multiplier * med
    exploded = candidate & (norms > thresh)
    if fault.guard_mode == "clip":
        accept = candidate
        scale = torch.where(exploded, thresh / torch.clamp(norms, min=1e-30),
                            torch.ones_like(norms))[lo:hi]
        payloads = tree_map(
            lambda x: x * mask_bcast(scale, x).to(x.dtype) if _is_float(x)
            else x, payloads)
        clipped = exploded.sum()
    else:
        accept = candidate & ~exploded
        clipped = torch.zeros((), dtype=torch.int64, device=norms.device)
    # zero the rejected payloads with a select, not a multiply: 0 * NaN
    # is NaN and would defeat the guard
    mine = accept[lo:hi]
    payloads = tree_map(
        lambda x: torch.where(mask_bcast(mine, x), x, torch.zeros_like(x)),
        payloads)
    rejected = alive.sum() - accept.sum()
    return payloads, GuardReport(
        accept=accept.to(torch.float32),
        rejected=rejected.to(torch.float32),
        clipped=clipped.to(torch.float32),
        norms=torch.where(finite, norms, nan))
