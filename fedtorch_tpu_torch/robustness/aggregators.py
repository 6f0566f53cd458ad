"""Byzantine-robust aggregation rules (port of
``fedtorch_tpu/robustness/aggregators.py``), at the aggregation seam of
the round (``parallel/federated.py``):

* ``mean``: the engine's weighted sum and renormalization, untouched
  (the rule is config, so 'mean' runs the round of the plain engine);
* ``median``: coordinate-wise median over the accepted updates (Yin et
  al. 2018, arXiv:1803.01498);
* ``trimmed_mean``: per coordinate, drop ``robust_trim_frac`` of the
  sorted accepted values at each end and average the rest;
* ``krum`` / ``multikrum`` (Blanchard et al. 2017, arXiv:1703.02757):
  score each update by the sum of its ``a - f - 2`` smallest pairwise
  squared distances (``f = floor(robust_trim_frac * a)`` of ``a``
  accepted updates) and keep the best one or the best ``a - f - 2``, as a
  weight mask through the guards' renormalization;
* ``norm_bound`` (centered clipping, Karimireddy et al. 2021,
  arXiv:2012.10333): each accepted update radially clipped toward the
  server momentum (the previous round's unit-scale aggregate, kept in
  the server aux) at ``robust_norm_tau`` x the median distance to it,
  then averaged.

Payloads arrive client-weighted (``w_i * u_i``): the statistics run on
``u_i = payload_i / w_i`` and every estimate is rescaled by the round's
total weight ``W = sum(w)``, so each rule keeps the round's weight and
identical updates give the mean's answer. With ``per_client=True``
(the engine's ``cohort_stats``) each rule also reports the per-client
evidence it computed (:class:`RobustReport`), and
:func:`cohort_statistics` gives the cohort's heterogeneity gauges; the
aggregate is the same either way.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from fedtorch_tpu_torch.config import ROBUST_AGGREGATORS
from fedtorch_tpu_torch.core.state import tree_leaves, tree_map
from fedtorch_tpu_torch.robustness.guards import (
    _is_float, mask_bcast as _bcast, nanmedian, nanquantile,
    renormalize_accepted,
)
# stand-in for +inf in the distance matrix: never wins an argmin, and k
# of them sum without overflowing float32
_BIG = 1e30


class RobustReport(NamedTuple):
    """What the rule did this round (device tensors). ``sel_mask`` and
    ``suspicion`` are filled only under ``per_client=True``; suspicion
    per rule:

    * ``mean``/``median``: l2 distance of the unit update to the
      (weighted mean | coordinate median) estimate over the candidates'
      median distance (honest cluster ~1, outliers >> 1);
    * ``krum``/``multikrum``: the Krum score over the candidates' median
      score;
    * ``trimmed_mean``: the fraction of the client's coordinates the
      trim window excluded;
    * ``norm_bound``: distance to the momentum over the clip radius
      (> 1: clipped).

    Non-candidates (crashed, guard-rejected, zero weight) score 0."""
    selected: torch.Tensor  # updates the rule aggregated
    trimmed: torch.Tensor   # updates excluded or clipped beyond the guards
    sel_mask: Optional[torch.Tensor] = None   # [k] {0,1} aggregated
    suspicion: Optional[torch.Tensor] = None  # [k] suspicion score


def _unit_updates(payloads, weights: torch.Tensor):
    """``u_i = payload_i / w_i`` (zero where ``w_i`` is zero: those
    clients are out of the candidates)."""
    inv = torch.where(weights > 0.0, 1.0 / torch.clamp(weights, min=1e-30),
                      torch.zeros_like(weights))
    return tree_map(lambda p: p * _bcast(inv, p).to(p.dtype)
                    if _is_float(p) else p, payloads)


def _masked_sum(payloads, mask: torch.Tensor):
    """Select-then-sum over the client axis (a select, not a multiply:
    0 * NaN is NaN)."""
    keep = mask.to(torch.bool)
    return tree_map(lambda p: torch.where(_bcast(keep, p), p,
                                          torch.zeros_like(p)).sum(dim=0),
                    payloads)


def radial_distances(unit, center=None) -> torch.Tensor:
    """[k] l2 distance of each stacked unit update to ``center`` (a tree
    of the payload's structure without the client axis; None: the
    origin), over the float leaves in float32."""
    leaves = tree_leaves(unit)
    centers = tree_leaves(center) if center is not None \
        else [None] * len(leaves)
    sq = None
    for u, m in zip(leaves, centers):
        if not _is_float(u):
            continue
        d = u.to(torch.float32)
        if m is not None:
            d = d - m[None].to(torch.float32)
        s = torch.square(d).reshape(d.shape[0], -1).sum(dim=1)
        sq = s if sq is None else sq + s
    return torch.sqrt(sq)


def radial_clip(payloads, weights: torch.Tensor, scale: torch.Tensor,
                center=None):
    """Shrink each client's unit update toward ``center`` by ``scale``
    [k] (1.0: untouched), on the weighted payloads:
    ``w*(m + (u - m)*s) == p*s + (w*(1-s))*m``; None clips toward the
    origin (``p*s``)."""
    if center is None:
        return tree_map(lambda p: p * _bcast(scale, p).to(p.dtype)
                        if _is_float(p) else p, payloads)

    def clip(p, m):
        if not _is_float(p):
            return p
        s = _bcast(scale, p).to(p.dtype)
        wm = _bcast(weights * (1.0 - scale), p).to(p.dtype)
        return p * s + wm * m[None].to(p.dtype)
    return tree_map(clip, payloads, center)


def pairwise_sq_dists(unit, cand: torch.Tensor) -> torch.Tensor:
    """[k, k] pairwise squared l2 distances of the float leaves of the
    stacked unit updates (the Gram form, clamped at 0); non-candidates'
    rows and columns and the diagonal are ``_BIG``."""
    X = torch.cat([x.reshape(x.shape[0], -1).to(torch.float32)
                   for x in tree_leaves(unit) if _is_float(x)], dim=1)
    sq = (X * X).sum(dim=1)
    d = torch.clamp(sq[:, None] + sq[None, :] - 2.0 * (X @ X.T), min=0.0)
    c = cand.to(torch.bool)
    big = torch.full_like(d, _BIG)
    d = torch.where(c[:, None] & c[None, :], d, big)
    eye = torch.eye(d.shape[0], dtype=torch.bool, device=d.device)
    return torch.where(eye, big, d)


def krum_selection(unit, cand: torch.Tensor, frac: float, multi: bool):
    """(selection mask [k], scores [k]) of Krum / Multi-Krum over the
    ``a = sum(cand)`` candidates with byzantine budget
    ``f = floor(frac * a)``: score_i sums the ``max(a - f - 2, 1)``
    smallest distances to other candidates; keep the best one (krum) or
    the best ``max(a - f - 2, 1)`` (multikrum). Ties at the boundary keep
    every tied update."""
    k = cand.shape[0]
    a = cand.sum()
    f = torch.floor(frac * a)
    closest = torch.clamp(a - f - 2.0, min=1.0)
    srt = torch.sort(pairwise_sq_dists(unit, cand), dim=1).values
    io = torch.arange(k, dtype=torch.float32, device=cand.device)[None, :]
    scores = torch.where(io < closest, srt, torch.zeros_like(srt)).sum(1)
    candb = cand.to(torch.bool)
    scores = torch.where(candb, scores, torch.full_like(scores,
                                                        float("inf")))
    n = closest if multi else torch.ones_like(closest)
    n = torch.minimum(n, torch.clamp(a, min=1.0))
    kth = torch.sort(scores).values[
        torch.clamp(n.to(torch.int64) - 1, 0, k - 1)]
    return (candb & (scores <= kth)).to(torch.float32), scores


def _trimmed_window(a: torch.Tensor, frac: float):
    """(lo, hi, width) of the kept window in the sorted candidate block:
    ``floor(frac * a)`` trimmed from each end, at least one value kept."""
    t = torch.floor(frac * a)
    t = torch.minimum(t, torch.clamp(torch.floor((a - 1.0) / 2.0), min=0.0))
    lo, hi = t, a - t
    return lo, hi, torch.clamp(hi - lo, min=1.0)


def _nan_where_not(candb: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return torch.where(candb, x, torch.full_like(x, float("nan")))


def _normalized_score(score: torch.Tensor, candb: torch.Tensor
                      ) -> torch.Tensor:
    """Score over the candidates' median score (scale-free: the honest
    cluster ~1); non-candidates and a degenerate round score 0."""
    med = nanmedian(_nan_where_not(candb, score))
    s = score / torch.clamp(med, min=1e-30)
    return torch.where(torch.isnan(s) | ~candb, torch.zeros_like(s), s)


class CohortStats(NamedTuple):
    """The heterogeneity gauges of one round's accepted cohort."""
    norm_q: torch.Tensor      # [5] unit-update-norm quantiles
                              # (min, q25, median, q75, max)
    dispersion: torch.Tensor  # 0-d: 1 - mean cos(u_i, weighted mean)
    suspicion: torch.Tensor   # [k] normalized distance to the mean


_QUANTILES = (0.0, 0.25, 0.5, 0.75, 1.0)


def cohort_statistics(payloads, weights: torch.Tensor,
                      accept: torch.Tensor) -> CohortStats:
    """The cohort statistics over the stacked ``[k]`` payloads at the
    aggregation seam, on the unit updates of the accepted candidates:
    update-norm quantiles, the cosine dispersion (an IID cohort reads
    ~0), and the distance to the weighted mean as suspicion (the
    ``mean`` rule's evidence). Leaf by leaf (``||u_i||^2``,
    ``<u_i, mean>``, ``||mean||^2``; the distance by the inner-product
    expansion), with no [k, D] concatenation."""
    cand = accept * (weights > 0.0).to(accept.dtype)
    candb = cand.to(torch.bool)
    unit = _unit_updates(payloads, weights)
    w = weights * cand
    W = torch.clamp(w.sum(), min=1e-30)
    k = weights.shape[0]
    dev = weights.device
    sq = torch.zeros(k, device=dev)   # ||u_i||^2
    dot = torch.zeros(k, device=dev)  # <u_i, mean>
    msq = torch.zeros((), device=dev)  # ||mean||^2
    for u in tree_leaves(unit):
        if not _is_float(u):
            continue
        uf = u.to(torch.float32)
        dims = tuple(range(1, uf.dim()))
        mean_l = (uf * _bcast(w, uf)).sum(dim=0) / W
        sq = sq + (uf * uf).sum(dim=dims) if dims else sq + uf * uf
        dot = dot + ((uf * mean_l[None]).sum(dim=dims) if dims
                     else uf * mean_l[None])
        msq = msq + (mean_l * mean_l).sum()
    norms = torch.sqrt(sq)
    masked = _nan_where_not(candb, norms)
    norm_q = torch.stack([nanquantile(masked, q) for q in _QUANTILES])
    norm_q = torch.where(torch.isnan(norm_q), torch.zeros_like(norm_q),
                         norm_q)
    mnorm = torch.sqrt(msq)
    cos = dot / torch.clamp(norms * mnorm, min=1e-30)
    dispersion = 1.0 - (cos * cand).sum() / torch.clamp(cand.sum(),
                                                          min=1.0)
    # ||u_i - mean||^2 = ||u_i||^2 - 2<u_i, mean> + ||mean||^2, clamped
    dist = torch.sqrt(torch.clamp(sq - 2.0 * dot + msq, min=0.0))
    return CohortStats(norm_q=norm_q, dispersion=dispersion,
                       suspicion=_normalized_score(dist, candb))


def robust_aggregate(rule: str, payloads, weights: torch.Tensor,
                     accept: torch.Tensor, fault, momentum=None,
                     per_client: bool = False):
    """Aggregate the stacked ``[k, ...]`` payloads under ``rule``:
    ``accept`` the engine's {0,1} mask, ``weights`` the aggregation
    weights (the algorithm's base weights x the async staleness
    weights). Returns ``(payload_sum, new_momentum, RobustReport)``, the
    sum scaled to the full round weight ``sum(weights)``; the momentum is
    None except under ``norm_bound``. ``per_client=True`` also fills the
    report's ``sel_mask`` and ``suspicion``; the sum is unchanged."""
    if rule not in ROBUST_AGGREGATORS:
        raise ValueError(f"unknown robust_agg {rule!r}; expected one of "
                         f"{ROBUST_AGGREGATORS}")
    k = weights.shape[0]
    cand = accept * (weights > 0.0).to(accept.dtype)
    candb = cand.to(torch.bool)
    a = cand.sum()
    W = weights.sum()
    zero = torch.zeros_like(W)

    if rule == "mean":
        payload_sum = renormalize_accepted(_masked_sum(payloads, cand),
                                           weights, cand)
        rep = RobustReport(selected=a, trimmed=zero)
        if per_client:
            cs = cohort_statistics(payloads, weights, accept)
            rep = rep._replace(sel_mask=cand, suspicion=cs.suspicion)
        return payload_sum, None, rep

    unit = _unit_updates(payloads, weights)
    if rule in ("krum", "multikrum"):
        sel, scores = krum_selection(unit, cand, fault.robust_trim_frac,
                                     multi=rule == "multikrum")
        # the selection rides the same renormalization as the guards'
        # rejections: the selected clients carry the full round weight
        payload_sum = renormalize_accepted(_masked_sum(payloads, sel),
                                           weights, sel)
        n_sel = sel.sum()
        rep = RobustReport(selected=n_sel,
                           trimmed=torch.clamp(a - n_sel, min=0.0))
        if per_client:
            rep = rep._replace(sel_mask=sel,
                               suspicion=_normalized_score(scores, candb))
        return payload_sum, None, rep

    def masked(u, fill):
        return torch.where(_bcast(candb, u), u.to(torch.float32),
                           torch.full_like(u, fill, dtype=torch.float32))

    def candidates_sum(u):  # a non-float wire leaf
        return torch.where(_bcast(candb, u), u, torch.zeros_like(u)).sum(0)

    if rule == "median":
        def med(u):
            m = nanmedian(masked(u, float("nan")), dim=0)
            return torch.where(torch.isnan(m), torch.zeros_like(m), m) \
                .to(u.dtype)

        def agg(u):
            if not _is_float(u):
                return candidates_sum(u)
            return (med(u).to(torch.float32) * W).to(u.dtype)
        rep = RobustReport(selected=a, trimmed=zero)
        if per_client:
            # distance to the coordinate-median estimate
            sq = zero
            for u in tree_leaves(unit):
                if not _is_float(u):
                    continue
                diff = u.to(torch.float32) - med(u)[None].to(torch.float32)
                sq = sq + torch.square(diff).reshape(
                    diff.shape[0], -1).sum(dim=1)
            rep = rep._replace(
                sel_mask=cand,
                suspicion=_normalized_score(torch.sqrt(sq), candb))
        return tree_map(agg, unit), None, rep

    if rule == "trimmed_mean":
        lo, hi, width = _trimmed_window(a, fault.robust_trim_frac)
        io = torch.arange(k, dtype=torch.float32, device=weights.device)

        def agg(u):
            if not _is_float(u):
                return candidates_sum(u)
            # non-candidates sort to the end (+inf): indices [0, a) are
            # exactly the candidate block
            srt = torch.sort(masked(u, float("inf")), dim=0).values
            i = _bcast(io, u)
            keep = (i >= lo) & (i < hi)
            s = torch.where(keep, srt, torch.zeros_like(srt)).sum(dim=0)
            return (s / width * W).to(u.dtype)
        rep = RobustReport(selected=width,
                           trimmed=torch.clamp(a - width, min=0.0))
        if per_client:
            # each client's share of coordinates outside the kept
            # [lo, hi) window of its coordinate's sorted candidates (the
            # rank of each row: a double argsort)
            out_coords = torch.zeros(k, device=weights.device)
            n_coords = 0
            for u in tree_leaves(unit):
                if not _is_float(u):
                    continue
                ranks = torch.argsort(torch.argsort(
                    masked(u, float("inf")), dim=0, stable=True), dim=0,
                    stable=True).to(torch.float32)
                out = (ranks < lo) | (ranks >= hi)
                out_coords = out_coords + out.to(torch.float32).reshape(
                    k, -1).sum(dim=1)
                n_coords += int(math.prod(u.shape[1:]))
            frac = out_coords / max(float(n_coords), 1.0)
            rep = rep._replace(sel_mask=cand, suspicion=torch.where(
                candb, frac, torch.zeros_like(frac)))
        return tree_map(agg, unit), None, rep

    # norm_bound: radial clip toward the server momentum, then the
    # renormalized weighted mean over the candidates
    if momentum is None:
        raise ValueError("robust_agg='norm_bound' needs the server "
                         "momentum tree (the server aux's 'norm_bound_m')")
    dist = radial_distances(unit, momentum)
    med_d = nanmedian(torch.where(candb, dist,
                                  torch.full_like(dist, float("nan"))))
    tau = fault.robust_norm_tau * med_d
    tau = torch.where(torch.isnan(tau), torch.zeros_like(tau), tau)
    scale = torch.clamp(tau / torch.clamp(dist, min=1e-30), max=1.0)
    clipped = radial_clip(payloads, weights, scale, center=momentum)
    payload_sum = renormalize_accepted(_masked_sum(clipped, cand), weights,
                                       cand)
    # the momentum: this round's unit-scale aggregate, the center the
    # next round clips toward
    inv_w = torch.where(W > 0.0, 1.0 / torch.clamp(W, min=1e-30), zero)
    new_momentum = tree_map(
        lambda p, m: (p.to(torch.float32) * inv_w).to(m.dtype)
        if _is_float(p) else m, payload_sum, momentum)
    n_clipped = (cand * (scale < 1.0).to(cand.dtype)).sum()
    rep = RobustReport(selected=a, trimmed=n_clipped)
    if per_client:
        # distance to the momentum over the clip radius: > 1 == clipped
        susp = dist / torch.clamp(tau, min=1e-30)
        rep = rep._replace(sel_mask=cand, suspicion=torch.where(
            candb, susp, torch.zeros_like(susp)))
    return payload_sum, new_momentum, rep
