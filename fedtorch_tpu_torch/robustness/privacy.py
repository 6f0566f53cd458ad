"""Privacy plane (port of ``fedtorch_tpu/robustness/privacy.py``):
DP-FedAvg's clipped-noise aggregation and a streaming RDP accountant
(docs/robustness.md "Privacy plane").

* **The DP stage** at the round's aggregation seam
  (``parallel/federated.py``): every reporting client's
  per-unit-weight update is radially L2-clipped to ``dp_clip_norm``
  through the clip of ``norm_bound`` (``aggregators.radial_distances``
  / ``radial_clip``), and Gaussian noise at ``sigma = dp_noise_multiplier
  * dp_clip_norm / k`` is added to the weighted estimate (McMahan et
  al. 2018, arXiv:1710.06963). The order is pinned: accept mask -> DP
  clip -> robust rule -> DP noise. Where the JAX package folds
  ``DP_SALT`` into the round key, the port's round plan carries one
  int64 seed, and each leaf's normals are drawn on the round's device
  from ``fold_key(seed, leaf index)`` (``chaos.leaf_normals``), or
  injected.
* **The accountant** (:class:`PrivacyAccountant`, a copy of the JAX
  package's, stdlib only): an f64 RDP accountant (Mironov 2017,
  arXiv:1702.07476; the subsampled Gaussian of Mironov et al. 2019,
  arXiv:1908.10530) charging one subsampled-Gaussian release per
  committed round at the run's participation probability. Its state
  saves to ``privacy_accountant.json`` (atomic tmp + replace) and
  adopts on resume, refusing a document of another mechanism by name.
"""
from __future__ import annotations

import json
import math
import os
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from fedtorch_tpu_torch.models.common import fold_key
from fedtorch_tpu_torch.robustness import chaos as _chaos
from fedtorch_tpu_torch.robustness.aggregators import (
    _unit_updates, radial_clip, radial_distances,
)
from fedtorch_tpu_torch.robustness.guards import _is_float

ACCOUNTANT_SCHEMA = "fedtorch_tpu.privacy_accountant/v1"
ACCOUNTANT_FILE = "privacy_accountant.json"

# Renyi orders the accountant tracks: dense fractional coverage where
# the conversion optimum usually lands (alpha* = 1 + sqrt(2 z^2
# log(1/delta) / T) for the pure Gaussian), integers through 63, then
# a sparse large-alpha tail. Dense-enough that the grid minimum is
# within 1% of the continuous closed form (pinned in
# tests/test_privacy.py).
DEFAULT_ORDERS: Tuple[float, ...] = (
    tuple(1.0 + i / 8.0 for i in range(1, 81))
    + tuple(float(a) for a in range(12, 64))
    + (72.0, 96.0, 128.0, 192.0, 256.0, 512.0))


# -- RDP math (pure stdlib f64) ------------------------------------------

def gaussian_rdp(noise_multiplier: float, order: float) -> float:
    """RDP(alpha) of one Gaussian release at sensitivity 1 and noise
    stddev ``z = noise_multiplier``: ``alpha / (2 z^2)`` (Mironov
    2017, Prop. 7) — exact at every real alpha > 1."""
    return float(order) / (2.0 * float(noise_multiplier) ** 2)


def _log_comb(n: int, k: int) -> float:
    return (math.lgamma(n + 1) - math.lgamma(k + 1)
            - math.lgamma(n - k + 1))


def _integer_subsampled_rdp(q: float, noise_multiplier: float,
                            alpha: int) -> float:
    """The Mironov et al. 2019 Thm 11 binomial closed form at INTEGER
    alpha >= 2, evaluated via logsumexp in f64:

        RDP(alpha) = log( sum_{j=0}^{alpha} C(alpha, j) (1-q)^{alpha-j}
                          q^j exp(j (j-1) / (2 z^2)) ) / (alpha - 1)
    """
    z2 = float(noise_multiplier) ** 2
    log_q, log_1mq = math.log(q), math.log1p(-q)
    log_terms = [
        _log_comb(alpha, j) + j * log_q + (alpha - j) * log_1mq
        + (j * (j - 1)) / (2.0 * z2)
        for j in range(alpha + 1)]
    m = max(log_terms)
    lse = m + math.log(sum(math.exp(t - m) for t in log_terms))
    return lse / (alpha - 1.0)


def subsampled_gaussian_rdp(q: float, noise_multiplier: float,
                            order: float) -> float:
    """RDP(alpha) of one Poisson-subsampled Gaussian release at
    sampling probability ``q`` (:func:`_integer_subsampled_rdp`'s
    binomial closed form at integer alpha).

    The closed form holds at INTEGER alpha >= 2. A fractional order
    is charged by CONVEXITY OF THE CGF rather than rounding up: the
    moment-generating function ``cgf(alpha) = (alpha-1) RDP(alpha)``
    is convex in alpha (it is a log of a moment, Van Erven & Harremoes
    2014), and ``cgf(1) = 0`` exactly, so with ``n = floor(alpha)``
    and ``t = alpha - n``:

        cgf(alpha) <= (1-t) cgf(n) + t cgf(n+1)
        RDP(alpha) <= [(1-t) cgf(n) + t cgf(n+1)] / (alpha - 1)

    — still a valid upper bound, but strictly tighter than the old
    ``ceil(alpha)`` charge whenever ``n >= 2`` (the chord lies below
    ``cgf(n+1)``; at ``n = 1`` the ``cgf(1) = 0`` anchor makes the
    chord reproduce the RDP(2) charge exactly). The tightening is
    what lets the dense fractional head of :data:`DEFAULT_ORDERS`
    actually land the conversion optimum between integers instead of
    snapping to it. ``q >= 1`` falls back to the exact un-subsampled
    Gaussian RDP, which holds at every real alpha > 1."""
    if q <= 0.0:
        return 0.0
    if q >= 1.0:
        return gaussian_rdp(noise_multiplier, order)
    n = int(math.floor(order))
    if n >= 2 and float(n) == float(order):
        return _integer_subsampled_rdp(q, noise_multiplier, n)
    n = max(n, 1)
    t = float(order) - n

    def cgf(a: int) -> float:
        return 0.0 if a <= 1 else \
            (a - 1.0) * _integer_subsampled_rdp(q, noise_multiplier, a)

    return ((1.0 - t) * cgf(n) + t * cgf(n + 1)) / (float(order) - 1.0)


def rdp_to_epsilon(orders: Sequence[float], rdp: Sequence[float],
                   delta: float) -> float:
    """Classic RDP -> (eps, delta) conversion, minimized over the
    tracked orders: ``eps = min_a [RDP(a) + log(1/delta)/(a - 1)]``
    (Mironov 2017, Prop. 3)."""
    if not 0.0 < delta < 1.0:
        raise ValueError(f"delta must be in (0, 1), got {delta}")
    log_inv_delta = math.log(1.0 / delta)
    best = math.inf
    for a, r in zip(orders, rdp):
        if a <= 1.0:
            continue
        best = min(best, r + log_inv_delta / (a - 1.0))
    return best


def closed_form_epsilon(noise_multiplier: float, rounds: int,
                        delta: float) -> float:
    """CONTINUOUS-alpha optimum of the classic conversion for T
    compositions of the pure (no-subsampling) Gaussian mechanism:

        eps* = T / (2 z^2) + sqrt(2 T log(1/delta)) / z

    (minimize ``T a/(2 z^2) + log(1/delta)/(a-1)`` over real a > 1).
    The no-subsampling control the accountant's order grid is
    validated against — the grid minimum must land within 1%."""
    z, T = float(noise_multiplier), float(rounds)
    return (T / (2.0 * z * z)
            + math.sqrt(2.0 * T * math.log(1.0 / delta)) / z)


def calibrate_noise_multiplier(target_epsilon: float, rounds: int,
                               q: float, delta: float,
                               orders: Sequence[float] = DEFAULT_ORDERS
                               ) -> float:
    """Smallest noise multiplier z whose accounted epsilon after
    ``rounds`` subsampled releases at probability ``q`` stays <=
    ``target_epsilon`` — bisection over the accountant itself, so the
    calibration and the runtime charge can never disagree (the
    privacy-matrix frontier uses this to hit its eps targets)."""
    if target_epsilon <= 0.0:
        raise ValueError(
            f"target_epsilon must be > 0, got {target_epsilon}")

    def eps_at(z: float) -> float:
        acc = PrivacyAccountant(z, delta, orders=orders)
        acc.charge(q, rounds=rounds)
        return acc.epsilon()

    lo, hi = 1e-2, 1.0
    while eps_at(hi) > target_epsilon:
        hi *= 2.0
        if hi > 1e4:
            raise ValueError(
                f"cannot reach eps={target_epsilon} within z<=1e4")
    for _ in range(60):
        mid = 0.5 * (lo + hi)
        if eps_at(mid) > target_epsilon:
            lo = mid
        else:
            hi = mid
    return hi


# -- the streaming accountant --------------------------------------------

class PrivacyAccountant:
    """Streaming RDP accountant for the run's DP-FedAvg releases.

    One instance per run; :meth:`charge_round` is fed every COMMITTED
    round/commit index with the round's participation probability and
    dedups by index — a supervisor retry or an elastic restart
    re-running round r charges it exactly once. Persistence follows
    the program_costs.json conventions: schema-versioned JSON, atomic
    tmp-then-replace writes, :meth:`load_existing` adoption on resume
    (refusing, by name, an accountant file whose mechanism parameters
    disagree with the run's config — silently merging two different
    mechanisms would corrupt the spend)."""

    def __init__(self, noise_multiplier: float, delta: float,
                 orders: Sequence[float] = DEFAULT_ORDERS):
        if noise_multiplier <= 0.0:
            raise ValueError(
                f"noise_multiplier must be > 0, got {noise_multiplier}")
        if not 0.0 < delta < 1.0:
            raise ValueError(f"delta must be in (0, 1), got {delta}")
        self.noise_multiplier = float(noise_multiplier)
        self.delta = float(delta)
        self.orders: Tuple[float, ...] = tuple(
            float(a) for a in orders)
        self._rdp: List[float] = [0.0] * len(self.orders)
        self.charged_rounds = 0
        self.last_charged_round = -1
        # per-q charge counts, for the persisted audit trail
        self.charges: Dict[str, int] = {}
        self._step_cache: Dict[float, List[float]] = {}

    # -- charging ------------------------------------------------------
    def _step(self, q: float) -> List[float]:
        q = float(q)
        if not 0.0 < q <= 1.0:
            raise ValueError(
                f"participation probability must be in (0, 1], got {q}")
        step = self._step_cache.get(q)
        if step is None:
            step = [subsampled_gaussian_rdp(q, self.noise_multiplier, a)
                    for a in self.orders]
            self._step_cache[q] = step
        return step

    def charge(self, q: float, rounds: int = 1) -> None:
        """Accumulate ``rounds`` subsampled-Gaussian releases at
        participation probability ``q``."""
        if rounds <= 0:
            raise ValueError(f"rounds must be > 0, got {rounds}")
        step = self._step(q)
        self._rdp = [r + rounds * s for r, s in zip(self._rdp, step)]
        self.charged_rounds += int(rounds)
        key = repr(float(q))
        self.charges[key] = self.charges.get(key, 0) + int(rounds)

    def charge_round(self, round_idx: int, q: float) -> bool:
        """Charge round ``round_idx`` exactly once; a duplicate or
        older index (supervisor retry of the same round, elastic
        restart re-running adopted rounds) is refused, returning
        False — the never-double-charge half of the resume contract."""
        if round_idx <= self.last_charged_round:
            return False
        self.charge(q, rounds=1)
        self.last_charged_round = int(round_idx)
        return True

    # -- reading -------------------------------------------------------
    def epsilon(self) -> float:
        """Cumulative (eps, delta)-DP epsilon at the run's delta."""
        if self.charged_rounds == 0:
            return 0.0
        return rdp_to_epsilon(self.orders, self._rdp, self.delta)

    def preview_epsilon(self, q: float, extra_rounds: int = 1) -> float:
        """Epsilon AFTER ``extra_rounds`` more releases at ``q``,
        without mutating state — the budget lifecycle's affordability
        pre-check (stop at the last affordable round, not one past)."""
        step = self._step(q)
        rdp = [r + extra_rounds * s for r, s in zip(self._rdp, step)]
        return rdp_to_epsilon(self.orders, rdp, self.delta)

    # -- persistence (program_costs.json conventions) ------------------
    def state(self) -> Dict:
        return {
            "schema": ACCOUNTANT_SCHEMA,
            "noise_multiplier": self.noise_multiplier,
            "delta": self.delta,
            "orders": list(self.orders),
            "rdp": list(self._rdp),
            "charged_rounds": self.charged_rounds,
            "last_charged_round": self.last_charged_round,
            "charges": dict(self.charges),
            "epsilon_spent": self.epsilon(),
        }

    def adopt_state(self, doc: Dict) -> None:
        """Adopt a persisted accountant document; refuses, by name, a
        document whose mechanism parameters disagree with this run's
        config (resuming with a different z/delta/order grid would
        silently corrupt the spend — change the config back or start
        a fresh run dir)."""
        if doc.get("schema") != ACCOUNTANT_SCHEMA:
            raise ValueError(
                f"privacy accountant schema {doc.get('schema')!r} != "
                f"{ACCOUNTANT_SCHEMA!r}")
        for name, mine in (
                ("noise_multiplier", self.noise_multiplier),
                ("delta", self.delta)):
            theirs = doc.get(name)
            if theirs != mine:
                raise ValueError(
                    f"privacy accountant resume mismatch: persisted "
                    f"{name}={theirs!r} != configured {mine!r} — the "
                    "spend of a different mechanism cannot be adopted")
        orders = tuple(float(a) for a in doc.get("orders", ()))
        if orders != self.orders:
            raise ValueError(
                "privacy accountant resume mismatch: persisted order "
                "grid differs from this build's DEFAULT_ORDERS")
        rdp = [float(r) for r in doc.get("rdp", ())]
        if len(rdp) != len(self.orders):
            raise ValueError(
                "privacy accountant document is torn: rdp vector "
                f"length {len(rdp)} != {len(self.orders)} orders")
        self._rdp = rdp
        self.charged_rounds = int(doc.get("charged_rounds", 0))
        self.last_charged_round = int(doc.get("last_charged_round", -1))
        self.charges = {str(k): int(v)
                        for k, v in dict(doc.get("charges", {})).items()}

    def save(self, run_dir: str) -> bool:
        """Atomic write of the accountant state into the run dir.
        Called BEFORE every checkpoint write (so spend through any
        resume point is durable — never-forget-spend) and from the
        loop's finally block; absorbs I/O failure (telemetry-style:
        persistence must not outcrash the run it accounts)."""
        try:
            os.makedirs(run_dir, exist_ok=True)
            path = os.path.join(run_dir, ACCOUNTANT_FILE)
            tmp = path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(self.state(), f, indent=2, sort_keys=True)
            os.replace(tmp, path)
            return True
        except OSError:
            return False

    def load_existing(self, run_dir: str) -> bool:
        """Adopt the run dir's ``privacy_accountant.json`` on elastic
        restart (the program_costs.json convention) — spend resumes
        instead of resetting to zero. Returns False when there is
        nothing to adopt; RAISES on a parameter mismatch (see
        :meth:`adopt_state`) rather than under-counting."""
        path = os.path.join(run_dir, ACCOUNTANT_FILE)
        try:
            with open(path) as f:
                doc = json.load(f)
        except FileNotFoundError:
            return False
        except (OSError, json.JSONDecodeError):
            # a torn document (host fault mid-replace cannot happen —
            # os.replace is atomic — but a foreign/corrupt file can):
            # refuse silently-forgetting spend
            raise ValueError(
                f"privacy accountant file {path!r} is unreadable; "
                "remove it (accepting the spend reset) or restore it "
                "before resuming a DP run")
        self.adopt_state(doc)
        return True


# -- the DP stage ----------------------------------------------------------

def dp_noise_stddev(noise_multiplier: float, clip_norm: float,
                    cohort_k: int) -> float:
    """The per-round noise stddev on the weighted-MEAN estimate:
    ``sigma = z * S / k``. ``cohort_k`` is the round's real width:
    k_online on the sync planes (over-selection dispatches more, but the
    round closes on k_online)."""
    return (float(noise_multiplier) * float(clip_norm)
            / float(cohort_k))


def dp_clip_rows(payloads, weights: torch.Tensor, clip_norm: float):
    """Each client's stacked ``[k]`` payload L2-clipped to ``clip_norm``
    in unit-weight space, through the radial clip of ``norm_bound``
    (toward the origin at a fixed radius); row by row, so a rank clips
    its own rows of a sharded cohort. Returns ``(clipped, flags)``:
    float32 ``[k]``, 1 where the clip shrank the row."""
    unit = _unit_updates(payloads, weights)
    dist = radial_distances(unit)  # [k] unit-update l2 norms
    scale = torch.clamp(clip_norm / torch.clamp(dist, min=1e-30), max=1.0)
    return radial_clip(payloads, weights, scale), \
        (scale < 1.0).to(torch.float32)


def dp_clip_share(flags: torch.Tensor, weights: torch.Tensor, accept):
    """The share of the accepted candidates (``accept`` None: every
    client) whose row the clip shrank (``flags`` of :func:`dp_clip_rows`,
    all k of them)."""
    acc = accept if accept is not None else torch.ones_like(weights)
    cand = acc * (weights > 0.0).to(acc.dtype)
    return (cand * flags.to(cand.dtype)).sum() \
        / torch.clamp(cand.sum(), min=1.0)


def dp_clip_payloads(payloads, weights: torch.Tensor, accept,
                     clip_norm: float):
    """:func:`dp_clip_rows` on the whole cohort. Returns ``(clipped,
    clipped_frac)``: the share of the accepted candidates (``accept``
    None: every client) the clip shrank."""
    clipped, flags = dp_clip_rows(payloads, weights, clip_norm)
    return clipped, dp_clip_share(flags, weights, accept)


def dp_add_noise(payload_sum, seed: Optional[int], weights: torch.Tensor,
                 sigma: float, noise_scale, noise: Optional[dict] = None):
    """Gaussian noise on the aggregated payload sum. The sum carries the
    full round weight ``W = sum(weights)``, so noise at stddev ``W *
    sigma`` on it is ``sigma`` on the weighted-mean estimate.
    ``noise_scale`` is the server aux's float32 scalar (1.0 armed, 0.0
    after a budget 'degrade'). Each float leaf's standard normals are
    ``chaos.leaf_normals`` at ``fold_key(seed, i)`` for the i-th float
    leaf, or ``noise[name]`` when given."""
    amp = (weights.sum() * sigma * noise_scale).to(torch.float32)
    counter = [0]

    def noisy(name, p):
        if not _is_float(p):
            return p
        i = counter[0]
        counter[0] += 1
        xi = noise[name].to(p.device, torch.float32) if noise is not None \
            else _chaos.leaf_normals(fold_key(seed, i), p.shape, p.device)
        return (p.to(torch.float32) + amp * xi).to(p.dtype)

    return _chaos.tree_map_named(noisy, payload_sum)


__all__ = [
    "ACCOUNTANT_FILE", "ACCOUNTANT_SCHEMA", "DEFAULT_ORDERS",
    "PrivacyAccountant", "calibrate_noise_multiplier",
    "closed_form_epsilon", "dp_add_noise", "dp_clip_payloads",
    "dp_clip_rows", "dp_clip_share",
    "dp_noise_stddev", "gaussian_rdp", "rdp_to_epsilon",
    "subsampled_gaussian_rdp",
]
