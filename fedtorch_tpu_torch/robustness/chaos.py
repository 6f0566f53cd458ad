"""Chaos injection in the round (port of ``fedtorch_tpu/robustness/chaos.py``).

Fault semantics (docs/robustness.md):

* **crash**: fail-stop mid-round. The client's upload never reaches the
  server (its payload is masked out of aggregation and the surviving
  weight renormalized) and its local state stays as it was at the
  round's start.
* **straggler**: the client's step budget is cut to
  ``max(ceil(straggler_step_frac * budget), 1)``; its partial update
  still aggregates (the "partial work" model, not a deadline miss: the
  round deadline is the availability lifecycle's, ``availability.py``).
* **nan poison**: the client uploads a non-finite update, injected at
  the wire so that the server's guards (``guards.py``) see it.
* **byzantine**: a FIXED cohort of ``floor(byzantine_rate * C)``
  clients, chosen once a run, whose uploads are crafted finite vectors
  (``byzantine_mode``): ``sign_flip`` (``-scale * delta``), ``scale``
  (``scale * delta``), ``zero``, ``gauss`` (``scale * N(0, I)``) and
  ``collude`` (every byzantine client this round sends the identical
  ``-scale *`` honest weighted-mean update). The defense is the robust
  aggregation layer (``aggregators.py``), not the guards.

Where the JAX package folds PRNG keys inside the round program, the port
draws from the server's ``torch.Generator`` into the round plan
(``parallel/federated.py`` ``RoundPlan``): each fault class's ``[k]``
uniforms, and a seed for the gauss noise. :func:`draw_chaos_plan` turns
the uniforms into decisions, so a test can feed it the JAX package's own
uniforms. The byzantine cohort is a pure function of the run's fault key
(``init_state`` draws it once, into the server aux):
:func:`cohort_uniforms` hashes the key and each client id into one
uniform, and :func:`byzantine_cohort_mask` takes the k-th smallest. The
gauss noise is drawn per leaf on the round's device
(:func:`leaf_normals`), or injected.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from fedtorch_tpu_torch.config import BYZANTINE_MODES
from fedtorch_tpu_torch.core.state import tree_map
from fedtorch_tpu_torch.models.common import fold_key
from fedtorch_tpu_torch.robustness.guards import _is_float, mask_bcast

# the salt of the cohort's stream off the fault key (the JAX package's
# fold constant)
BYZ_COHORT_FOLD = 19
# the payload tree's leaves are seeded past the delta tree's
PAYLOAD_NOISE_BASE = 0x1000


class ChaosPlan(NamedTuple):
    """Per-dispatched-client fault schedule of one round (all [k] float32
    on the host)."""
    survive: torch.Tensor       # {0,1}; 0 = crashed mid-round
    budget_scale: torch.Tensor  # (0,1]; < 1 = straggler step cut
    nan_inject: torch.Tensor    # {0,1}; 1 = upload poisoned
    byzantine: torch.Tensor     # {0,1}; 1 = adversarial upload


def no_chaos_plan(k: int) -> ChaosPlan:
    """The all-healthy plan (faults disabled)."""
    return ChaosPlan(survive=torch.ones(k), budget_scale=torch.ones(k),
                     nan_inject=torch.zeros(k), byzantine=torch.zeros(k))


def draw_chaos_plan(k: int, fault, u_crash=None, u_strag=None,
                    u_nan=None) -> ChaosPlan:
    """One round's fault schedule from the plan's [k] float32 uniforms
    (a class's uniforms exist only when its rate is above 0): crashed
    where ``u_crash < client_drop_rate``, a straggler where ``u_strag <
    straggler_rate``, poisoned where ``u_nan < nan_inject_rate``. The
    comparisons are float32 against the rate, as the JAX package's. The
    byzantine mask is the cohort's online slice, set by the engine."""
    plan = no_chaos_plan(k)
    if fault.client_drop_rate > 0.0:
        plan = plan._replace(
            survive=(u_crash >= fault.client_drop_rate).to(torch.float32))
    if fault.straggler_rate > 0.0:
        plan = plan._replace(budget_scale=torch.where(
            u_strag < fault.straggler_rate,
            torch.tensor(fault.straggler_step_frac, dtype=torch.float32),
            torch.tensor(1.0)))
    if fault.nan_inject_rate > 0.0:
        plan = plan._replace(
            nan_inject=(u_nan < fault.nan_inject_rate).to(torch.float32))
    return plan


def poison_tree(tree, nan_mask: torch.Tensor):
    """The [k]-leading rows selected by ``nan_mask`` set to NaN (float
    leaves) or to the dtype's max (integer leaves: an integer wire format
    has no NaN, and the max is still a norm explosion the guards
    catch)."""
    def poison(x):
        m = mask_bcast(nan_mask.to(x.device).bool(), x)
        if x.is_floating_point():
            return torch.where(m, torch.tensor(float("nan"), dtype=x.dtype,
                                               device=x.device), x)
        if x.dtype != torch.bool and not x.is_complex():
            return torch.where(m, torch.tensor(torch.iinfo(x.dtype).max,
                                               dtype=x.dtype,
                                               device=x.device), x)
        return x
    return tree_map(poison, tree)


def hash_uniforms(key: int, salt: int, ids, cols: int) -> np.ndarray:
    """``[len(ids), cols]`` float32 uniforms in [0, 1), a pure function
    of (``key``, ``salt``, id, column): splitmix64 of each
    (id, column)'s counter off ``fold_key(key, salt)``, its top 24 bits.
    The port's counterpart of the JAX package's per-client ``fold_in``
    draws off a run key, in O(len(ids))."""
    base = np.uint64(fold_key(int(key), int(salt)))
    ids = np.asarray(ids, dtype=np.uint64).reshape(-1, 1)
    ctr = ids * np.uint64(cols) + np.arange(cols, dtype=np.uint64) \
        + np.uint64(1)
    with np.errstate(over="ignore"):
        z = base + ctr * np.uint64(0x9E3779B97F4A7C15)
        z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        z = z ^ (z >> np.uint64(31))
    return ((z >> np.uint64(40)).astype(np.float32)
            * np.float32(2.0 ** -24))


def cohort_uniforms(fault_key: int, num_clients: int) -> torch.Tensor:
    """[C] float32: one uniform per client off the run's fault key (the
    byzantine cohort's draw)."""
    return torch.from_numpy(hash_uniforms(
        fault_key, BYZ_COHORT_FOLD, np.arange(num_clients), 1)[:, 0])


def byzantine_cohort_mask(u: torch.Tensor, rate: float) -> torch.Tensor:
    """[C] float32 {0,1} marking the FIXED adversarial cohort from one
    uniform per client ``u`` [C]: the ``floor(rate * C)`` clients whose
    uniform is at most the k-th smallest. Persistent adversaries, not
    per-round coin flips (a per-round draw can give an adversarial
    majority at small k, which no robust rule survives)."""
    n = int(rate * u.shape[0])
    if n <= 0:
        return torch.zeros(u.shape[0])
    kth = torch.sort(u).values[n - 1]
    return (u <= kth).to(torch.float32)


def tree_map_named(fn, tree, name: str = ""):
    """``fn(name, leaf)`` over a tree of dicts, tuples and tensors, in
    :func:`~fedtorch_tpu_torch.core.state.tree_map`'s order; a leaf's
    name is its dict keys joined by '/' (a flat parameter dict: its
    own keys)."""
    if isinstance(tree, dict):
        return {k: tree_map_named(fn, v, f"{name}/{k}" if name else k)
                for k, v in tree.items()}
    if isinstance(tree, tuple):
        out = [tree_map_named(fn, v, f"{name}/{i}" if name else str(i))
               for i, v in enumerate(tree)]
        return type(tree)(*out) if hasattr(tree, "_fields") \
            else type(tree)(out)
    return fn(name, tree)


_NORMAL_GENERATORS: dict = {}


def leaf_normals(seed: int, shape, device) -> torch.Tensor:
    """float32 standard normals of ``shape`` on ``device`` from a device
    generator reseeded with ``seed`` (one seed a leaf: the noise of a
    leaf does not depend on which other leaves are drawn). A CUDA and a
    CPU generator give other normals for one seed."""
    device = torch.device(device)
    gen = _NORMAL_GENERATORS.get(device)
    if gen is None:
        gen = _NORMAL_GENERATORS[device] = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    return torch.randn(tuple(shape), generator=gen, device=device,
                       dtype=torch.float32)


def apply_byzantine(plan: ChaosPlan, deltas, payloads,
                    weights: torch.Tensor, fault, seed: Optional[int] = None,
                    noise: Optional[dict] = None, rows=None):
    """Replace the byzantine clients' uploads with crafted vectors, at the
    wire: ``deltas`` (the updates the guards judge; None when nothing
    judges them) and ``payloads`` (the weighted wire contributions,
    before ``payload_batch_transform``, so a quantized uplink quantizes
    the crafted values like any client's) in lockstep; float leaves
    only. The clients' local state stays honest. ``plan``'s masks lie on
    the payloads' device. Mode ``gauss`` draws each leaf's noise with
    :func:`leaf_normals` from ``seed`` (the delta tree's leaf i at
    ``fold_key(seed, i)``, the payload tree's at ``fold_key(seed,
    PAYLOAD_NOISE_BASE + i)``), or takes it from ``noise``
    (``{"deltas": {name: normals}, "payloads": {...}}``).

    Under client sharding the trees, ``plan`` and ``weights`` hold this
    rank's cohort rows ``[lo, hi)`` of ``k``, ``rows`` = ``(lo, hi,
    k)``: 'gauss' draws each leaf at the whole stack's ``[k, ...]``
    shape (and takes the injected ``[k, ...]`` normals), then keeps rows
    ``[lo, hi)``, so every shard count draws what the unsharded round
    draws."""
    mode = fault.byzantine_mode
    if mode not in BYZANTINE_MODES:
        raise ValueError(f"unknown byzantine_mode {mode!r}; expected one "
                         f"of {BYZANTINE_MODES}")
    g = fault.byzantine_scale
    mask = plan.byzantine

    def swap(tree, crafted):
        """where(byzantine, crafted_i, honest_i) leafwise."""
        if tree is None:
            return None
        return tree_map(lambda x, c: torch.where(
            mask_bcast(mask.bool(), x), c.to(x.dtype), x)
            if _is_float(x) else x, tree, crafted)

    def each(tree, fn):
        return None if tree is None else \
            tree_map(lambda x: fn(x) if _is_float(x) else x, tree)

    if mode == "sign_flip":
        return (swap(deltas, each(deltas, lambda d: -g * d)),
                swap(payloads, each(payloads, lambda p: -g * p)))
    if mode == "scale":
        return (swap(deltas, each(deltas, lambda d: g * d)),
                swap(payloads, each(payloads, lambda p: g * p)))
    if mode == "zero":
        return (swap(deltas, each(deltas, torch.zeros_like)),
                swap(payloads, each(payloads, torch.zeros_like)))
    if mode == "gauss":
        injected = noise or {}

        def noised(tree, which, base, weighted):
            if tree is None:
                return None
            given = injected.get(which)
            counter = [0]

            def draw(name, x):
                i = counter[0]
                counter[0] += 1
                lo, hi, k = rows if rows is not None \
                    else (0, x.shape[0], x.shape[0])
                xi = given[name].to(x.device, torch.float32) \
                    if given is not None else \
                    leaf_normals(fold_key(seed, base + i),
                                 (k,) + tuple(x.shape[1:]), x.device)
                v = g * xi[lo:hi]
                return v * mask_bcast(weights, x) if weighted else v
            return tree_map_named(
                lambda n, x: draw(n, x) if _is_float(x) else x, tree)

        return (swap(deltas, noised(deltas, "deltas", 0, False)),
                swap(payloads, noised(payloads, "payloads",
                                      PAYLOAD_NOISE_BASE, True)))

    # collude: every byzantine client sends the identical -g x (honest
    # weighted-mean update); the payload-space estimate sum(honest p) /
    # sum(honest w) equals the delta-space weighted mean for
    # weighted-delta payloads
    honest = (1.0 - mask) * plan.survive
    hw = torch.clamp((honest * weights).sum(), min=1e-30)

    def collude_d(x):
        hm = (x * mask_bcast(honest * weights, x).to(x.dtype)).sum(0) \
            / hw.to(x.dtype)
        return (-g * hm)[None].expand_as(x)

    def collude_p(x):
        hm = (x * mask_bcast(honest, x).to(x.dtype)).sum(0) / hw.to(x.dtype)
        return mask_bcast(weights, x).to(x.dtype) \
            * (-g * hm)[None].expand_as(x)

    return (swap(deltas, each(deltas, collude_d)),
            swap(payloads, each(payloads, collude_p)))
