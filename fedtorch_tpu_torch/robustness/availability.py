"""Client availability models (port of
``fedtorch_tpu/robustness/availability.py``): the deployment-realism
plane (docs/robustness.md "Deployment realism").

* **sync** (:func:`sync_lifecycle`, in the round): an over-selected
  cohort of ``k' >= k_online`` dispatched clients, each with a virtual
  arrival delay and a mid-round dropout; the round closes on its first
  ``k_online`` arrivals and the late tail is masked out through the
  accept mask (``guards.renormalize_accepted``).
* **async** (:class:`DefaultAvailability`, :class:`TraceAvailability`):
  the arrival model of the async scheduler (ROADMAP A8), whose
  :meth:`~AvailabilityModel.finish` turns a dispatch's uniform columns
  into (delay, straggler, dropped) in float64 on the host.

Models (``config.AVAILABILITY_MODELS``): ``default`` (the straggler
knobs read as an arrival tail, no dropouts unless
``avail_dropout_rate`` is armed) and ``trace`` (FedScale-style device
classes, speed multipliers drawn once a run, and a diurnal on/off curve
of ``avail_diurnal_period`` rounds with a per-client phase modulating
the dropout probability).

Where the JAX package folds the round key per client
(``AVAIL_SYNC_SALT``, ``AVAIL_DROP_SALT``), the port's round plan
carries the ``[k', 2]`` arrival uniforms and the ``[k']`` dropout
uniforms, drawn from the server's generator; each client's class and
phase come from two uniforms hashed off the run's fault key and its id
(:func:`class_uniforms`), so a client's speed is the same every round.
:func:`sync_lifecycle` and :func:`_class_draw` take uniforms and return
decisions, so a test can feed them the JAX package's own.
"""
from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

from fedtorch_tpu_torch.config import AVAILABILITY_MODELS
from fedtorch_tpu_torch.robustness.chaos import hash_uniforms

__all__ = [
    "AVAILABILITY_MODELS", "AvailabilityModel", "DefaultAvailability",
    "TraceAvailability", "make_availability_model", "synthesize_trace",
    "sync_lifecycle", "class_uniforms", "DEVICE_CLASSES",
]

# the salts of the hashed streams off the run's fault key (the JAX
# package's fold constants)
LEGACY_DELAY_SALT = 0x7FFFFFF7  # the default model's per-dispatch draw
AVAIL_DELAY_SALT = 0x7FFFFFF3   # the trace model's per-dispatch delay
AVAIL_CLASS_SALT = 0x7FFFFFF1   # per-client device class + diurnal phase
AVAIL_DROP_SALT = 0x7FFFFFEF    # per-dispatch mid-round dropout

# FedScale-style device classes as (population fraction, speed
# multiplier): half the fleet fast, a third 2x slower, the rest 4x
# slower (the trace model's stragglers)
DEVICE_CLASSES = ((0.5, 1.0), (0.3, 2.0), (0.2, 4.0))
_SLOW_MULT = DEVICE_CLASSES[-1][1]


def class_uniforms(fault_key: int, clients) -> torch.Tensor:
    """[n, 2] float32: each client's (class, phase) uniforms off the
    run's fault key, a pure function of (key, client id)."""
    ids = clients.numpy() if isinstance(clients, torch.Tensor) else clients
    return torch.from_numpy(hash_uniforms(fault_key, AVAIL_CLASS_SALT,
                                          ids, 2))


def _class_draw(u: torch.Tensor):
    """Per-client (speed multiplier, diurnal phase) from its uniform pair
    ``u`` [n, 2]: the class boundaries are the cumulative population
    fractions (float32 comparisons, as the JAX package's)."""
    edges, mults = [], []
    acc = 0.0
    for frac, mult in DEVICE_CLASSES:
        acc += frac
        edges.append(acc)
        mults.append(mult)
    mult = torch.full(u.shape[:1], mults[-1], dtype=torch.float32)
    for edge, m in zip(reversed(edges[:-1]), reversed(mults[:-1])):
        mult = torch.where(u[:, 0] < edge, torch.tensor(m), mult)
    return mult, u[:, 1]  # [n] multiplier, [n] phase in [0, 1)


def _offness(t, phase, period: int):
    """Diurnal 'off-ness' in [0, 1]: 0 at each client's peak, 1 at its
    trough, 0.5 for a flat fleet (period 0). ``phase`` a torch tensor
    (float32, as the JAX package's in its round), a numpy array
    (float64 host math, the async models) or a Python scalar."""
    if period <= 0:
        if isinstance(phase, torch.Tensor):
            return torch.full_like(phase, 0.5)
        return 0.5 * np.ones_like(phase) if hasattr(phase, "shape") \
            else 0.5
    if isinstance(phase, torch.Tensor):
        x = torch.tensor(t, dtype=torch.float32) / period + phase
        return 0.5 - 0.5 * torch.cos(2.0 * math.pi * x)
    return 0.5 - 0.5 * np.cos(
        2.0 * np.pi * (np.asarray(t, np.float32) / period + phase))


class AvailabilityModel:
    """One arrival model for the async scheduler: :meth:`columns` the
    uniform columns of each dispatch (hashed off the run's fault key),
    :meth:`finish` the float64 host math turning them into (delay,
    straggler, dropped). Both are pure functions of their inputs."""

    name: str = "base"

    def columns(self, fault_key, dispatch_ids, clients, versions
                ) -> np.ndarray:
        raise NotImplementedError

    def finish(self, u: np.ndarray, versions: np.ndarray
               ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        raise NotImplementedError


class DefaultAvailability(AvailabilityModel):
    """The straggler knobs as arrival knobs: ``base = 1 + jitter*u1``,
    straggler iff ``u0 < straggler_rate`` (then ``base /
    straggler_step_frac``); ``avail_dropout_rate > 0`` adds an
    independent third column, so arming dropout changes which arrivals
    commit but not when anything arrives."""

    name = "default"

    def __init__(self, *, straggler_rate: float,
                 straggler_step_frac: float, jitter: float = 0.25,
                 dropout_rate: float = 0.0):
        self._rate = float(straggler_rate)
        self._tail = 1.0 / float(straggler_step_frac)
        self._jitter = float(jitter)
        self._drop = float(dropout_rate)

    def columns(self, fault_key, dispatch_ids, clients, versions):
        del clients, versions
        u = hash_uniforms(fault_key, LEGACY_DELAY_SALT, dispatch_ids, 2)
        if self._drop <= 0.0:
            return u
        ud = hash_uniforms(fault_key, AVAIL_DROP_SALT, dispatch_ids, 1)
        return np.concatenate([u, ud], axis=1)

    def finish(self, u, versions):
        del versions
        base = 1.0 + self._jitter * u[:, 1]
        straggler = u[:, 0] < self._rate
        delay = np.where(straggler, base * self._tail, base)
        dropped = (u[:, 2] < self._drop) if u.shape[1] > 2 \
            else np.zeros(u.shape[0], bool)
        return delay, straggler, dropped


class TraceAvailability(AvailabilityModel):
    """The synthetic deployment trace: delay = (1 + jitter*u) x the
    client's device-class multiplier; 'straggler' = a low-end-class
    dispatch; dropout probability = ``2 * avail_dropout_rate`` x the
    off-ness of the client's diurnal curve at its dispatch version
    (mean over a cycle = the configured rate; clipped to [0, 1])."""

    name = "trace"

    def __init__(self, *, dropout_rate: float, diurnal_period: int,
                 jitter: float = 0.25):
        self._drop = float(dropout_rate)
        self._period = int(diurnal_period)
        self._jitter = float(jitter)

    def columns(self, fault_key, dispatch_ids, clients, versions):
        del versions
        uj = hash_uniforms(fault_key, AVAIL_DELAY_SALT, dispatch_ids, 1)
        mult, phase = _class_draw(class_uniforms(fault_key, clients))
        ud = hash_uniforms(fault_key, AVAIL_DROP_SALT, dispatch_ids, 1)
        return np.concatenate([uj, mult.numpy()[:, None],
                               phase.numpy()[:, None], ud], axis=1)

    def finish(self, u, versions):
        delay = (1.0 + self._jitter * u[:, 0]) * u[:, 1]
        straggler = u[:, 1] >= _SLOW_MULT
        off = np.asarray(_offness(np.asarray(versions, np.float64),
                                  u[:, 2], self._period))
        p = np.clip(2.0 * self._drop * off, 0.0, 1.0)
        return delay, straggler, u[:, 3] < p


def make_availability_model(fault, jitter: float = 0.25
                            ) -> AvailabilityModel:
    """The async plane's one constructor: the trace model, or the default
    model over the straggler knobs."""
    if fault.avail_model == "trace":
        return TraceAvailability(
            dropout_rate=fault.avail_dropout_rate,
            diurnal_period=fault.avail_diurnal_period, jitter=jitter)
    return DefaultAvailability(
        straggler_rate=fault.straggler_rate,
        straggler_step_frac=fault.straggler_step_frac, jitter=jitter,
        dropout_rate=fault.avail_dropout_rate)


def synthesize_trace(fault_key: int, num_clients: int,
                     diurnal_period: int = 0) -> dict:
    """The fleet the 'trace' model draws from, for every client, as host
    numpy: device-class id, speed multiplier and diurnal phase."""
    mult, phase = _class_draw(class_uniforms(fault_key,
                                             np.arange(num_clients)))
    mult, phase = mult.numpy(), phase.numpy()
    class_id = np.searchsorted(
        np.asarray(sorted({m for _, m in DEVICE_CLASSES})), mult)
    return {"class_id": class_id.astype(np.int32),
            "speed_multiplier": mult.astype(np.float32),
            "diurnal_phase": phase.astype(np.float32),
            "diurnal_period": int(diurnal_period),
            "classes": [{"fraction": f, "multiplier": m}
                        for f, m in DEVICE_CLASSES]}


def sync_lifecycle(u: torch.Tensor, u_drop, class_u, round_idx: int, fault,
                   k_online: int, jitter: float = 0.25):
    """The sync round's lifecycle over the ``k'`` dispatched clients
    (called only when ``fault.avail_armed``), from the plan's uniforms:
    ``u`` [k', 2] (arrival), ``u_drop`` [k'] (dropout; None under the
    default model without dropout) and, under the trace model,
    ``class_u`` [k', 2] (each client's class and phase). Each client's
    arrival delay and dropout are drawn, and the round closes on the
    first ``k_online`` arrivals (dropouts rank behind every survivor; a
    stable sort breaks ties in dispatch order). Returns host bool [k']
    tensors (accept, dropped, deadline_miss): reported by the deadline,
    dropped out mid-round, survived but arrived late."""
    k = u.shape[0]
    if fault.avail_model == "trace":
        mult, phase = _class_draw(class_u)
        delay = (1.0 + jitter * u[:, 1]) * mult
        off = _offness(round_idx, phase, fault.avail_diurnal_period)
        p_drop = torch.clamp(2.0 * fault.avail_dropout_rate * off, 0.0, 1.0)
    else:
        base = 1.0 + jitter * u[:, 1]
        tail = 1.0 / float(fault.straggler_step_frac)
        delay = torch.where(u[:, 0] < fault.straggler_rate, base * tail,
                            base)
        p_drop = torch.tensor(fault.avail_dropout_rate, dtype=torch.float32)
        if fault.avail_dropout_rate <= 0.0:
            u_drop = torch.ones(k)
    dropped = u_drop < p_drop
    eff = torch.where(dropped, torch.tensor(float("inf")), delay)
    order = torch.argsort(eff, stable=True)
    rank = torch.argsort(order, stable=True)
    deadline_ok = rank < k_online
    accept = deadline_ok & ~dropped
    return accept, dropped, ~dropped & ~deadline_ok
