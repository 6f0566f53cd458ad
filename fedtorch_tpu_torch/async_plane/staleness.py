"""Staleness-weighted aggregation for the async commit plane (port of
``fedtorch_tpu/async_plane/staleness.py``).

A buffered update that trained against a snapshot ``tau`` commits old
is damped by a staleness weight ``s(tau)`` before averaging (FedBuff,
Nguyen et al., arXiv:2106.06639 §4):

* ``poly``: ``(1 + tau)^-a`` (the FedBuff default, a = 0.5);
* ``inv``: ``1 / (1 + tau)``;
* ``const``: 1 (no damping).

Every shape has ``s(0) == 1``. :func:`normalized_staleness_weights`
rescales a commit's weights to mean 1, so the composed aggregation
weight (the algorithm's base weight x staleness) sums to what the sync
round's sums to, and an all-fresh commit reproduces the sync weighting
exactly. The composed weights feed ``guards.renormalize_accepted``, so a
rejected stale update hands back exactly its damped weight.
"""
from __future__ import annotations

import torch

STALENESS_MODES = ("const", "poly", "inv")


def staleness_weight(tau, mode: str, exponent: float = 0.5
                     ) -> torch.Tensor:
    """Raw ``s(tau)`` over a [k] staleness vector (commits, >= 0), in
    float32."""
    tau = torch.as_tensor(tau, dtype=torch.float32)
    if mode == "const":
        return torch.ones_like(tau)
    if mode == "poly":
        return (1.0 + tau) ** (-exponent)
    if mode == "inv":
        return 1.0 / (1.0 + tau)
    raise ValueError(
        f"unknown staleness_weight mode {mode!r}; expected one of "
        f"{STALENESS_MODES}")


def normalized_staleness_weights(tau, mode: str, exponent: float = 0.5
                                 ) -> torch.Tensor:
    """``s(tau)`` normalized to mean 1 over the commit buffer: the
    multiplier the engine composes into the aggregation weights."""
    s = staleness_weight(tau, mode, exponent)
    return s * (s.shape[0] / s.sum())
