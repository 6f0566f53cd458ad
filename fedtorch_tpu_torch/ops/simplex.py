"""Euclidean projection onto the probability simplex (port of
``fedtorch_tpu/ops/simplex.py``), used by the AFL and DRFA dual-variable
updates. An O(n log n) sort in torch ops, so the dual update stays on
the device with the rest of the round.
"""
from __future__ import annotations

import torch


def project_simplex(v: torch.Tensor, s: float = 1.0) -> torch.Tensor:
    """min_w ||w - v||^2 s.t. sum(w) = s, w >= 0 (Duchi et al., ICML'08),
    in float32, including the degenerate rho = 0 fallback when no
    component satisfies the support condition."""
    v = v.to(torch.float32)
    n = v.shape[0]
    u = torch.sort(v, descending=True).values
    cssv = torch.cumsum(u, dim=0)
    pos = torch.arange(n, device=v.device)
    cond = u * (pos + 1).to(v.dtype) > (cssv - s)
    # rho = the last index satisfying cond; 0 if none
    rho = torch.where(cond, pos, 0).max()
    theta = (cssv[rho] - s) / (rho + 1.0)
    return torch.clamp(v - theta, min=0.0)


def project_simplex_floor(v: torch.Tensor, s: float = 1.0,
                          floor: float = 1e-3) -> torch.Tensor:
    """The projection, then the DRFA lambda floor: entries <= floor are
    raised to the floor so every client keeps a nonzero probability, and
    the vector is renormalized once (not floored again after)."""
    w = project_simplex(v, s)
    w = torch.where(w <= floor, floor, w)
    return w / w.sum() * s
