"""Training sanity checks (port of ``fedtorch_tpu/utils/diagnostics.py``).

Covers the role of ``logs/check_training.py`` (the reference's substitute
for tests, SURVEY.md §4.2) with the JAX package's adjusted quantities:

* ``model_norms`` — weight-norm reporting at sync (the reference's
  check_model_at_sync, check_training.py:22-37), applied to the
  aggregated model, plus the ``all_finite`` flag the round supervisor
  reads.
* ``aggregation_tracking`` — cosine/distance between the PRE- and
  POST-aggregation server models (the reference's
  track_model_aggregation, check_training.py:43-76, asks the same
  question against the initial model).

The norms stay tensors on the params' device: a caller that fetches
them stacks them with whatever else it fetches, so a check costs no
transfer of its own.
"""
from __future__ import annotations

import os
from typing import Dict

import torch


def model_norms(params) -> Dict[str, torch.Tensor]:
    """Global l2 norm, max |w| over every leaf and an ``all_finite``
    flag, as 0-d tensors on the params' device. An empty tree is
    finite with zero norm."""
    leaves = [v for v in params.values()] if isinstance(params, dict) \
        else list(params)
    if not leaves:
        z = torch.zeros(())
        return {"l2": z, "max_abs": z.clone(),
                "all_finite": torch.tensor(True)}
    with torch.no_grad():
        sq = torch.stack([torch.sum(torch.square(x.float()))
                          for x in leaves]).sum()
        mx = torch.stack([x.abs().max().float() for x in leaves]).max()
        finite = torch.stack([torch.isfinite(x).all()
                              for x in leaves]).all()
    return {"l2": torch.sqrt(sq), "max_abs": mx, "all_finite": finite}


def aggregation_tracking(old_params, new_params) -> Dict[str, torch.Tensor]:
    """Cosine similarity, l2 distance and relative change between the
    model before and after aggregation (check_training.py:43-76), as
    0-d tensors."""
    with torch.no_grad():
        flat_old = torch.cat([old_params[n].reshape(-1).float()
                              for n in old_params])
        flat_new = torch.cat([new_params[n].reshape(-1).float()
                              for n in old_params])
        n_old = torch.linalg.vector_norm(flat_old)
        dist = torch.linalg.vector_norm(flat_new - flat_old)
        denom = torch.clamp(n_old * torch.linalg.vector_norm(flat_new),
                            min=1e-12)
        return {"cosine": torch.dot(flat_old, flat_new) / denom,
                "distance": dist,
                "rel_change": dist / torch.clamp(n_old, min=1e-12)}


def check_finite(params) -> bool:
    """Divergence guard: all leaves finite (one transfer)."""
    return bool(model_norms(params)["all_finite"])


def runtime_snapshot() -> Dict[str, object]:
    """Host-side process state for stall post-mortems — what the
    watchdog dumps when no round completes (robustness/watchdog.py).

    Touches NO device state: a wedged card would block any device
    interaction, so this reads only interpreter/OS facts (the JAX
    package's keys: the process as ``index/count`` — one process here —
    and the local device count, from ``torch.cuda.device_count``, which
    launches nothing). Every probe is guarded on its own — a half-dead
    runtime must still produce a partial report."""
    import threading

    snap: Dict[str, object] = {"pid": os.getpid()}
    try:
        snap["threads"] = sorted(t.name for t in threading.enumerate())
    except Exception:
        pass
    try:
        import resource
        snap["max_rss_kb"] = resource.getrusage(
            resource.RUSAGE_SELF).ru_maxrss
    except Exception:
        pass
    try:
        snap["process"] = "0/1"
        snap["local_devices"] = torch.cuda.device_count()
    except Exception:
        pass
    return snap
