"""Training state as dicts of tensors.

Port of ``fedtorch_tpu/core/state.py``. A parameter tree is a flat
``dict[str, Tensor]`` keyed by the model's ``state_dict`` names; the
JAX package's pytrees map onto it leaf by leaf (``bridge.py``).

* :class:`ClientState` — every tensor has a leading client axis and
  lives on the device: the clients' params and both momentum buffers
  (~330 MB at ResNet-20 x 100 clients). On several ranks the params,
  optimizer and aux trees hold this rank's ``C_pad/W`` rows of the
  padded client axis (``parallel/mesh.py`` ``owned_client_rows``) and
  ``epoch``/``local_index`` every client's. The round writes the online
  clients' rows back in place instead of rebuilding the tensors as the
  JAX package's ``.at[idx].set`` does, which saves one copy of the whole
  client state per round.
* :class:`ServerState` — the aggregated model, its optimizer state, the
  algorithm's server aux, the round counter and the ``torch.Generator``
  the round plans are drawn from.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional

import torch

Tree = Dict[str, torch.Tensor]


class ClientState(NamedTuple):
    """Per-client state; every tensor has a leading client axis: [C],
    or this rank's rows of the padded axis for the three trees on
    several ranks (module docstring)."""
    params: Any        # dict name -> [C, ...] working model copies
    opt: Any           # optimizer state (SGDState/AdamState of [C] dicts)
    aux: Any           # algorithm aux (() for fedavg/fedprox/fedadam)
    epoch: torch.Tensor        # [C] float32 — fractional local epoch
    local_index: torch.Tensor  # [C] int32 — local step counter


class ServerState(NamedTuple):
    params: Any        # aggregated model
    opt: Any           # server optimizer state (out-momentum buffers)
    aux: Any           # server aux (fedadam's per-leaf v)
    round: int         # communication rounds completed
    rng: torch.Generator  # draws the round plans (participation, rows)


class RoundMetrics(NamedTuple):
    """The JAX package's per-round metrics. The three per-client leaves
    are [C] under
    'perm' participation, offline rows zero, and the cohort-aligned [k']
    (the round's dispatched clients, in plan order) under 'sparse';
    ``FederatedTrainer.metrics_width`` names the width. A client that
    crashed, dropped out or missed the deadline is not online. Consumers
    that sum them get the same numbers in either layout. Every count is
    0 when its plane is off; the two DP gauges are None when DP is off,
    and :func:`~fedtorch_tpu_torch.parallel.round_program.stack_metrics`
    keeps them None. The eight ``cohort_*`` fields (the federation
    plane's cohort statistics, ``telemetry.cohort_stats``) are None with
    the statistics off; on, each is per dispatched client ([k], the
    commit's [m] jobs on the async plane) in plan order, but the [5]
    norm quantiles and the 0-d dispersion. They ride the round loop's
    one batched fetch into the client ledger (``telemetry/ledger.py``).
    """
    train_loss: torch.Tensor   # [C]|[k'] mean local loss of each reporter
    train_acc: torch.Tensor    # [C]|[k'] mean local top-1 of each reporter
    online_mask: torch.Tensor  # [C]|[k'] 1.0 for this round's reporters
    comm_bytes: torch.Tensor   # scalar — uplink payload volume
    dropped_clients: torch.Tensor    # scalar — chaos crashes
    straggler_clients: torch.Tensor  # scalar — step-budget cuts
    rejected_updates: torch.Tensor   # scalar — guard drops
    clipped_updates: torch.Tensor    # scalar — guard clips
    staleness_mean: torch.Tensor     # scalar — 0 on the sync planes
    byzantine_clients: torch.Tensor  # scalar — crafted uploads received
    robust_selected: torch.Tensor    # scalar — updates the rule kept
    robust_trimmed: torch.Tensor     # scalar — updates the rule cut
    avail_dropped: torch.Tensor      # scalar — mid-round dropouts
    deadline_missed: torch.Tensor    # scalar — late survivors
    quorum_degraded: torch.Tensor    # scalar {0,1} — sub-quorum round
    dp_clipped_frac: Optional[torch.Tensor] = None  # share the DP clip cut
    dp_noise_sigma: Optional[torch.Tensor] = None   # applied noise stddev
    cohort_idx: Optional[torch.Tensor] = None        # [k] int32 client ids
    cohort_online: Optional[torch.Tensor] = None     # [k] {0,1} reported
    cohort_accept: Optional[torch.Tensor] = None     # [k] {0,1} candidate
    cohort_selected: Optional[torch.Tensor] = None   # [k] {0,1} aggregated
    cohort_suspicion: Optional[torch.Tensor] = None  # [k] the rule's score
    cohort_staleness: Optional[torch.Tensor] = None  # [k] commits stale
    cohort_norm_q: Optional[torch.Tensor] = None     # [5] norm quantiles
    cohort_dispersion: Optional[torch.Tensor] = None  # 1 - mean cosine


def _is_tuple(tree) -> bool:
    return isinstance(tree, tuple)


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over matching leaves of trees of one structure: dicts
    (matched by key), tuples and NamedTuples, with tensors (or any other
    object) as leaves. An algorithm's aux nests dicts (DRFA's
    ``{"inner": ..., "kth": ...}``); a parameter tree is a flat dict."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if _is_tuple(tree):
        out = [tree_map(fn, *leaves) for leaves in zip(tree, *rest)]
        return type(tree)(*out) if hasattr(tree, "_fields") \
            else type(tree)(out)
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """The tensor leaves of a tree, in :func:`tree_map`'s order."""
    out = []
    tree_map(lambda x: out.append(x) if isinstance(x, torch.Tensor)
             else None, tree)
    return out


def tree_fill(tree, values):
    """``tree`` with its tensor leaves replaced, in :func:`tree_leaves`'
    order, by the tensors of the iterable ``values``."""
    it = iter(values)
    return tree_map(lambda x: next(it) if isinstance(x, torch.Tensor)
                    else x, tree)


def tree_sub(a: Tree, b: Tree) -> Tree:
    return tree_map(torch.sub, a, b)


def tree_scale(tree: Tree, s) -> Tree:
    return tree_map(lambda x: x * s, tree)


def tree_zeros_like(tree: Tree) -> Tree:
    return tree_map(torch.zeros_like, tree)


def tree_broadcast_clients(tree: Tree, num_clients: int) -> Tree:
    """A replicated tree copied onto a leading [C] axis (real copies: the
    rows are written independently later)."""
    return tree_map(
        lambda x: x.unsqueeze(0).repeat((num_clients,) + (1,) * x.ndim),
        tree)


def tree_take(tree, c):
    """Row(s) ``c`` (an int or an index tensor) of every [C] tensor leaf;
    other leaves pass through."""
    return tree_map(
        lambda x: x[c] if isinstance(x, torch.Tensor) else x, tree)


def tree_put(tree, rows, new) -> None:
    """In place: ``leaf[rows] = new_leaf`` for every tensor leaf."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            tree_put(v, rows, new[k])
    elif _is_tuple(tree):
        for t, n in zip(tree, new):
            tree_put(t, rows, n)
    elif isinstance(tree, torch.Tensor):
        tree[rows] = new


def tree_stack(trees: list):
    """A list of trees of one structure -> one tree of stacked [k, ...]
    tensor leaves (other leaves: the first tree's)."""
    return tree_map(
        lambda *xs: torch.stack(xs) if isinstance(xs[0], torch.Tensor)
        else xs[0], *trees)


def tree_bytes(tree: Tree) -> int:
    """Payload size in bytes (comm accounting)."""
    return sum(x.numel() * x.element_size() for x in tree.values())
