"""Training state as dicts of tensors.

Port of ``fedtorch_tpu/core/state.py``. A parameter tree is a flat
``dict[str, Tensor]`` keyed by the model's ``state_dict`` names; the
JAX package's pytrees map onto it leaf by leaf (``bridge.py``).

* :class:`ClientState` — every tensor has a leading ``[C]`` client axis
  and lives on the device: all clients' params and both momentum
  buffers (~330 MB at ResNet-20 x 100 clients). The round writes the
  online clients' rows back in place instead of rebuilding the [C]
  tensors as the JAX package's ``.at[idx].set`` does, which saves one
  copy of the whole client state per round.
* :class:`ServerState` — the aggregated model, its optimizer state, the
  algorithm's server aux, the round counter and the ``torch.Generator``
  the round plans are drawn from.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple

import torch

Tree = Dict[str, torch.Tensor]


class ClientState(NamedTuple):
    """Per-client state; every tensor has leading axis [C]."""
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
    """The per-round metrics of the JAX package's ``RoundMetrics`` that
    the ported (fault-free) round produces; the per-client vectors are
    [C] with offline rows zero."""
    train_loss: torch.Tensor   # [C] mean local loss of each online client
    train_acc: torch.Tensor    # [C] mean local top-1 of each online client
    online_mask: torch.Tensor  # [C] 1.0 for this round's online clients
    comm_bytes: torch.Tensor   # scalar — uplink payload volume


def tree_map(fn: Callable, tree: Tree, *rest: Tree) -> Tree:
    """``fn`` over matching leaves of dicts with the same keys."""
    return {k: fn(v, *(r[k] for r in rest)) for k, v in tree.items()}


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
    """Row ``c`` of every [C] leaf of a dict or a NamedTuple of dicts."""
    if isinstance(tree, dict):
        return {k: v[c] for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_take(t, c) for t in tree))
    if isinstance(tree, torch.Tensor):
        return tree[c]
    return tree


def tree_put(tree, rows, new) -> None:
    """In place: ``tree[rows] = new`` for every leaf (dicts, NamedTuples
    of dicts and bare tensors)."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            v[rows] = new[k]
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for t, n in zip(tree, new):
            tree_put(t, rows, n)
    elif isinstance(tree, torch.Tensor):
        tree[rows] = new


def tree_stack(trees) -> Tree:
    """List of same-keyed dicts -> one dict of stacked [k, ...] leaves."""
    return {k: torch.stack([t[k] for t in trees]) for k in trees[0]}


def tree_bytes(tree: Tree) -> int:
    """Payload size in bytes (comm accounting)."""
    return sum(x.numel() * x.element_size() for x in tree.values())
