"""Expert parallelism for the MoE layer on ``torch.distributed``. Port of
``fedtorch_tpu/parallel/expert.py``.

``MoEMLP`` (``models/transformer.py``) keeps its expert weights on a
leading ``[E]`` axis; here rank r of the ``ep`` mesh axis runs experts
``[r * E/n, (r + 1) * E/n)``. Every rank holds the layer's input whole
and routes it (the gate is O(d * E)); the two dispatch modes are the
module's:

* dense (``capacity_factor == 0``): each rank runs the exact dispatch ->
  expert MLP -> combine (``moe_expert_compute``) over its experts'
  one-hot columns; a token's row is nonzero only on the rank that owns
  its expert, so one ``all_reduce`` gives the routed output.
* sparse (``capacity_factor > 0``): every rank makes the same dispatch
  plan (``moe_dispatch_plan``, integer cumsums over the tokens), gathers
  the tokens of its ``E/n * C`` slots, runs ``moe_expert_mlp``, reads
  back the rows of the tokens it owns, and one ``all_reduce`` combines.

A forward: the ``all_reduce`` carries no gradient, so it runs without
autograd. Equals the module's forward with the same ``capacity_factor``
to float tolerance.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F

from fedtorch_tpu_torch.models.transformer import (
    moe_capacity, moe_dispatch_plan, moe_expert_compute, moe_expert_mlp,
    moe_route,
)
from fedtorch_tpu_torch.parallel.sequence import mesh_axis


@torch.no_grad()
def ep_moe_apply(params: dict, x, mesh, axis_name: str = "ep",
                 capacity_factor: float = 0.0):
    """One MoE layer with its experts sharded over ``axis_name``.
    ``params``: the layer's params (``gate.kernel``, ``w_in``, ``b_in``,
    ``w_out``, ``b_out``, the ``MoEMLP``'s own names); ``x``: ``[B, T,
    d]`` in the compute dtype, the same on every rank; the output, the
    same on every rank."""
    E = params["w_in"].shape[0]
    group, n, idx = mesh_axis(mesh, axis_name)
    if E % n:
        raise ValueError(f"expert parallelism needs num_experts ({E}) "
                         f"divisible by the '{axis_name}' mesh axis "
                         f"({n})")
    dt, e_local = x.dtype, E // n
    mine = slice(idx * e_local, (idx + 1) * e_local)
    weights = [params[k][mine].to(dt)
               for k in ("w_in", "b_in", "w_out", "b_out")]
    _, top_p, sel = moe_route(x, params["gate.kernel"])
    B, T, D = x.shape
    if capacity_factor > 0:
        capacity = moe_capacity(capacity_factor, B * T, E)
        slot, keep, token_for_slot = moe_dispatch_plan(sel, E, capacity)
        span = e_local * capacity
        xf_pad = torch.cat([x.reshape(B * T, D), x.new_zeros(1, D)])
        my_tfs = token_for_slot[idx * span:(idx + 1) * span]
        y = moe_expert_mlp(xf_pad.index_select(0, my_tfs).reshape(
            e_local, capacity, D), *weights)
        y_pad = torch.cat([y.reshape(span, D), y.new_zeros(1, D)])
        owned = keep & (sel.reshape(-1) // e_local == idx)
        out = y_pad.index_select(
            0, torch.where(owned, slot - idx * span, span)).reshape(B, T, D)
    else:
        onehot = F.one_hot(sel, E)[..., mine].to(dt)
        out = moe_expert_compute(x, onehot, *weights)
    out = out.contiguous()
    dist.all_reduce(out, group=group)
    return out * top_p[..., None].to(dt)
