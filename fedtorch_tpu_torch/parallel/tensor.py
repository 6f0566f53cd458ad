"""Tensor parallelism for the transformer LM on ``torch.distributed``.
Port of ``fedtorch_tpu/parallel/tensor.py``.

The JAX package annotates the params with Megatron-style
``PartitionSpec``s over a ``tp`` mesh axis and lets GSPMD partition the
matmuls. Here :func:`transformer_tp_specs` gives the same rules as
``torch.distributed.tensor`` placements on the port's ``(out, in)``
weights, and :func:`tp_apply` runs them with explicit Megatron
collectives (arXiv:1909.08053 §3):

* attention: ``qkv`` column-parallel by heads (rank r computes q, k and v
  of heads ``[r * H/n, (r + 1) * H/n)``), attention on those heads,
  ``proj`` row-parallel on their columns, one ``all_reduce``;
* MLP: ``mlp_in`` column-parallel (its bias with its features), GELU,
  ``mlp_out`` row-parallel, one ``all_reduce``, then the replicated bias;
* embeddings, norms, the MoE experts and the head: replicated.

A layer whose leaves the rules leave replicated (a width that does not
divide over the axis, or heads that do not for the attention) runs
replicated on every rank, which is exact too. A forward: the
``all_reduce``s carry no gradient, so it runs without autograd. Equals
the unsharded forward to float tolerance. For sequence-length scaling
see ``parallel/sequence.py``.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.distributed.tensor import Replicate, Shard
from torch.func import functional_call

from fedtorch_tpu_torch.models.common import call_method
from fedtorch_tpu_torch.parallel.sequence import mesh_axis

_COL = ("qkv", "mlp_in")
_ROW = ("proj", "mlp_out")


def transformer_tp_specs(params: dict, axis_name: str = "tp", mesh=None):
    """``{param name: placement along axis_name}`` for a TransformerLM's
    params: ``Shard(0)`` (output features) for the ``qkv`` and ``mlp_in``
    weights and biases, ``Shard(1)`` (input features) for the ``proj`` and
    ``mlp_out`` weights, ``Replicate()`` for the rest. With ``mesh``, a
    leaf whose sharded dimension does not divide over ``axis_name`` is
    replicated."""
    n = dist.get_world_size(mesh.get_group(axis_name)) \
        if mesh is not None else 1
    specs = {}
    for key, leaf in params.items():
        names = key.split(".")
        owner = next((m for m in names if m in _COL + _ROW), None)
        field = names[-1]
        spec = Replicate()
        if owner in _COL and leaf.shape[0] % n == 0:
            spec = Shard(0)
        elif owner in _ROW and field == "weight" and leaf.shape[1] % n == 0:
            spec = Shard(1)
        specs[key] = spec
    return specs


def _sub(tree: dict, prefix: str) -> dict:
    cut = len(prefix) + 1
    return {k[cut:]: v for k, v in tree.items() if k.startswith(prefix + ".")}


def _reduce(y, group):
    y = y.contiguous()
    dist.all_reduce(y, group=group)
    return y


def _tp_attention(attn, p, h, group, n: int, r: int):
    """The attention of this rank's H/n heads, row-parallel ``proj``,
    summed over the axis."""
    B, T, d = h.shape
    H, dt, w = attn.num_heads, attn.dtype, d // n
    rows = torch.cat([torch.arange(j * d + r * w, j * d + (r + 1) * w,
                                   device=h.device) for j in range(3)])
    qkv = F.linear(h.to(dt), p["qkv.weight"][rows].to(dt))
    q, k, v = (t.reshape(B, T, H // n, d // H) for t in qkv.chunk(3, dim=-1))
    out = attn.attend(q, k, v).reshape(B, T, w)
    y = F.linear(out.to(dt), p["proj.weight"][:, r * w:(r + 1) * w].to(dt))
    return _reduce(y, group)


def _tp_mlp(p, h, dt, group, n: int, r: int):
    """The GELU MLP with ``mlp_in`` column- and ``mlp_out`` row-parallel."""
    f = p["mlp_in.weight"].shape[0] // n
    cols = slice(r * f, (r + 1) * f)
    hid = F.linear(h, p["mlp_in.weight"][cols].to(dt),
                   p["mlp_in.bias"][cols].to(dt))
    y = F.linear(F.gelu(hid, approximate="tanh"),
                 p["mlp_out.weight"][:, cols].to(dt))
    return _reduce(y, group) + p["mlp_out.bias"].to(dt)


def _tp_block(block, p: dict, specs: dict, x, group, n: int, r: int):
    """``_Block.forward`` with its sharded layers tensor-parallel."""
    dt = block.dtype
    h = functional_call(block.ln1, _sub(p, "ln1"), (x,)).to(dt)
    if specs["attn.qkv.weight"] == Shard(0) \
            and specs["attn.proj.weight"] == Shard(1) \
            and block.attn.num_heads % n == 0:
        x = x + _tp_attention(block.attn, _sub(p, "attn"), h, group, n, r)
    else:
        x = x + functional_call(block.attn, _sub(p, "attn"), (h,))
    h = functional_call(block.ln2, _sub(p, "ln2"), (x,)).to(dt)
    if block.num_experts > 0:
        return x + functional_call(block.moe, _sub(p, "moe"), (h,))[0]
    if specs["mlp_in.weight"] == Shard(0) \
            and specs["mlp_out.weight"] == Shard(1):
        return x + _tp_mlp(p, h, dt, group, n, r)
    h = functional_call(block.mlp_in, _sub(p, "mlp_in"), (h,))
    return x + functional_call(block.mlp_out, _sub(p, "mlp_out"),
                               (F.gelu(h, approximate="tanh"),))


@torch.no_grad()
def tp_apply(module, params: dict, tokens, mesh, axis_name: str = "tp",
             dp_axis: Optional[str] = None):
    """The forward with the weights tensor-parallel over ``axis_name``.
    Every rank passes the whole ``[B, T]`` batch; without ``dp_axis`` it
    gets the whole logits, and with ``dp_axis`` (the other dimension of a
    2-D ``(dp, tp)`` mesh) the ``B / n_dp`` rows of its data-parallel
    rank, the logits' shard along that axis."""
    specs = transformer_tp_specs(params, axis_name, mesh)
    group, n, r = mesh_axis(mesh, axis_name)
    if dp_axis is not None:
        _, n_dp, dp_rank = mesh_axis(mesh, dp_axis)
        B = tokens.shape[0]
        if B % n_dp:
            raise ValueError(f"batch ({B}) must divide evenly over the "
                             f"'{dp_axis}' mesh axis ({n_dp})")
        rows = B // n_dp
        tokens = tokens[dp_rank * rows:(dp_rank + 1) * rows]
    x = call_method(module, params, "embed", tokens)
    for i in range(module.num_layers):
        name = f"block_{i}"
        x = _tp_block(getattr(module, name), _sub(params, name),
                      _sub(specs, name), x, group, n, r)
    return call_method(module, params, "head_apply", x)
