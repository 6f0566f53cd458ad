"""Pipeline parallelism for the transformer LM on ``torch.distributed``
(GPipe). Port of ``fedtorch_tpu/parallel/pipeline.py``.

The blocks are alike, so their params stack into ``[num_layers, ...]``
leaves (:func:`stack_block_params`); stage s of the ``pp`` mesh axis
holds blocks ``[s * L/S, (s + 1) * L/S)``. The batch splits into M
microbatches, and over ``M + S - 1`` ticks each stage runs the
microbatch that reached it, then hands its output to the next stage (one
``batch_isend_irecv`` a tick): stage s takes microbatch ``t - s`` at tick
t, so the fill and the drain leave ``S - 1`` ticks idle on each stage
(the GPipe bubble). The last stage's outputs reach every rank through an
``all_reduce`` in which the other stages add zeros. The embedding and the
head run replicated through the model's own ``embed`` and
``head_apply``, and the stages' blocks through its ``apply_block`` (MoE
blocks as the model runs them; a block of a microbatch routes and drops
over that microbatch's tokens, as in the JAX package).

A forward: the hand-offs carry no gradient, so it runs without autograd
(and ``remat``, a backward's recompute, changes nothing here). Equals the
unsharded forward to float tolerance.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from fedtorch_tpu_torch.models.common import call_method
from fedtorch_tpu_torch.parallel.sequence import mesh_axis


def stack_block_params(params: dict, num_layers: int) -> dict:
    """``{leaf: [num_layers, ...]}``: every block's params stacked, the
    leaf named within its block (``attn.qkv.weight``)."""
    leaves = [k[len("block_0."):] for k in params if k.startswith("block_0.")]
    return {leaf: torch.stack([params[f"block_{i}.{leaf}"]
                               for i in range(num_layers)])
            for leaf in leaves}


@torch.no_grad()
def pipeline_apply(module, params: dict, tokens, mesh,
                   axis_name: str = "pp",
                   num_microbatches: Optional[int] = None):
    """The forward with the blocks pipelined over ``axis_name``. Every
    rank passes the whole ``[B, T]`` batch and gets the whole logits.
    ``num_layers`` must divide over the axis and the batch over
    ``num_microbatches`` (default: the stage count)."""
    group, S, s = mesh_axis(mesh, axis_name)
    L = module.num_layers
    if L % S:
        raise ValueError(f"pipeline needs num_layers ({L}) divisible by "
                         f"the '{axis_name}' mesh axis ({S})")
    M = num_microbatches or max(S, 1)
    B = tokens.shape[0]
    if B % M:
        raise ValueError(f"batch ({B}) must divide into {M} microbatches")
    per = L // S
    staged = {leaf: v[s * per:(s + 1) * per]
              for leaf, v in stack_block_params(params, L).items()}

    def stage(h):
        for j in range(per):
            i = s * per + j
            block = {f"block_{i}.{leaf}": v[j] for leaf, v in staged.items()}
            h, _ = call_method(module, block, "apply_block", i, h)
        return h

    x = call_method(module, params, "embed", tokens)
    x_mbs = x.reshape(M, B // M, *x.shape[1:])
    outputs = torch.zeros_like(x_mbs)
    received = None
    for t in range(M + S - 1):
        m = t - s
        out = None
        if 0 <= m < M:
            out = stage(x_mbs[m] if s == 0 else received)
            if s == S - 1:
                outputs[m] = out
        ops = []
        if out is not None and s < S - 1:
            ops.append(dist.P2POp(dist.isend, out.contiguous(),
                                  dist.get_global_rank(group, s + 1), group))
        if s > 0 and 0 <= m + 1 < M:
            # what stage s - 1 ran this tick: this stage's next input
            received = torch.empty_like(x_mbs[0])
            ops.append(dist.P2POp(dist.irecv, received,
                                  dist.get_global_rank(group, s - 1), group))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
    dist.all_reduce(outputs, group=group)
    return call_method(module, params, "head_apply", outputs.reshape(x.shape))
