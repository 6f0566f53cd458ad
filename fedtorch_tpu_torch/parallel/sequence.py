"""Sequence parallelism on ``torch.distributed``: ring and all-to-all
attention. Port of ``fedtorch_tpu/parallel/sequence.py``.

Two exact strategies over the ``[batch, seq, heads, head_dim]`` layout,
the sequence sharded over one dimension of a ``DeviceMesh`` (the
counterpart of the JAX package's ``jax.sharding.Mesh`` axis):

* :func:`ring_attention`: blockwise attention with the K/V blocks
  rotating around the ring (Ring Attention, arXiv:2310.01889), each step
  one ``batch_isend_irecv`` to rank ``r + 1`` from rank ``r - 1``, the
  steps merged by online softmax (``block_impl='dense'``,
  :func:`_block_attend`) or by logsumexp weighting of flash pieces
  (``block_impl='flash'``, :func:`_flash_block` and :func:`_merge_lse`).
  Score memory is one ``[T/n, T/n]`` block; any head count works.
* :func:`ulysses_attention`: head-parallel attention between two
  all-to-alls (DeepSpeed Ulysses, arXiv:2309.14509); heads must divide
  over the axis.

Where the JAX functions take the whole arrays and shard them inside
``shard_map``, these run on every rank of the axis, each on its own
shard: q, k and v are the rank's ``[B, T/n, H, D]`` rows (rank r holds
rows ``r * T/n``.. of the sequence), and so is the output.
:func:`scatter_sequence` and :func:`gather_sequence` move between a
replicated ``[B, T, ...]`` tensor and its shards, with the gradient
(``long_context_apply`` runs the model replicated and only its attention
sharded, as the JAX package does). Every collective carries the
gradient: the ring's rotation sends it back the other way, the
all-to-all is its own transpose. ``causal=True`` masks by absolute
position, so the result is causal attention whatever the sharding; the
flash ring decides a block's causal form (full, diagonal or skipped) on
the host from the ranks alone.

On CUDA tensors the flash pieces are the Hopper kernels of
``ops/cuda/flash_attention.py`` (a failed build or launch raises), on CPU
tensors their plain version; a collective that fails raises.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.distributed as dist

from fedtorch_tpu_torch.ops.cuda.flash_attention import (
    flash_attention, flash_attention_with_lse,
)


def mesh_axis(mesh, axis_name: str):
    """``(group, size, rank)`` of ``mesh``'s dimension ``axis_name``."""
    group = mesh.get_group(axis_name)
    return group, dist.get_world_size(group), mesh.get_local_rank(axis_name)


def _shift(t, group, step: int):
    """``t`` sent to rank ``r + step`` of ``group``; the tensor from rank
    ``r - step`` returned (one ``batch_isend_irecv``)."""
    n, r = dist.get_world_size(group), dist.get_rank(group)
    t = t.contiguous()
    out = torch.empty_like(t)
    ops = [dist.P2POp(dist.isend, t,
                      dist.get_global_rank(group, (r + step) % n), group),
           dist.P2POp(dist.irecv, out,
                      dist.get_global_rank(group, (r - step) % n), group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


class _Rotate(torch.autograd.Function):
    """One ring step (``lax.ppermute`` to the next rank); its backward
    rotates the gradient back to the previous rank. The ring rotates k
    and v stacked, one node a step: the nodes form a chain, so every rank
    runs their backward in the same order, as matched sends and receives
    need."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return _shift(t, group, 1)

    @staticmethod
    def backward(ctx, g):
        return _shift(g, ctx.group, -1), None


class _AllToAll(torch.autograd.Function):
    """``all_to_all_single`` on dim 0 in equal chunks: chunk j to rank j,
    chunk i of the output from rank i. With equal chunks it is its own
    transpose, so the backward is the same exchange."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return _exchange(t, group)

    @staticmethod
    def backward(ctx, g):
        return _exchange(g, ctx.group), None


def _exchange(t, group):
    t = t.contiguous()
    out = torch.empty_like(t)
    dist.all_to_all_single(out, t, group=group)
    return out


class _Scatter(torch.autograd.Function):
    """This rank's rows of a replicated ``[B, T, ...]`` tensor; the
    backward gathers every rank's gradient rows (each rank holds the
    whole tensor, so its gradient is the concatenation)."""

    @staticmethod
    def forward(ctx, t, group, n, rank):
        ctx.args = (group, n, rank)
        rows = t.shape[1] // n
        return t[:, rank * rows:(rank + 1) * rows].contiguous()

    @staticmethod
    def backward(ctx, g):
        return _all_gather_seq(g, ctx.args[0], ctx.args[1]), None, None, None


class _Gather(torch.autograd.Function):
    """Every rank's ``[B, T/n, ...]`` rows concatenated on dim 1; the
    backward keeps this rank's rows of the gradient (the ranks compute
    the same downstream, so each holds the whole gradient)."""

    @staticmethod
    def forward(ctx, t, group, n, rank):
        ctx.args = (t.shape[1], rank)
        return _all_gather_seq(t, group, n)

    @staticmethod
    def backward(ctx, g):
        rows, rank = ctx.args
        return g[:, rank * rows:(rank + 1) * rows], None, None, None


def _all_gather_seq(t, group, n):
    parts = [torch.empty_like(t, memory_format=torch.contiguous_format)
             for _ in range(n)]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.cat(parts, dim=1)


def scatter_sequence(t, mesh, axis_name: str = "sp"):
    """This rank's ``T/n`` rows of a ``[B, T, ...]`` tensor that every
    rank of ``axis_name`` holds whole."""
    group, n, rank = mesh_axis(mesh, axis_name)
    if t.shape[1] % n:
        raise ValueError(f"sequence length {t.shape[1]} must divide evenly "
                         f"over the '{axis_name}' mesh axis ({n})")
    return _Scatter.apply(t, group, n, rank)


def gather_sequence(t, mesh, axis_name: str = "sp"):
    """The whole ``[B, T, ...]`` tensor from every rank's rows, on every
    rank of ``axis_name``."""
    group, n, rank = mesh_axis(mesh, axis_name)
    return _Gather.apply(t, group, n, rank)


# -- the per-step pieces -----------------------------------------------------

def _block_attend(q, k, v, m_prev, l_prev, o_prev, q_offset: int,
                  k_offset: int, causal: bool, scale: float):
    """One online-softmax block update. q: ``[B, Sq, H, D]``, k, v:
    ``[B, Sk, H, D]``; the running max and sum m, l: ``[B, H, Sq]``, the
    accumulator o: ``[B, Sq, H, D]``. Offsets are the blocks' absolute
    positions for the causal mask."""
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    if causal:
        q_pos = q_offset + torch.arange(q.shape[1], device=q.device)
        k_pos = k_offset + torch.arange(k.shape[1], device=q.device)
        mask = q_pos[:, None] >= k_pos[None, :]
        scores = scores.masked_fill(~mask, -math.inf)
    m_new = torch.maximum(m_prev, scores.amax(dim=-1))
    # rows with every score masked keep m = -inf
    m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
    p = torch.exp(scores - m_safe[..., None])
    p = torch.where(torch.isfinite(scores), p, 0.0)
    correction = torch.where(torch.isfinite(m_prev),
                             torch.exp(m_prev - m_safe), 0.0)
    l_new = l_prev * correction + p.sum(dim=-1)
    pv = torch.einsum("bhqk,bkhd->bqhd", p, v)
    o_new = o_prev * correction.transpose(1, 2)[..., None] + pv
    return m_new, l_new, o_new


def _merge_lse(o1, lse1, o2, lse2):
    """The exact merge of two attention pieces over disjoint key sets,
    each ``(normalized o [B, T, H, D], lse [B, T, H])``: the lse-weighted
    average. A piece with lse -inf (nothing attended) weighs 0."""
    m = torch.maximum(lse1, lse2)
    m_safe = torch.where(torch.isfinite(m), m, 0.0)
    w1 = torch.exp(lse1 - m_safe)
    w2 = torch.exp(lse2 - m_safe)
    denom = torch.clamp_min(w1 + w2, 1e-30)
    o = (o1 * w1[..., None].to(o1.dtype) + o2 * w2[..., None].to(o2.dtype)) \
        / denom[..., None].to(o1.dtype)
    lse = torch.where(w1 + w2 > 0, m_safe + torch.log(denom), -math.inf)
    return o, lse


class _Skip(torch.autograd.Function):
    """The piece of a causally later K/V block: nothing attended (o 0,
    lse -inf). It takes the block, and its backward gives the block zero
    gradients, so that the block's rotation runs its backward on every
    rank (as ``lax.switch``'s dead branch does in the JAX package): a
    rank whose later blocks were all skipped would otherwise leave its
    neighbours' sends unmatched."""

    @staticmethod
    def forward(ctx, q, k, v):
        ctx.save_for_backward(k, v)
        return (torch.zeros_like(q),
                torch.full(q.shape[:-1], -math.inf, dtype=torch.float32,
                           device=q.device))

    @staticmethod
    def backward(ctx, g_o, g_lse):
        k, v = ctx.saved_tensors
        return None, torch.zeros_like(k), torch.zeros_like(v)


def _flash_block(q, k, v, q_idx: int, k_idx: int, causal: bool,
                 scale: float):
    """The flash ring's piece of K/V block ``k_idx`` for query block
    ``q_idx``: ``(o, lse [B, T/n, H])``. Causal at block granularity: a
    block before the queries' runs the non-causal kernel, the diagonal
    the causal one, and a later block computes nothing (lse -inf)."""
    if not causal or k_idx < q_idx:
        return flash_attention_with_lse(q, k, v, causal=False, scale=scale)
    if k_idx == q_idx:
        return flash_attention_with_lse(q, k, v, causal=True, scale=scale)
    return _Skip.apply(q, k, v)


# -- the per-rank bodies -----------------------------------------------------

def _ring_flash_local(q, k, v, *, group, n: int, rank: int, causal: bool,
                      scale: float):
    """The ring with the flash kernel per block: n steps, a rotation
    between consecutive ones (n - 1), the pieces merged by lse."""
    o = torch.zeros_like(q)
    lse = torch.full(q.shape[:-1], -math.inf, dtype=torch.float32,
                     device=q.device)
    kv = torch.stack((k, v))
    for s in range(n):
        if s:
            kv = _Rotate.apply(kv, group)
            k, v = kv.unbind(0)
        # the block held at step s came from rank (rank - s) % n
        o, lse = _merge_lse(o, lse, *_flash_block(q, k, v, rank,
                                                  (rank - s) % n, causal,
                                                  scale))
    return o.to(q.dtype)


def _ring_attention_local(q, k, v, *, group, n: int, rank: int,
                          causal: bool, scale: float):
    """The ring with dense blocks and online-softmax accumulation."""
    rows = q.shape[1]
    m = torch.full((q.shape[0], q.shape[2], rows), -math.inf,
                   dtype=q.dtype, device=q.device)
    l = torch.zeros_like(m)
    o = torch.zeros_like(q)
    kv = torch.stack((k, v))
    for s in range(n):
        if s:
            kv = _Rotate.apply(kv, group)
            k, v = kv.unbind(0)
        src = (rank - s) % n
        m, l, o = _block_attend(q, k, v, m, l, o, rank * rows, src * rows,
                                causal, scale)
    return o / torch.clamp_min(l, 1e-20).transpose(1, 2)[..., None]


def _seq_to_heads(t, group, n: int):
    """``[m, B, T/n, H, D]`` -> ``[m, B, T, H/n, D]`` (m tensors in one
    exchange): head group j to rank j, the sequence rows concatenated in
    rank order."""
    m, B, rows, H, D = t.shape
    t = t.reshape(m, B, rows, n, H // n, D).permute(3, 0, 1, 2, 4, 5)
    t = _AllToAll.apply(t, group)                    # [n (src), m, B, ...]
    return t.permute(1, 2, 0, 3, 4, 5).reshape(m, B, n * rows, H // n, D)


def _heads_to_seq(t, group, n: int):
    """The inverse of :func:`_seq_to_heads`."""
    B, T, h, D = t.shape
    t = t.reshape(B, n, T // n, h, D).permute(1, 0, 2, 3, 4)
    t = _AllToAll.apply(t, group)                    # [n (head group), ...]
    return t.permute(1, 2, 0, 3, 4).reshape(B, T // n, n * h, D)


def _ulysses_local(q, k, v, *, group, n: int, rank: int, causal: bool,
                   scale: float, block_impl: str = "dense"):
    """Head-parallel attention between two all-to-alls: the full
    sequence of this rank's H/n heads, dense or flash, with no traffic in
    between."""
    del rank
    q, k, v = _seq_to_heads(torch.stack((q, k, v)), group, n).unbind(0)
    if block_impl == "flash":
        o = flash_attention(q, k, v, causal=causal, scale=scale)
    else:
        o = reference_attention(q, k, v, causal=causal, scale=scale)
    return _heads_to_seq(o, group, n)


def _seq_sharded_call(local_fn, q, k, v, mesh, axis_name: str,
                      causal: bool, scale: Optional[float], **kw):
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    group, n, rank = mesh_axis(mesh, axis_name)
    return local_fn(q, k, v, group=group, n=n, rank=rank, causal=causal,
                    scale=scale, **kw)


def ring_attention(q, k, v, mesh, axis_name: str = "sp",
                   causal: bool = False, scale: Optional[float] = None,
                   block_impl: str = "dense"):
    """Exact attention of this rank's ``[B, T/n, H, D]`` shard against
    the whole sequence, the K/V blocks rotating over ``axis_name``.
    ``block_impl``: 'dense' (online softmax over ``[T/n, T/n]`` score
    blocks) or 'flash' (the flash kernel per block, merged by lse,
    causally dead blocks skipped)."""
    if block_impl not in ("dense", "flash"):
        raise ValueError(f"unknown ring block_impl {block_impl!r}")
    local = _ring_flash_local if block_impl == "flash" \
        else _ring_attention_local
    return _seq_sharded_call(local, q, k, v, mesh, axis_name, causal,
                             scale)


def ulysses_attention(q, k, v, mesh, axis_name: str = "sp",
                      causal: bool = False, scale: Optional[float] = None,
                      block_impl: str = "dense"):
    """Exact all-to-all sequence parallelism (DeepSpeed-Ulysses-style,
    arXiv:2309.14509) on this rank's ``[B, T/n, H, D]`` shard; heads must
    divide over ``axis_name``. ``block_impl``: 'dense' (the local ``[T,
    T]`` scores) or 'flash' (the flash kernel)."""
    n = dist.get_world_size(mesh.get_group(axis_name))
    if q.shape[2] % n:
        raise ValueError(
            f"ulysses needs heads ({q.shape[2]}) divisible by the "
            f"'{axis_name}' mesh axis ({n}); use ring_attention instead")
    if block_impl not in ("dense", "flash"):
        raise ValueError(f"unknown ulysses block_impl {block_impl!r}")
    return _seq_sharded_call(_ulysses_local, q, k, v, mesh, axis_name,
                             causal, scale, block_impl=block_impl)


def reference_attention(q, k, v, causal: bool = False,
                        scale: Optional[float] = None):
    """Dense attention on one device (the correctness oracle)."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    if causal:
        s = q.shape[1]
        mask = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
        scores = scores.masked_fill(~mask, -math.inf)
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(scores, dim=-1), v)
