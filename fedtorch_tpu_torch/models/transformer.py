"""Causal transformer language model, port of
``fedtorch_tpu/models/transformer.py`` (``_SelfAttention``, ``MoEMLP``
and its dispatch functions, ``_Block``, ``TransformerLM``,
``routing_fractions``, ``drop_fractions``, ``long_context_apply``).

``[B, T]`` tokens -> ``[B, T, vocab]`` float32 logits: token plus learned
positional embedding, pre-norm blocks (attention, then a GELU MLP or a
Switch mixture of experts), a final norm and a float32 head. Module names
are the flax names (``tok_embed``, ``pos_embed``, ``block_<i>.{ln1,
attn.qkv, attn.proj, ln2, mlp_in, mlp_out}``, ``block_<i>.moe.{gate.kernel,
w_in, b_in, w_out, b_out}``, ``ln_f``, ``head``), so ``bridge.py`` maps
the params both ways by the class of the module that owns each leaf; the
expert weights keep the JAX layout (``w_in [E, d, 4d]``), so they cross
unchanged.

Numerics follow flax's: every ``LayerNorm`` has eps 1e-6 and computes in
float32, its output cast back to the compute dtype; the GELU is the tanh
approximation; ``qkv``, ``proj``, ``mlp_in``, ``mlp_out`` and the experts
run in the compute dtype, the router and the head in float32. Attention
is dense (float32 softmax over compute-dtype scores) or flash
(``ops/cuda/flash_attention.py``: the Hopper kernel on CUDA, its plain
version on the CPU), resolved per sequence length by
``ops/attention_dispatch.py``; ``attn_override`` (``[B, T, H, D]`` q, k,
v -> out) replaces it, which is how :func:`long_context_apply` runs the
sequence-parallel attention of ``parallel/sequence.py``.

MoE blocks (``num_experts > 0``, Switch top-1 routing, arXiv:2101.03961)
dispatch as the JAX package's do: ``capacity_factor == 0`` is the exact
dense dispatch (every expert sees every token through a one-hot einsum,
E times the MLP's FLOPs); ``capacity_factor > 0`` gathers each expert's
tokens into ``C = ceil(cf * B * T / E)`` slots in arrival order over the
flattened ``[B * T]`` tokens, and a token past its expert's capacity
contributes 0 (the residual passes it). flax sows the load-balance loss
and the fractions into collections; here ``forward(..., with_aux=True)``
returns them beside the logits, so that nothing of a forward stays on the
module, which serves every client through ``functional_call``.

``remat`` recomputes each block in the backward (the JAX package's
per-block ``nn.remat``; ``models/common.py`` ``rematerialized``); under
it the flash ``autograd.Function``'s forward runs again in the recompute
and saves its o and lse anew, so a remat step launches the flash kernel
twice a layer.
"""
from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.func import functional_call

from fedtorch_tpu_torch.models.common import (
    Dense, Embed, lecun_normal, rematerialized,
)
from fedtorch_tpu_torch.ops.attention_dispatch import resolve_attention
from fedtorch_tpu_torch.ops.cuda.flash_attention import flash_attention


class LayerNorm(nn.Module):
    """flax's ``nn.LayerNorm(dtype=float32)``: eps 1e-6, float32 out (the
    caller casts back)."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(dim))
        self.bias = nn.Parameter(torch.empty(dim))
        self.eps = eps

    def init_params(self, generator: torch.Generator) -> dict:
        return {"weight": torch.ones(self.weight.shape),
                "bias": torch.zeros(self.bias.shape)}

    def forward(self, x):
        return F.layer_norm(x.to(torch.float32), self.weight.shape,
                            self.weight, self.bias, self.eps)


class _SelfAttention(nn.Module):
    def __init__(self, d_model: int, num_heads: int, dtype: torch.dtype,
                 attention: str):
        super().__init__()
        self.qkv = Dense(d_model, 3 * d_model, bias=False, dtype=dtype)
        self.proj = Dense(d_model, d_model, bias=False, dtype=dtype)
        self.num_heads, self.dtype, self.attention = (num_heads, dtype,
                                                      attention)

    def attend(self, q, k, v):
        """Causal attention of ``[B, T, h, hd]`` q, k, v, in the compute
        dtype: flash or dense by the sequence length."""
        T = q.shape[1]
        if resolve_attention(self.attention, T) == "flash":
            return flash_attention(q, k, v, causal=True).to(self.dtype)
        scale = 1.0 / math.sqrt(q.shape[-1])
        scores = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
        mask = torch.ones(T, T, dtype=torch.bool, device=q.device).tril()
        scores = scores.masked_fill(~mask, -math.inf)
        probs = torch.softmax(scores.to(torch.float32), dim=-1)
        return torch.einsum("bhqk,bkhd->bqhd", probs.to(self.dtype), v)

    def forward(self, x, attn_override=None):
        B, T, d = x.shape
        H = self.num_heads
        # strided [B, T, H, hd] views of the projection: the kernel reads
        # them through their strides
        q, k, v = (t.reshape(B, T, H, d // H)
                   for t in self.qkv(x).chunk(3, dim=-1))
        out = self.attend(q, k, v) if attn_override is None \
            else attn_override(q, k, v)
        return self.proj(out.reshape(B, T, d))


# -- mixture of experts ------------------------------------------------------

class MoEGate(nn.Module):
    """The router's float32 kernel, ``[d, E]`` as flax's bias-free
    ``nn.Dense(E)`` holds it (lecun-normal, fan-in d)."""

    def __init__(self, d_model: int, num_experts: int):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(d_model, num_experts))

    def init_params(self, generator: torch.Generator) -> dict:
        return {"kernel": lecun_normal(self.kernel.shape,
                                       self.kernel.shape[0], generator)}


def moe_route(x, gate_kernel):
    """The Switch router on ``[B, T, d]`` tokens: ``(probs [B, T, E],
    top_p [B, T], sel [B, T])``, float32 logits of a float32 cast of x.
    ``argmax`` takes the first of tied maxima, as ``jnp.argmax`` does;
    ``amax`` splits its gradient over ties, as ``jnp.max`` does. Shared
    by :class:`MoEMLP` and the expert-parallel layer
    (``parallel/expert.py``)."""
    probs = torch.softmax(x.to(torch.float32) @ gate_kernel, dim=-1)
    return probs, probs.amax(dim=-1), probs.argmax(dim=-1)


def moe_capacity(capacity_factor: float, tokens: int, num_experts: int):
    """Slots an expert, ``max(1, ceil(cf * tokens / E))``."""
    return max(1, math.ceil(capacity_factor * tokens / num_experts))


def moe_expert_compute(x, onehot, w_in, b_in, w_out, b_out):
    """The exact dense dispatch -> expert MLP -> combine (every expert
    runs every token; the caller applies the gate probability): ``x [B,
    T, d]``, ``onehot [B, T, E']`` and the E' experts' weights. Shared by
    :class:`MoEMLP` and the expert-parallel layer."""
    dispatch = torch.einsum("bte,btd->ebtd", onehot, x)
    h = F.gelu(torch.einsum("ebtd,edf->ebtf", dispatch, w_in)
               + b_in[:, None, None], approximate="tanh")
    y = torch.einsum("ebtf,efd->ebtd", h, w_out) + b_out[:, None, None]
    # combine: each token reads back its own expert's row
    return torch.einsum("ebtd,bte->btd", y, onehot)


def moe_dispatch_plan(sel, num_experts: int, capacity: int):
    """The static-shape Switch plan of ``sel [B, T]``: ``(slot [N], keep
    [N], token_for_slot [E * C])`` over the N = B * T tokens in flattened
    order. Token n takes slot ``sel[n] * C + pos``, pos its arrival order
    within its expert; a token past capacity has ``keep`` False and the
    overflow slot E * C. ``token_for_slot`` inverts the map (N: an empty
    slot). The scatter writes every dropped token into the overflow slot,
    which is then cut off: its duplicate indices are harmless there, and
    every kept slot is written once. The arrival counts are a cumsum
    along each expert's row of the ``[E, N]`` one-hot, a scan along the
    innermost dimension: on an H100 a scan over the outer dimension of
    ``[N, E]`` took 2.9 ms a call at N = 16,384, E = 16."""
    E, C = num_experts, capacity
    sel_flat = sel.reshape(-1).long()
    n_tokens = sel_flat.shape[0]
    onehot = F.one_hot(sel_flat, E).T.contiguous()           # [E, N]
    pos = (torch.cumsum(onehot, dim=1) * onehot).sum(0) - 1  # [N]
    keep = pos < C
    slot = torch.where(keep, sel_flat * C + pos, E * C)
    token_for_slot = torch.full((E * C + 1,), n_tokens, dtype=torch.int64,
                                device=sel.device)
    token_for_slot[slot] = torch.arange(n_tokens, device=sel.device)
    return slot, keep, token_for_slot[:E * C]


def moe_expert_mlp(expert_in, w_in, b_in, w_out, b_out):
    """The experts' MLPs on gathered token blocks ``[E', C, d]`` as
    batched matmuls: the one definition of the expert math of both sparse
    paths (:func:`moe_sparse_compute` and the expert-parallel layer)."""
    h = F.gelu(torch.bmm(expert_in, w_in) + b_in[:, None],
               approximate="tanh")
    return torch.bmm(h, w_out) + b_out[:, None]


def moe_sparse_compute(x, sel, w_in, b_in, w_out, b_out, capacity: int,
                       plan=None):
    """Capacity-bounded Switch dispatch: gather each expert's routed
    tokens into ``[E, C, d]``, run the expert MLPs, scatter the rows back
    (a dropped token reads the zero row). Equals
    :func:`moe_expert_compute` when no expert overflows. ``plan``: a
    :func:`moe_dispatch_plan` the caller already made. The gathers are
    ``index_select``s, whose backward is ``index_add_`` (atomic adds on
    CUDA); advanced indexing's backward, a sorted accumulation, took 4.5
    ms a call on an H100 at the MoE cell's shapes. Only the pad rows take
    more than one addend, so the gradient of each real token has one
    term, whatever the order of the adds."""
    B, T, D = x.shape
    E = w_in.shape[0]
    slot, _, token_for_slot = plan if plan is not None \
        else moe_dispatch_plan(sel, E, capacity)
    zero = x.new_zeros(1, D)
    xf_pad = torch.cat([x.reshape(B * T, D), zero])
    expert_in = xf_pad.index_select(0, token_for_slot).reshape(
        E, capacity, D)
    y = moe_expert_mlp(expert_in, w_in, b_in, w_out, b_out)
    y_pad = torch.cat([y.reshape(E * capacity, D), zero.to(y.dtype)])
    return y_pad.index_select(0, slot).reshape(B, T, D)


class MoEMLP(nn.Module):
    """Top-1-gated mixture-of-experts MLP (Switch routing). The expert
    weights carry a leading ``[E]`` axis, the axis expert parallelism
    shards. ``forward`` returns ``(out, stats)``: ``stats`` holds the
    load-balance loss ``E * sum_e f_e * P_e`` (1 under uniform routing,
    E when collapsed; differentiable through P), the routed fractions f
    ``[E]`` and, under sparse dispatch, the fraction of tokens dropped."""

    def __init__(self, d_model: int, num_experts: int, mlp_ratio: int = 4,
                 dtype: torch.dtype = torch.float32,
                 capacity_factor: float = 0.0):
        super().__init__()
        E, hidden = num_experts, mlp_ratio * d_model
        self.gate = MoEGate(d_model, E)
        self.w_in = nn.Parameter(torch.empty(E, d_model, hidden))
        self.b_in = nn.Parameter(torch.empty(E, hidden))
        self.w_out = nn.Parameter(torch.empty(E, hidden, d_model))
        self.b_out = nn.Parameter(torch.empty(E, d_model))
        self.num_experts, self.dtype = num_experts, dtype
        self.capacity_factor = capacity_factor

    def init_params(self, generator: torch.Generator) -> dict:
        # lecun_normal(batch_axis=0): E is an expert axis, not a fan, so
        # each expert draws as an ordinary Dense does
        E, d, hidden = self.w_in.shape
        return {"w_in": lecun_normal(self.w_in.shape, d, generator),
                "b_in": torch.zeros(E, hidden),
                "w_out": lecun_normal(self.w_out.shape, hidden, generator),
                "b_out": torch.zeros(E, d)}

    def forward(self, x):
        dt, E = self.dtype, self.num_experts
        B, T, _ = x.shape
        probs, top_p, sel = moe_route(x, self.gate.kernel)
        frac = F.one_hot(sel, E).to(torch.float32).mean(dim=(0, 1))
        stats = {"load_balance": E * (frac * probs.mean(dim=(0, 1))).sum(),
                 "expert_fraction": frac}
        weights = [w.to(dt) for w in (self.w_in, self.b_in, self.w_out,
                                      self.b_out)]
        if self.capacity_factor > 0:
            capacity = moe_capacity(self.capacity_factor, B * T, E)
            plan = moe_dispatch_plan(sel, E, capacity)
            stats["drop_fraction"] = 1.0 - plan[1].to(torch.float32).mean()
            out = moe_sparse_compute(x.to(dt), sel, *weights, capacity,
                                     plan=plan)
        else:
            out = moe_expert_compute(x.to(dt), F.one_hot(sel, E).to(dt),
                                     *weights)
        return out * top_p[..., None].to(dt), stats


# -- the model ---------------------------------------------------------------

class _Block(nn.Module):
    """Pre-norm block: attention, then a dense GELU MLP of width 4 *
    d_model or (``num_experts > 0``) a Switch MoE. ``forward`` returns
    ``(x, stats)``, the MoE's stats or ``{}``."""

    def __init__(self, d_model: int, num_heads: int, dtype: torch.dtype,
                 attention: str, mlp_ratio: int = 4, num_experts: int = 0,
                 capacity_factor: float = 0.0):
        super().__init__()
        self.ln1 = LayerNorm(d_model)
        self.attn = _SelfAttention(d_model, num_heads, dtype, attention)
        self.ln2 = LayerNorm(d_model)
        if num_experts > 0:
            self.moe = MoEMLP(d_model, num_experts, mlp_ratio, dtype,
                              capacity_factor)
        else:
            self.mlp_in = Dense(d_model, mlp_ratio * d_model, dtype=dtype)
            self.mlp_out = Dense(mlp_ratio * d_model, d_model, dtype=dtype)
        self.dtype, self.num_experts = dtype, num_experts

    def forward(self, x, attn_override=None):
        x = x + self.attn(self.ln1(x).to(self.dtype), attn_override)
        h = self.ln2(x).to(self.dtype)
        if self.num_experts > 0:
            out, stats = self.moe(h)
            return x + out, stats
        h = self.mlp_in(h)
        return x + self.mlp_out(F.gelu(h, approximate="tanh")), {}


class TransformerLM(nn.Module):
    def __init__(self, vocab_size: int = 86, d_model: int = 128,
                 num_heads: int = 4, num_layers: int = 2,
                 max_len: int = 2048, dtype: torch.dtype = torch.float32,
                 attention: str = "dense", remat: bool = False,
                 num_experts: int = 0, capacity_factor: float = 0.0):
        super().__init__()
        resolve_attention(attention, 1)  # refuse an unknown mode now
        self.tok_embed = Embed(vocab_size, d_model)
        self.pos_embed = nn.Parameter(torch.empty(max_len, d_model))
        self.num_layers = num_layers
        for i in range(num_layers):
            setattr(self, f"block_{i}",
                    _Block(d_model, num_heads, dtype, attention,
                           num_experts=num_experts,
                           capacity_factor=capacity_factor))
        self.ln_f = LayerNorm(d_model)
        self.head = Dense(d_model, vocab_size)
        self.dtype, self.attention, self.remat = dtype, attention, remat
        self.num_heads, self.num_experts = num_heads, num_experts
        self.capacity_factor = capacity_factor

    def init_params(self, generator: torch.Generator) -> dict:
        return {"pos_embed": torch.randn(self.pos_embed.shape,
                                         generator=generator) * 0.02}

    def embed(self, tokens):
        """Token + positional embedding, ``[B, T] -> [B, T, D]``."""
        x = self.tok_embed(tokens).to(self.dtype)
        return x + self.pos_embed[:tokens.shape[1]].to(self.dtype)

    def apply_block(self, i: int, x, attn_override=None):
        """Block ``i`` on ``x``, rematerialized under ``remat``:
        ``(x, stats)``. The pipeline's stages run blocks through here."""
        block = getattr(self, f"block_{i}")
        if self.remat:
            return rematerialized(block, x, attn_override=attn_override)
        return block(x, attn_override)

    def head_apply(self, x):
        """Final norm + float32 head, ``[B, T, D] -> [B, T, vocab]``."""
        return self.head(self.ln_f(x))

    def forward(self, tokens, attn_override=None, with_aux: bool = False):
        """Logits; with ``with_aux``, ``(logits, aux)``: ``aux`` holds
        ``load_balance`` (the sum over MoE blocks, a float32 0-d tensor, 0
        without MoE), ``expert_fraction`` and ``drop_fraction`` (``{block_<i>:
        value}``, the latter under sparse dispatch only)."""
        x = self.embed(tokens)
        stats = {}
        for i in range(self.num_layers):
            x, s = self.apply_block(i, x, attn_override)
            if s:
                stats[f"block_{i}"] = s
        logits = self.head_apply(x)
        if not with_aux:
            return logits
        load = logits.new_zeros((), dtype=torch.float32)
        for s in stats.values():
            load = load + s["load_balance"]
        return logits, {
            "load_balance": load,
            **{key: {b: s[key] for b, s in stats.items() if key in s}
               for key in ("expert_fraction", "drop_fraction")}}


def _moe_stat(module: TransformerLM, params: dict, tokens, key: str):
    with torch.no_grad():
        _, aux = functional_call(module, params, (tokens,),
                                 {"with_aux": True})
    return aux[key]


def routing_fractions(module: TransformerLM, params: dict, tokens):
    """Per-block routed fractions f_e of a batch, ``{block_<i>: [E]}``
    (empty for a dense model): the collapse metric the aux loss
    optimizes."""
    return _moe_stat(module, params, tokens, "expert_fraction")


def drop_fractions(module: TransformerLM, params: dict, tokens):
    """Per-block fraction of tokens the capacity dropped, ``{block_<i>:
    0-d}`` (empty for a dense model or the exact dispatch): what tunes
    ``capacity_factor``."""
    return _moe_stat(module, params, tokens, "drop_fraction")


def long_context_apply(module: TransformerLM, params: dict, tokens, mesh,
                       axis_name: str = "sp", strategy: str = "ring",
                       block_impl: str = "dense"):
    """The forward with every attention block run sequence-parallel over
    ``mesh``'s ``axis_name``, ``strategy`` 'ring' (K/V rotation, any head
    count) or 'ulysses' (head-parallel all-to-all; heads divisible by the
    axis), ``block_impl`` 'dense' or 'flash' (the flash kernel per ring
    block, or for Ulysses' local head slice): see ``parallel/sequence.py``.

    As in the JAX package, every rank passes the whole ``[B, T]`` batch
    and gets the whole logits: the rest of the model runs replicated, and
    each attention takes this rank's ``T/n`` rows of q, k and v and
    gathers the outputs back (a gradient returns through both, so the
    forward trains)."""
    from fedtorch_tpu_torch.parallel.sequence import (
        gather_sequence, ring_attention, scatter_sequence, ulysses_attention,
    )

    if strategy not in ("ring", "ulysses"):
        raise ValueError(f"unknown sequence-parallel strategy {strategy!r}")
    fn = ring_attention if strategy == "ring" else ulysses_attention

    def attn(q, k, v):
        # one scatter (and one gather of its gradient) for q, k and v
        q, k, v = scatter_sequence(torch.stack((q, k, v), dim=2), mesh,
                                   axis_name).unbind(2)
        out = fn(q, k, v, mesh, axis_name=axis_name, causal=True,
                 block_impl=block_impl)
        return gather_sequence(out, mesh, axis_name)

    return functional_call(module, params, (tokens,),
                           {"attn_override": attn})
