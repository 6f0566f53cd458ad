"""Causal transformer language model, port of
``fedtorch_tpu/models/transformer.py`` (``_SelfAttention``, the dense-MLP
``_Block``, ``TransformerLM``).

``[B, T]`` tokens -> ``[B, T, vocab]`` float32 logits: token plus learned
positional embedding, pre-norm blocks (attention, GELU MLP), a final
norm and a float32 head. Module names are the flax names (``tok_embed``,
``pos_embed``, ``block_<i>.{ln1, attn.qkv, attn.proj, ln2, mlp_in,
mlp_out}``, ``ln_f``, ``head``), so ``bridge.py`` maps the params both
ways by the class of the module that owns each leaf.

Numerics follow flax's: every ``LayerNorm`` has eps 1e-6 and computes in
float32, its output cast back to the compute dtype; the GELU is the tanh
approximation; ``qkv``, ``proj``, ``mlp_in`` and ``mlp_out`` run in the
compute dtype, the head in float32 on ``ln_f``'s float32 output; the
token embedding is cast to the compute dtype before the positional one
is added. Attention is dense (float32 softmax over compute-dtype
scores) or flash (``ops/cuda/flash_attention.py``: the Hopper kernel on
CUDA, its plain version on the CPU), resolved per sequence length by
``ops/attention_dispatch.py``.

``remat`` recomputes each block in the backward (the JAX package's
per-block ``nn.remat``; ``models/common.py`` ``rematerialized``); under
it the flash ``autograd.Function``'s forward runs again in the recompute
and saves its o and lse anew, so a remat step launches the flash kernel
twice a layer.

Not ported, refused by ``define_model``: MoE blocks (``moe_experts >
0``); and :func:`long_context_apply` (sequence-parallel ring/Ulysses
attention) raises.
"""
from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from fedtorch_tpu_torch.models.common import Dense, Embed, rematerialized
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

    def forward(self, x):
        B, T, d = x.shape
        H = self.num_heads
        # strided [B, T, H, hd] views of the projection: the kernel reads
        # them through their strides
        q, k, v = (t.reshape(B, T, H, d // H)
                   for t in self.qkv(x).chunk(3, dim=-1))
        if resolve_attention(self.attention, T) == "flash":
            out = flash_attention(q, k, v, causal=True).to(self.dtype)
        else:
            scale = 1.0 / math.sqrt(d // H)
            scores = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
            mask = torch.ones(T, T, dtype=torch.bool,
                              device=x.device).tril()
            scores = scores.masked_fill(~mask, -math.inf)
            probs = torch.softmax(scores.to(torch.float32), dim=-1)
            out = torch.einsum("bhqk,bkhd->bqhd", probs.to(self.dtype), v)
        return self.proj(out.reshape(B, T, d))


class _Block(nn.Module):
    """Pre-norm block with a dense GELU MLP of width 4 * d_model."""

    def __init__(self, d_model: int, num_heads: int, dtype: torch.dtype,
                 attention: str, mlp_ratio: int = 4):
        super().__init__()
        self.ln1 = LayerNorm(d_model)
        self.attn = _SelfAttention(d_model, num_heads, dtype, attention)
        self.ln2 = LayerNorm(d_model)
        self.mlp_in = Dense(d_model, mlp_ratio * d_model, dtype=dtype)
        self.mlp_out = Dense(mlp_ratio * d_model, d_model, dtype=dtype)
        self.dtype = dtype

    def forward(self, x):
        x = x + self.attn(self.ln1(x).to(self.dtype))
        h = self.mlp_in(self.ln2(x).to(self.dtype))
        return x + self.mlp_out(F.gelu(h, approximate="tanh"))


class TransformerLM(nn.Module):
    def __init__(self, vocab_size: int = 86, d_model: int = 128,
                 num_heads: int = 4, num_layers: int = 2,
                 max_len: int = 2048, dtype: torch.dtype = torch.float32,
                 attention: str = "dense", remat: bool = False):
        super().__init__()
        resolve_attention(attention, 1)  # refuse an unknown mode now
        self.tok_embed = Embed(vocab_size, d_model)
        self.pos_embed = nn.Parameter(torch.empty(max_len, d_model))
        self.num_layers = num_layers
        for i in range(num_layers):
            setattr(self, f"block_{i}",
                    _Block(d_model, num_heads, dtype, attention))
        self.ln_f = LayerNorm(d_model)
        self.head = Dense(d_model, vocab_size)
        self.dtype, self.attention, self.remat = dtype, attention, remat

    def init_params(self, generator: torch.Generator) -> dict:
        return {"pos_embed": torch.randn(self.pos_embed.shape,
                                         generator=generator) * 0.02}

    def embed(self, tokens):
        """Token + positional embedding, ``[B, T] -> [B, T, D]``."""
        x = self.tok_embed(tokens).to(self.dtype)
        return x + self.pos_embed[:tokens.shape[1]].to(self.dtype)

    def head_apply(self, x):
        """Final norm + float32 head, ``[B, T, D] -> [B, T, vocab]``."""
        return self.head(self.ln_f(x))

    def forward(self, tokens):
        x = self.embed(tokens)
        for i in range(self.num_layers):
            block = getattr(self, f"block_{i}")
            x = rematerialized(block, x) if self.remat else block(x)
        return self.head_apply(x)


def long_context_apply(*args, **kwargs):
    """The JAX package's sequence-parallel forward (ring or Ulysses
    attention over a mesh axis): not ported."""
    raise ValueError("long_context_apply (sequence-parallel ring/Ulysses "
                     "attention) is not yet ported")
