"""Char-GRU for Shakespeare (port of ``fedtorch_tpu/models/rnn.py``;
ref: nonconvex/rnn.py:7-47).

Embedding -> ``n_layers`` GRU layers -> a float32 ``decoder`` over the
character vocabulary. The embedding, the GRU and the carried hidden
state run in the compute dtype. The hidden state is an explicit input
and output, ``[n_layers, B, hidden]`` (``initial_carry`` is zeros), so
the engine threads it through a client's local steps. Output is
``[B, T, vocab]``.

The cell is flax's ``nn.GRUCell``, written out from its equations
(``torch.nn.GRU`` has hidden-to-hidden biases on the r and z gates that
flax's cell lacks, which would add trainable params)::

    r  = sigmoid(x W_ir + b_ir + h W_hr)
    z  = sigmoid(x W_iz + b_iz + h W_hz)
    n  = tanh(x W_in + b_in + r * (h W_hn + b_hn))
    h' = (1 - z) * n + z * h

Each gate is a ``Dense`` named as flax names it (``gru_l{i}.ir``, ...,
``hn``; ``hr`` and ``hz`` bias-free; the hidden kernels drawn
orthogonal, flax's default), so the params cross the bridge by name. The
form: the input gates of all T steps are computed up front, then a
Python loop over T takes one product of h with the three hidden kernels
concatenated (the same params; only the launch count changes). The scan
is XLA's in the JAX package, not a Pallas kernel, so stock PyTorch ops
are the port here.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from fedtorch_tpu_torch.models.common import Dense, Embed


class GRUCell(nn.Module):
    """flax's ``nn.GRUCell(features=hidden, dtype=dtype)``."""

    def __init__(self, hidden: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        for gate in ("ir", "iz", "in"):
            self.add_module(gate, Dense(hidden, hidden, dtype=dtype))
        for gate in ("hr", "hz", "hn"):
            self.add_module(gate, Dense(hidden, hidden, bias=gate == "hn",
                                        dtype=dtype,
                                        kernel_init="orthogonal"))
        self.dtype = dtype

    def forward(self, x, h):
        """x: [B, T, hidden], h: [B, hidden], both in the compute dtype ->
        (h after step T, outputs [B, T, hidden])."""
        g = self._modules
        dt = self.dtype
        gi = [g[n](x) for n in ("ir", "iz", "in")]  # [B, T, hidden] each
        w_h = torch.cat([g[n].weight for n in ("hr", "hz", "hn")]).to(dt)
        b_hn = g["hn"].bias.to(dt)
        outs = []
        for t in range(x.shape[1]):
            gh_r, gh_z, gh_n = F.linear(h, w_h).chunk(3, dim=-1)
            r = torch.sigmoid(gi[0][:, t] + gh_r)
            z = torch.sigmoid(gi[1][:, t] + gh_z)
            n = torch.tanh(gi[2][:, t] + r * (gh_n + b_hn))
            h = (1.0 - z) * n + z * h
            outs.append(h)
        return h, torch.stack(outs, dim=1)


class CharGRU(nn.Module):
    def __init__(self, vocab_size: int = 86, hidden_size: int = 50,
                 n_layers: int = 1, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.Embed_0 = Embed(vocab_size, hidden_size)
        for layer in range(n_layers):
            self.add_module(f"gru_l{layer}", GRUCell(hidden_size, dtype))
        self.decoder = Dense(hidden_size, vocab_size)
        self.n_layers, self.hidden_size, self.dtype = \
            n_layers, hidden_size, dtype

    def forward(self, tokens, carry):
        """tokens: [B, T] int; carry: [n_layers, B, hidden] -> (logits
        [B, T, vocab] float32, the new carry in the compute dtype)."""
        x = self.Embed_0(tokens).to(self.dtype)
        new_carries = []
        for layer in range(self.n_layers):
            h, x = getattr(self, f"gru_l{layer}")(
                x, carry[layer].to(self.dtype))
            new_carries.append(h)
        return self.decoder(x.to(torch.float32)), torch.stack(new_carries)

    def initial_carry(self, batch_size: int) -> torch.Tensor:
        return torch.zeros((self.n_layers, batch_size, self.hidden_size),
                           dtype=self.dtype)
