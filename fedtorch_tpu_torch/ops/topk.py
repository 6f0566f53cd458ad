"""Fixed-k top-k sparsification (port of ``fedtorch_tpu/ops/topk.py``).

``k = int(n * r / 2)`` elements of a flattened tensor are kept: the /2
accounts for sending (value, index) pairs, so the ratio ``r`` measures
bytes, not elements. Error-feedback memory is the callers' (FedGATE's
``compressed`` wire format, Qsparse).

Order: ``lax.top_k`` keeps, among equal |x|, the lower index, and puts
NaN above every number. ``torch.topk`` promises no order among ties (x
and -x tie at the k-th boundary), on the CPU or on CUDA, so the
selection here is a stable descending sort of an int32 key of |x|'s
bits (``core/losses.py``'s total order), which keeps that rule on
either device.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from fedtorch_tpu_torch.core.losses import _total_order_key


class Sparse(NamedTuple):
    """k values and their int32 flat indices, with the original shape."""
    values: torch.Tensor   # [k]
    indices: torch.Tensor  # [k] int32
    shape: tuple


def num_kept(n: int, ratio: float) -> int:
    """k = n*r/2; raises where that is 0, as the reference does."""
    k = int(n * ratio / 2)
    if k == 0:
        raise ValueError("Compression ratio is too low!")
    return k


def compress(x: torch.Tensor, ratio: float = 0.5, comp_type: str = "topk",
             generator: Optional[torch.Generator] = None) -> Sparse:
    """Top-k (by |x|) or random-k (``generator`` draws the k) selection
    of a flattened tensor."""
    shape = tuple(x.shape)
    x_f = x.reshape(-1)
    k = num_kept(x_f.shape[0], ratio)
    if comp_type == "topk":
        # the k largest |x|, ties to the lower index
        idx = torch.sort(_total_order_key(x_f.abs()), descending=True,
                         stable=True).indices[:k]
    elif comp_type == "random":
        if generator is None:
            raise ValueError("random compression requires a generator")
        idx = torch.randperm(x_f.shape[0], generator=generator)[:k].to(
            x.device)
    else:
        raise NotImplementedError(comp_type)
    return Sparse(values=x_f[idx], indices=idx.to(torch.int32), shape=shape)


def decompress(sp: Sparse) -> torch.Tensor:
    """Scatter the values back into a dense zero tensor (out of place, so
    that it runs per client under ``torch.func.vmap`` too)."""
    n = 1
    for d in sp.shape:
        n *= d
    dense = torch.zeros(n, dtype=sp.values.dtype, device=sp.values.device)
    return dense.scatter(0, sp.indices.long(), sp.values).reshape(sp.shape)


def topk_roundtrip(x: torch.Tensor, ratio: float = 0.5) -> torch.Tensor:
    """compress -> decompress: the dense tensor the receiver sees."""
    return decompress(compress(x, ratio=ratio, comp_type="topk"))


def compress_pytree(tree: dict, ratio: float = 0.5):
    """Per-leaf top-k round trip: (dense reconstruction, residual), the
    residual ``x - reconstruction`` being the error-feedback increment."""
    recon = {n: topk_roundtrip(x, ratio) for n, x in tree.items()}
    residual = {n: x - recon[n] for n, x in tree.items()}
    return recon, residual
