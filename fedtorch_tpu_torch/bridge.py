"""Weight bridge between the JAX package's flax params and the port's
``state_dict``.

The input is the flax params tree flattened to '/'-joined paths with
numpy leaves (``{'BasicBlock_0/Conv_0/kernel': array, ...}``). The port
names its modules as the flax modules are named, so a path maps onto a
key by joining with '.' and renaming the leaf by the kind of the module
that owns it:

* ``Conv``: ``kernel`` HWIO -> ``weight`` OIHW, ``bias``
* ``Dense``: ``kernel`` (in, out) -> ``weight`` (out, in), ``bias``
* ``BatchStatsNorm``, ``LayerNorm``, ``GroupNorm`` (the child of a
  ``_GN``): ``scale``, ``bias`` -> ``weight``, ``bias``
* ``Embed``: ``embedding`` -> ``weight``
* ``MoEMLP``: ``w_in``, ``b_in``, ``w_out``, ``b_out``, and its
  ``MoEGate``'s ``kernel``: themselves, in the JAX layout (the expert
  weights are not ``Dense`` kernels: nothing is transposed)
* a param of the model itself (the transformer's ``pos_embed``, a robust
  model's ``noise``): itself

``MatmulConv`` (the im2col conv) has ``Conv``'s tree.

With ``module`` (the port's model) the kind is the class of the
submodule that owns the leaf, so explicitly named layers (the
transformer's ``qkv``, ``ln1``, ``tok_embed``) map too; without it, the
kind is read off flax's auto-name (``Conv_0`` -> ``Conv``), which covers
the ResNet, WideResNet, LeNet ``cnn`` and linear trees, and a layer
named explicitly (the MLP's ``layer1`` and ``fc``, the char-GRU's gates
``gru_l0.ir`` ... ``hn`` and ``decoder``) maps by its leaf and rank: a
2-D kernel is a ``Dense`` one, a 4-D kernel a ``Conv`` one, a 1-D scale
a norm's (an explicitly named ``Embed`` table, 2-D like a ``Dense``
weight, needs ``module``). A gate without a bias (the GRU's ``hr`` and
``hz``) has no bias leaf on either side.

Both directions raise on any leaf they cannot map, and
:func:`params_from_jax` raises when the result does not cover the model
exactly (pass ``expect`` = the model's params).
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

FlatParams = Dict[str, np.ndarray]


def _same(v):
    return v


def _t(v):
    return v.T


# kind -> {flax leaf: (torch leaf, flax->torch, torch->flax, ndim)};
# ndim None takes any rank
_RULES = {
    "Conv": {"kernel": ("weight", lambda v: v.transpose(3, 2, 0, 1),
                        lambda v: v.transpose(2, 3, 1, 0), 4),
             "bias": ("bias", _same, _same, None)},
    "Dense": {"kernel": ("weight", _t, _t, 2),
              "bias": ("bias", _same, _same, None)},
    "BatchStatsNorm": {"scale": ("weight", _same, _same, None),
                       "bias": ("bias", _same, _same, None)},
    "Embed": {"embedding": ("weight", _same, _same, 2)},
    "MoEMLP": {leaf: (leaf, _same, _same, ndim) for leaf, ndim in (
        ("w_in", 3), ("b_in", 2), ("w_out", 3), ("b_out", 2))},
    "MoEGate": {"kernel": ("kernel", _same, _same, 2)},
}
_RULES["LayerNorm"] = _RULES["GroupNorm"] = _RULES["BatchStatsNorm"]
_RULES["MatmulConv"] = _RULES["Conv"]
# params of the model itself that map without ``module``
_ROOT_LEAVES = ("noise",)

# without ``module``, the kind of an explicitly named layer's leaf, by
# (leaf, rank) in either direction
_BY_LEAF = {("kernel", 2): "Dense", ("kernel", 4): "Conv",
            ("scale", 1): "BatchStatsNorm", ("weight", 2): "Dense",
            ("weight", 4): "Conv", ("weight", 1): "BatchStatsNorm",
            ("bias", 1): "Dense"}


def _kind(owner: list, module) -> Optional[str]:
    """The kind of the module at path ``owner``; None for the model
    itself."""
    if not owner:
        return None if module is not None else "unknown"
    if module is None:
        return owner[-1].rsplit("_", 1)[0]
    try:
        return type(module.get_submodule(".".join(owner))).__name__
    except AttributeError:
        return "unknown"


def _kind_of_leaf(owner: list, leaf: str, ndim: int, module):
    if not owner and leaf in _ROOT_LEAVES:
        return None
    kind = _kind(owner, module)
    if module is None and kind not in _RULES and owner:
        return _BY_LEAF.get((leaf, ndim), kind)
    return kind


def _to_torch_leaf(path: str, value: np.ndarray, module=None):
    *owner, leaf = path.split("/")
    kind = _kind_of_leaf(owner, leaf, value.ndim, module)
    if kind is None:
        return leaf, value
    rule = _RULES.get(kind, {}).get(leaf)
    if rule is not None and rule[3] in (None, value.ndim):
        return ".".join(owner + [rule[0]]), rule[1](value)
    raise ValueError(f"unmatched flax leaf {path!r} with shape "
                     f"{value.shape}")


def _to_jax_leaf(key: str, value: np.ndarray, module=None):
    *owner, leaf = key.split(".")
    kind = _kind_of_leaf(owner, leaf, value.ndim, module)
    if kind is None:
        return leaf, value
    for flax_leaf, (name, _, back, ndim) in _RULES.get(kind, {}).items():
        if name == leaf and ndim in (None, value.ndim):
            return "/".join(owner + [flax_leaf]), back(value)
    raise ValueError(f"unmatched torch leaf {key!r} with shape "
                     f"{tuple(value.shape)}")


def params_from_jax(flat: FlatParams,
                    expect: Optional[Dict[str, torch.Tensor]] = None,
                    module=None) -> Dict[str, torch.Tensor]:
    """Flattened flax params -> the port's params dict (float32 CPU
    tensors). With ``expect`` (the model's params), the keys and shapes
    must match exactly, in either direction. ``module``: the port's
    model, whose submodules say how each leaf maps."""
    out = {}
    for path, value in flat.items():
        key, v = _to_torch_leaf(path, np.asarray(value), module)
        out[key] = torch.from_numpy(np.array(v, np.float32))
    if expect is not None:
        missing = sorted(set(expect) - set(out))
        extra = sorted(set(out) - set(expect))
        if missing or extra:
            raise ValueError(f"params do not match the model: missing "
                             f"{missing}, unmatched {extra}")
        for k, v in expect.items():
            if tuple(v.shape) != tuple(out[k].shape):
                raise ValueError(f"{k}: shape {tuple(out[k].shape)} from "
                                 f"flax, {tuple(v.shape)} in the model")
        out = {k: out[k] for k in expect}
    return out


def params_to_jax(params: Dict[str, torch.Tensor],
                  module=None) -> FlatParams:
    """The port's params dict -> flattened flax params (numpy).
    ``module`` as for :func:`params_from_jax`."""
    out = {}
    for key, value in params.items():
        path, v = _to_jax_leaf(key, value.detach().float().cpu().numpy(),
                               module)
        out[path] = np.ascontiguousarray(v)
    return out
