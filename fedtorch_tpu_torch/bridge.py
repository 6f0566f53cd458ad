"""Weight bridge between the JAX package's flax params and the port's
``state_dict``.

The input is the flax params tree flattened to '/'-joined paths with
numpy leaves (``{'BasicBlock_0/Conv_0/kernel': array, ...}``). The port
names its modules like flax's auto-names, so a path maps onto a key by
joining with '.' and renaming the leaf:

* conv ``kernel`` HWIO -> ``weight`` OIHW
* ``Dense_0/kernel`` (in, out) -> ``Dense_0.weight`` (out, in), its
  ``bias`` unchanged
* ``BatchStatsNorm_*/scale``, ``bias`` -> ``weight``, ``bias``

Both directions raise on any leaf they cannot map, and
:func:`params_from_jax` raises when the result does not cover the model
exactly (pass ``expect`` = the model's params).
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

FlatParams = Dict[str, np.ndarray]


def _to_torch_leaf(path: str, value: np.ndarray):
    parts = path.split("/")
    module, leaf = parts[:-1], parts[-1]
    if not module:
        raise ValueError(f"unmatched flax leaf {path!r}")
    kind = module[-1].rsplit("_", 1)[0]
    if leaf == "kernel" and value.ndim == 4 and kind == "Conv":
        return ".".join(module + ["weight"]), value.transpose(3, 2, 0, 1)
    if leaf == "kernel" and value.ndim == 2 and kind == "Dense":
        return ".".join(module + ["weight"]), value.T
    if leaf == "bias" and kind in ("Dense", "BatchStatsNorm"):
        return ".".join(module + ["bias"]), value
    if leaf == "scale" and kind == "BatchStatsNorm":
        return ".".join(module + ["weight"]), value
    raise ValueError(f"unmatched flax leaf {path!r} with shape "
                     f"{value.shape}")


def _to_jax_leaf(key: str, value: np.ndarray):
    parts = key.split(".")
    module, leaf = parts[:-1], parts[-1]
    if not module:
        raise ValueError(f"unmatched torch leaf {key!r}")
    kind = module[-1].rsplit("_", 1)[0]
    if leaf == "weight" and value.ndim == 4 and kind == "Conv":
        return "/".join(module + ["kernel"]), value.transpose(2, 3, 1, 0)
    if leaf == "weight" and value.ndim == 2 and kind == "Dense":
        return "/".join(module + ["kernel"]), value.T
    if leaf == "bias" and kind in ("Dense", "BatchStatsNorm"):
        return "/".join(module + ["bias"]), value
    if leaf == "weight" and kind == "BatchStatsNorm":
        return "/".join(module + ["scale"]), value
    raise ValueError(f"unmatched torch leaf {key!r} with shape "
                     f"{tuple(value.shape)}")


def params_from_jax(flat: FlatParams,
                    expect: Optional[Dict[str, torch.Tensor]] = None
                    ) -> Dict[str, torch.Tensor]:
    """Flattened flax params -> the port's params dict (float32 CPU
    tensors). With ``expect`` (the model's params), the keys and shapes
    must match exactly, in either direction."""
    out = {}
    for path, value in flat.items():
        key, v = _to_torch_leaf(path, np.asarray(value))
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


def params_to_jax(params: Dict[str, torch.Tensor]) -> FlatParams:
    """The port's params dict -> flattened flax params (numpy)."""
    out = {}
    for key, value in params.items():
        path, v = _to_jax_leaf(key, value.detach().float().cpu().numpy())
        out[path] = np.ascontiguousarray(v)
    return out
