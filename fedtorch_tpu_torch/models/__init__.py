"""Model registry (port of ``fedtorch_tpu/models/__init__.py``).

The CIFAR-family ``resnet*`` and ``wideresnet*`` (without dropout) with
``norm='bn'`` and the native conv lowering are ported; every other
architecture and option is refused by name.
"""
from __future__ import annotations

import torch

from fedtorch_tpu_torch.config import ExperimentConfig
from fedtorch_tpu_torch.models.common import ModelDef, image_shape
from fedtorch_tpu_torch.models.resnet import build_resnet
from fedtorch_tpu_torch.models.wideresnet import build_wideresnet
from fedtorch_tpu_torch.utils import resolve_device

COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def define_model(cfg: ExperimentConfig, batch_size: int = 2,
                 device=None) -> ModelDef:
    """Build a :class:`ModelDef` from config on ``device`` (``cuda``
    unless the caller asks for another)."""
    device = resolve_device(device)
    arch, dataset, m = cfg.model.arch, cfg.data.dataset, cfg.model
    if not arch.startswith(("resnet", "wideresnet")):
        raise ValueError(f"arch {arch!r} is not yet ported (the port has "
                         "the cifar resnet* and wideresnet* families)")
    if arch.startswith("wideresnet") and m.drop_rate > 0:
        raise ValueError(f"drop_rate {m.drop_rate} (dropout in "
                         "wideresnet blocks) is not yet ported")
    if m.norm != "bn":
        raise ValueError(f"norm {m.norm!r} is not yet ported (the port "
                         "has norm='bn')")
    if m.conv_impl not in ("conv", "auto"):
        raise ValueError(f"conv_impl {m.conv_impl!r} is not yet ported "
                         "(the port runs the native conv)")
    if cfg.mesh.remat:
        raise ValueError("remat is not yet ported")
    if cfg.mesh.compute_dtype not in COMPUTE_DTYPES:
        raise ValueError(f"compute_dtype {cfg.mesh.compute_dtype!r} is "
                         "not yet ported")
    dtype = COMPUTE_DTYPES[cfg.mesh.compute_dtype]
    if arch.startswith("wideresnet"):
        module = build_wideresnet(arch, dataset, m.wideresnet_widen_factor,
                                  dtype)
    else:
        module = build_resnet(arch, dataset, dtype)
    module = module.to(device)
    sample = torch.zeros((batch_size,) + image_shape(dataset),
                         device=device)
    return ModelDef(arch, module, sample)


__all__ = ["ModelDef", "define_model"]
