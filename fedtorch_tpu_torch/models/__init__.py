"""Model registry (port of ``fedtorch_tpu/models/__init__.py``).

Only the CIFAR-family ``resnet*`` with ``norm='bn'`` and the native
conv lowering is ported; every other architecture and option is refused
by name.
"""
from __future__ import annotations

import torch

from fedtorch_tpu_torch.config import ExperimentConfig
from fedtorch_tpu_torch.models.common import ModelDef, image_shape
from fedtorch_tpu_torch.models.resnet import build_resnet
from fedtorch_tpu_torch.utils import resolve_device

COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def define_model(cfg: ExperimentConfig, batch_size: int = 2,
                 device=None) -> ModelDef:
    """Build a :class:`ModelDef` from config on ``device`` (``cuda``
    unless the caller asks for another)."""
    device = resolve_device(device)
    arch, dataset, m = cfg.model.arch, cfg.data.dataset, cfg.model
    if not arch.startswith("resnet") or arch.startswith("resnext"):
        raise ValueError(f"arch {arch!r} is not yet ported (the port has "
                         "the cifar resnet* family)")
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
    module = build_resnet(arch, dataset,
                          COMPUTE_DTYPES[cfg.mesh.compute_dtype])
    module = module.to(device)
    sample = torch.zeros((batch_size,) + image_shape(dataset),
                         device=device)
    return ModelDef(arch, module, sample)


__all__ = ["ModelDef", "define_model"]
