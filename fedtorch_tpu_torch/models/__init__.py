"""Model registry (port of ``fedtorch_tpu/models/__init__.py``).

Every architecture of the JAX package's ``define_model``: the CIFAR
``resnet*`` family (and the ImageNet variant's class, which neither
package's ``define_model`` can reach: it raises as the JAX package does),
``wideresnet*`` and ``densenet*`` (plain and BC) with dropout, either
norm ('bn', 'gn') and either conv lowering ('conv', 'matmul'), the LeNet
``cnn``, the char-GRU ``rnn`` (a recurrent :class:`ModelDef` on
``[batch, rnn_seq_len]`` int64 tokens), the causal ``transformer`` LM
(dense MLP or Switch MoE blocks), and the flat models ``logistic_regression``,
``least_square`` and ``mlp`` (with dropout and either norm) with their
``robust_*`` variants. ``conv_impl='auto'`` resolves as the JAX
package's ``resolve_conv_impl`` does for an accelerator: the native
conv, whatever the device. ``cfg.mesh.remat`` recomputes each block of
the resnet, wideresnet, densenet and transformer families in the
backward, and warns that it has no effect on the others, as the JAX
package does. :func:`define_fused_model` builds the client-fused module
(``cfg.mesh.client_fusion='fused'``). Refused by name: compute dtypes
other than float32 and bfloat16.
"""
from __future__ import annotations

import warnings

import torch

from fedtorch_tpu_torch.config import ExperimentConfig
from fedtorch_tpu_torch.models.cnn import CNN, FusedCNN
from fedtorch_tpu_torch.models.common import (
    REGRESSION_DIMS, ModelDef, flat_input_size, image_shape,
)
from fedtorch_tpu_torch.models.densenet import build_densenet
from fedtorch_tpu_torch.models.linear import LeastSquare, LogisticRegression
from fedtorch_tpu_torch.models.mlp import MLP
from fedtorch_tpu_torch.models.resnet import build_fused_resnet, build_resnet
from fedtorch_tpu_torch.models.rnn import CharGRU
from fedtorch_tpu_torch.models.transformer import TransformerLM
from fedtorch_tpu_torch.models.wideresnet import build_wideresnet
from fedtorch_tpu_torch.utils import resolve_device

COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_CONV_FAMILIES = ("resnet", "wideresnet", "densenet", "cnn")


def resolve_conv_impl(conv_impl: str) -> str:
    """``conv_impl`` with 'auto' resolved as the JAX package resolves it
    on an accelerator: XLA's native conv there measured 5.06x the im2col
    matmul on a TPU v5e, and the port's native conv is cuDNN's; the JAX
    package's CPU choice of the matmul tracks XLA's CPU conv emitter,
    which the port does not have."""
    return "conv" if conv_impl == "auto" else conv_impl


def define_model(cfg: ExperimentConfig, batch_size: int = 2,
                 device=None) -> ModelDef:
    """Build a :class:`ModelDef` from config on ``device`` (``cuda``
    unless the caller asks for another)."""
    device = resolve_device(device)
    arch, dataset, m = cfg.model.arch, cfg.data.dataset, cfg.model
    remat = cfg.mesh.remat
    if remat and not (arch.startswith(("resnet", "wideresnet", "densenet"))
                      or arch == "transformer"):
        warnings.warn(
            f"--remat has no effect for arch {arch!r} (supported: "
            "resnet*/wideresnet*/densenet*/transformer — the deep "
            "activation-heavy families); running without "
            "rematerialization", stacklevel=2)
    if cfg.mesh.compute_dtype not in COMPUTE_DTYPES:
        raise ValueError(f"compute_dtype {cfg.mesh.compute_dtype!r} is "
                         "not yet ported")
    dtype = COMPUTE_DTYPES[cfg.mesh.compute_dtype]
    if m.conv_impl not in ("conv", "auto") \
            and not arch.startswith(_CONV_FAMILIES):
        warnings.warn(
            f"--conv_impl {m.conv_impl!r} has no effect for arch "
            f"{arch!r} (implemented for the conv families: resnet*/"
            "wideresnet*/densenet*/cnn); running with the native conv",
            stacklevel=2)
    conv_impl = resolve_conv_impl(m.conv_impl)
    if arch == "transformer":
        return _transformer(m, dtype, batch_size, device, remat)
    if arch == "rnn":
        module = CharGRU(m.vocab_size, m.rnn_hidden_size, dtype=dtype)
        sample = torch.zeros((batch_size, m.rnn_seq_len), dtype=torch.int64,
                             device=device)
        return ModelDef(arch, module.to(device), sample, is_recurrent=True)
    if arch in _FLAT_ARCHS:
        return _flat(cfg, dtype, batch_size, device)
    if arch == "cnn":
        module = CNN(dataset, image_shape(dataset), dtype, conv_impl)
    elif arch.startswith("wideresnet"):
        module = build_wideresnet(arch, dataset, m.wideresnet_widen_factor,
                                  dtype, m.drop_rate, m.norm, conv_impl,
                                  remat)
    elif arch.startswith("resnet"):
        module = build_resnet(arch, dataset, dtype, m.norm, conv_impl, remat)
    elif arch.startswith("densenet"):
        module = build_densenet(arch, dataset, m.densenet_growth_rate,
                                m.densenet_bc_mode, m.densenet_compression,
                                m.drop_rate, m.norm, dtype, conv_impl,
                                remat)
    else:
        raise ValueError(f"Unknown architecture {arch!r}")
    sample = torch.zeros((batch_size,) + image_shape(dataset),
                         device=device)
    return ModelDef(arch, module.to(device), sample,
                    has_dropout=arch.startswith(("wideresnet", "densenet"))
                    and m.drop_rate > 0)


_FLAT_ARCHS = ("logistic_regression", "robust_logistic_regression",
               "least_square", "robust_least_square", "mlp", "robust_mlp")


def _flat(cfg, dtype, batch_size: int, device) -> ModelDef:
    """The flat models on ``[B, features]`` inputs (the JAX package's
    ``_sample_flat`` / ``_sample_regression`` widths)."""
    arch, dataset, m = cfg.model.arch, cfg.data.dataset, cfg.model
    synthetic = dataset == "synthetic"
    robust = arch.startswith("robust_")
    base = arch[len("robust_"):] if robust else arch
    if base == "least_square":
        width = cfg.data.synthetic_dim if synthetic \
            else REGRESSION_DIMS[dataset]
        module = LeastSquare(dataset, width, dtype, robust)
    else:
        width = cfg.data.synthetic_dim if synthetic \
            else flat_input_size(dataset)
        if base == "logistic_regression":
            module = LogisticRegression(dataset, width, dtype, robust)
        else:
            module = MLP(dataset, width, m.mlp_num_layers, m.mlp_hidden_size,
                         dtype, m.drop_rate, m.norm, robust)
    sample = torch.zeros((batch_size, width), device=device)
    return ModelDef(arch, module.to(device), sample,
                    is_regression=base == "least_square",
                    has_noise_param=robust,
                    has_dropout=base == "mlp" and m.drop_rate > 0)


def define_fused_model(cfg: ExperimentConfig, num_clients: int,
                       device=None):
    """The client-fused module of ``cfg.mesh.client_fusion='fused'`` on
    ``device`` (``cuda`` unless the caller asks for another): its params
    are the per-client params stacked on a leading ``[num_clients]``
    axis, and it maps stacked ``[k, B, H, W, C]`` inputs to ``[k, B,
    classes]`` logits through grouped convolutions; None when the
    (arch, dataset, norm) triple has no fused form (the resnet-cifar
    family and the ``cnn`` with ``norm='bn'`` have one). Fusion is
    another lowering of the same math, so ``conv_impl`` does not apply
    to it."""
    device = resolve_device(device)
    arch, dataset, m = cfg.model.arch, cfg.data.dataset, cfg.model
    dtype = COMPUTE_DTYPES[cfg.mesh.compute_dtype]
    module = None
    if arch.startswith("resnet"):
        module = build_fused_resnet(arch, dataset, num_clients, m.norm,
                                    dtype, cfg.mesh.remat)
    elif arch == "cnn":
        try:
            shape = image_shape(dataset)
        except NotImplementedError:
            return None
        module = FusedCNN(dataset, shape, num_clients, dtype)
    return None if module is None else module.to(device)


def _transformer(m, dtype, batch_size: int, device,
                 remat: bool = False) -> ModelDef:
    """The JAX package's derivation (models/__init__.py:225-251): d_model
    = 2 * rnn_hidden_size, the first head count of (4, 2, 1) that divides
    it, mlp_num_layers blocks, the class's max_len of 2048; MoE blocks of
    ``moe_experts`` experts at ``moe_capacity_factor`` (with the JAX
    package's warning when 8 or more experts take the dense dispatch),
    whose load-balance loss the local step adds (``has_aux_loss``)."""
    d_model = 2 * m.rnn_hidden_size
    num_heads = next(h for h in (4, 2, 1) if d_model % h == 0)
    if m.moe_experts >= 8 and m.moe_capacity_factor == 0:
        warnings.warn(
            f"--moe_experts {m.moe_experts} with dense dispatch "
            f"executes {m.moe_experts}x the expert-MLP FLOPs "
            "(exactness-oracle mode). For training at scale set "
            "--moe_capacity_factor 1.25: measured 8.6x fewer "
            "executed FLOPs at E=16 with bounded token drop "
            "(docs/performance.md 'Dispatch A/B', MOE_AB_CPU.json)",
            stacklevel=3)
    module = TransformerLM(vocab_size=m.vocab_size, d_model=d_model,
                           num_heads=num_heads, num_layers=m.mlp_num_layers,
                           dtype=dtype, attention=m.attention, remat=remat,
                           num_experts=m.moe_experts,
                           capacity_factor=m.moe_capacity_factor).to(device)
    sample = torch.zeros((batch_size, m.rnn_seq_len), dtype=torch.int64,
                         device=device)
    return ModelDef("transformer", module, sample,
                    has_aux_loss=m.moe_experts > 0)


__all__ = ["ModelDef", "define_fused_model", "define_model"]
