"""Model registry (port of ``fedtorch_tpu/models/__init__.py``).

The CIFAR-family ``resnet*`` and ``wideresnet*`` (without dropout) with
``norm='bn'`` and the native conv lowering, the LeNet ``cnn``, the
char-GRU ``rnn`` (a recurrent :class:`ModelDef` on ``[batch,
rnn_seq_len]`` int64 tokens), the causal ``transformer`` LM (dense MLP
blocks), and the flat models ``logistic_regression``, ``least_square``
and ``mlp`` (without dropout) are ported; every other architecture and
option is refused by name.
"""
from __future__ import annotations

import torch

from fedtorch_tpu_torch.config import ExperimentConfig
from fedtorch_tpu_torch.models.cnn import CNN
from fedtorch_tpu_torch.models.common import (
    REGRESSION_DIMS, ModelDef, flat_input_size, image_shape,
)
from fedtorch_tpu_torch.models.linear import LeastSquare, LogisticRegression
from fedtorch_tpu_torch.models.mlp import MLP
from fedtorch_tpu_torch.models.resnet import build_resnet
from fedtorch_tpu_torch.models.rnn import CharGRU
from fedtorch_tpu_torch.models.transformer import TransformerLM
from fedtorch_tpu_torch.models.wideresnet import build_wideresnet
from fedtorch_tpu_torch.utils import resolve_device

COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def define_model(cfg: ExperimentConfig, batch_size: int = 2,
                 device=None) -> ModelDef:
    """Build a :class:`ModelDef` from config on ``device`` (``cuda``
    unless the caller asks for another)."""
    device = resolve_device(device)
    arch, dataset, m = cfg.model.arch, cfg.data.dataset, cfg.model
    if cfg.mesh.remat:
        raise ValueError("remat is not yet ported")
    if cfg.mesh.compute_dtype not in COMPUTE_DTYPES:
        raise ValueError(f"compute_dtype {cfg.mesh.compute_dtype!r} is "
                         "not yet ported")
    dtype = COMPUTE_DTYPES[cfg.mesh.compute_dtype]
    if arch == "transformer":
        return _transformer(m, dtype, batch_size, device)
    if arch == "rnn":
        module = CharGRU(m.vocab_size, m.rnn_hidden_size, dtype=dtype)
        sample = torch.zeros((batch_size, m.rnn_seq_len), dtype=torch.int64,
                             device=device)
        return ModelDef(arch, module.to(device), sample, is_recurrent=True)
    if arch in _FLAT_ARCHS:
        return _flat(cfg, dtype, batch_size, device)
    if arch in _REFUSED_ARCHS:
        raise ValueError(f"arch {arch!r} is not yet ported: "
                         f"{_REFUSED_ARCHS[arch]}")
    if not arch.startswith(("resnet", "wideresnet")) and arch != "cnn":
        raise ValueError(f"arch {arch!r} is not yet ported (the port has "
                         "the cifar resnet* and wideresnet* families, cnn, "
                         f"rnn, the transformer and {', '.join(_FLAT_ARCHS)})")
    if arch.startswith("wideresnet") and m.drop_rate > 0:
        raise ValueError(f"drop_rate {m.drop_rate} (dropout in "
                         "wideresnet blocks) is not yet ported")
    if m.norm != "bn" and arch != "cnn":  # the cnn has no norm
        raise ValueError(f"norm {m.norm!r} is not yet ported (the port "
                         "has norm='bn')")
    if m.conv_impl not in ("conv", "auto"):
        raise ValueError(f"conv_impl {m.conv_impl!r} is not yet ported "
                         "(the port runs the native conv)")
    if arch == "cnn":
        module = CNN(dataset, image_shape(dataset), dtype)
    elif arch.startswith("wideresnet"):
        module = build_wideresnet(arch, dataset, m.wideresnet_widen_factor,
                                  dtype)
    else:
        module = build_resnet(arch, dataset, dtype)
    module = module.to(device)
    sample = torch.zeros((batch_size,) + image_shape(dataset),
                         device=device)
    return ModelDef(arch, module, sample)


_FLAT_ARCHS = ("logistic_regression", "least_square", "mlp")
_REFUSED_ARCHS = {
    "robust_logistic_regression": "its input-noise ascent "
                                  "(robust_noise_ascent) is not ported",
    "robust_least_square": "its input-noise ascent (robust_noise_ascent) "
                           "is not ported",
    "robust_mlp": "its input-noise ascent (robust_noise_ascent) is not "
                  "ported",
    "LinearMAFL": "AFL's factorized linear model goes with the AFL "
                  "algorithm",
}


def _flat(cfg, dtype, batch_size: int, device) -> ModelDef:
    """The flat models on ``[B, features]`` inputs (the JAX package's
    ``_sample_flat`` / ``_sample_regression`` widths)."""
    arch, dataset, m = cfg.model.arch, cfg.data.dataset, cfg.model
    synthetic = dataset == "synthetic"
    if arch == "least_square":
        width = cfg.data.synthetic_dim if synthetic \
            else REGRESSION_DIMS[dataset]
        module = LeastSquare(dataset, width, dtype)
    else:
        width = cfg.data.synthetic_dim if synthetic \
            else flat_input_size(dataset)
        if arch == "logistic_regression":
            module = LogisticRegression(dataset, width, dtype)
        else:
            if m.drop_rate > 0:
                raise ValueError(f"drop_rate {m.drop_rate} (dropout in the "
                                 "mlp) is not yet ported")
            if m.norm != "bn":
                raise ValueError(f"norm {m.norm!r} is not yet ported (the "
                                 "port has norm='bn')")
            module = MLP(dataset, width, m.mlp_num_layers, m.mlp_hidden_size,
                         dtype)
    sample = torch.zeros((batch_size, width), device=device)
    return ModelDef(arch, module.to(device), sample,
                    is_regression=arch == "least_square")


def _transformer(m, dtype, batch_size: int, device) -> ModelDef:
    """The JAX package's derivation (models/__init__.py:225-251): d_model
    = 2 * rnn_hidden_size, the first head count of (4, 2, 1) that divides
    it, mlp_num_layers blocks, the class's max_len of 2048."""
    if m.moe_experts > 0:
        raise ValueError(f"moe_experts {m.moe_experts} (MoE blocks) is not "
                         "yet ported")
    d_model = 2 * m.rnn_hidden_size
    num_heads = next(h for h in (4, 2, 1) if d_model % h == 0)
    module = TransformerLM(vocab_size=m.vocab_size, d_model=d_model,
                           num_heads=num_heads, num_layers=m.mlp_num_layers,
                           dtype=dtype, attention=m.attention).to(device)
    sample = torch.zeros((batch_size, m.rnn_seq_len), dtype=torch.int64,
                         device=device)
    return ModelDef("transformer", module, sample)


__all__ = ["ModelDef", "define_model"]
