"""The client-fusion gate (port of ``fedtorch_tpu/parallel/fusion.py``):
the execution axis of the round-program builder
(``parallel/round_program.py``), which configurations may pack the k
online clients into grouped convolutions.

``cfg.mesh.client_fusion='fused'`` replaces the per-client local loops
with one step for all k clients a local step: one forward and backward
of the client-fused module (``models/__init__.py``
``define_fused_model``: one grouped convolution per layer over the
clients' packed channels), the per-client hooks under
``torch.func.vmap`` (``parallel/federated.py``
``_fused_client_round``). It is another lowering of the same
per-client math, so it is gated to the configurations where that holds
in full:

* the (arch, dataset, norm) triple has a fused module (the resnet-cifar
  family and the ``cnn``, ``norm='bn'``);
* the algorithm runs the base local step (``FedAlgorithm.local_step``
  not overridden): its hooks then run per client under vmap, while the
  model's forward and backward are fused. APFL, DRFA, PerFedAvg and
  PerFedMe override it with their own model applies;
* no per-step validation batch, no full-data loss phase, no recurrent
  carry, no adversarial-noise param, no MoE aux loss, no regression
  criterion: features the fused forward does not thread.

The multi-device rule and commit x fused are composition facts, which
``round_program.illegal_reason`` owns. :func:`resolve_client_fusion`
applies the config policy: 'vmap' and 'fused' are pins ('fused' raises
where it is unsupported), and 'auto' resolves to 'vmap', as in the JAX
package.
"""
from __future__ import annotations

from typing import Optional, Tuple

from fedtorch_tpu_torch.algorithms.base import FedAlgorithm
from fedtorch_tpu_torch.config import ExperimentConfig
from fedtorch_tpu_torch.models import define_fused_model
from fedtorch_tpu_torch.models.common import ModelDef


def fusion_supported(cfg: ExperimentConfig, model: ModelDef,
                     algorithm: FedAlgorithm, mesh_devices: int,
                     k_online: int) -> Tuple[Optional[object], str]:
    """(fused module on the model's device, "") when the round can run
    client-fused, else (None, the JAX package's reason)."""
    if type(algorithm).local_step is not FedAlgorithm.local_step:
        return None, (f"algorithm {algorithm.name!r} overrides "
                      "local_step (personalized/custom local loops run "
                      "their own model applies)")
    if algorithm.needs_full_loss:
        return None, (f"algorithm {algorithm.name!r} needs the "
                      "full-data loss phase")
    if algorithm.needs_val_batch:
        return None, (f"algorithm {algorithm.name!r} consumes per-step "
                      "validation batches")
    if model.is_recurrent:
        return None, "recurrent models thread a hidden carry"
    if model.has_noise_param:
        return None, "robust_* archs carry an adversarial noise param"
    if model.has_aux_loss:
        return None, "MoE aux-loss models are not fused"
    if model.is_regression:
        return None, "regression criteria are not fused"
    del mesh_devices  # the multi-device refusal is illegal_reason's
    fused = define_fused_model(cfg, k_online,
                               device=model.sample_input.device)
    if fused is None:
        return None, (f"no fused module for arch="
                      f"{cfg.model.arch!r} / dataset="
                      f"{cfg.data.dataset!r} / norm={cfg.model.norm!r} "
                      "(supported: resnet-cifar family + cnn with "
                      "norm='bn')")
    return fused, ""


def resolve_client_fusion(cfg: ExperimentConfig, model: ModelDef,
                          algorithm: FedAlgorithm, mesh_devices: int,
                          k_online: int) -> Tuple[str, Optional[object]]:
    """``cfg.mesh.client_fusion`` -> ('vmap' | 'fused', module): 'fused'
    raises where it is unsupported, 'auto' resolves to 'vmap'."""
    mode = cfg.mesh.client_fusion
    if mode == "vmap" or mode == "auto":
        return "vmap", None
    fused, why = fusion_supported(cfg, model, algorithm, mesh_devices,
                                  k_online)
    if fused is None:
        raise ValueError(
            f"mesh.client_fusion='fused' is unsupported here: {why}")
    return "fused", fused
