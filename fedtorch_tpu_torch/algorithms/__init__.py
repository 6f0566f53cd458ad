"""Algorithm registry (port of ``fedtorch_tpu/algorithms/__init__.py``):
FedAvg, FedProx and FedAdam are ported; every other algorithm is refused
by name."""
from __future__ import annotations

from fedtorch_tpu_torch.algorithms.base import FedAlgorithm
from fedtorch_tpu_torch.algorithms.fedavg import FedAdam, FedAvg, FedProx

_REGISTRY = {cls.name: cls for cls in (FedAvg, FedProx, FedAdam)}


def make_algorithm(cfg) -> FedAlgorithm:
    name = cfg.federated.algorithm
    if cfg.federated.drfa:
        raise ValueError("drfa is not yet ported")
    if name not in _REGISTRY:
        raise ValueError(f"algorithm {name!r} is not yet ported; ported: "
                         f"{sorted(_REGISTRY)}")
    return _REGISTRY[name](cfg)
