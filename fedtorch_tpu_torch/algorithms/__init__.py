"""Algorithm registry (port of ``fedtorch_tpu/algorithms/__init__.py``,
the --federated_type dispatch of main.py:29-42): every algorithm of the
JAX package, and DRFA over ``DRFA_INNER``."""
from __future__ import annotations

from fedtorch_tpu_torch.algorithms.afl import AFL
from fedtorch_tpu_torch.algorithms.apfl import APFL
from fedtorch_tpu_torch.algorithms.base import FedAlgorithm
from fedtorch_tpu_torch.algorithms.drfa import DRFA
from fedtorch_tpu_torch.algorithms.fedavg import FedAdam, FedAvg, FedProx
from fedtorch_tpu_torch.algorithms.fedgate import FedGate
from fedtorch_tpu_torch.algorithms.perfedavg import PerFedAvg
from fedtorch_tpu_torch.algorithms.perfedme import PerFedMe
from fedtorch_tpu_torch.algorithms.qffl import QFFL
from fedtorch_tpu_torch.algorithms.qsparse import Qsparse
from fedtorch_tpu_torch.algorithms.scaffold import Scaffold

_REGISTRY = {cls.name: cls for cls in (FedAvg, FedProx, FedAdam, Scaffold,
                                       FedGate, Qsparse, QFFL, APFL,
                                       PerFedMe, PerFedAvg, AFL)}

# inner aggregations DRFA can wrap
DRFA_INNER = ("fedavg", "fedgate", "scaffold")


def make_algorithm(cfg) -> FedAlgorithm:
    name = cfg.federated.algorithm
    if name not in _REGISTRY:
        raise ValueError(
            f"Algorithm {name!r} is not implemented yet; available: "
            f"{sorted(_REGISTRY)} (+ drfa wrapper)")
    if cfg.federated.drfa:
        if name not in DRFA_INNER:
            raise ValueError(
                f"DRFA wraps one of {DRFA_INNER}, got {name!r} "
                "(ref: drfa.py:178-193)")
        return DRFA(cfg, inner=_REGISTRY[name](cfg))
    return _REGISTRY[name](cfg)
