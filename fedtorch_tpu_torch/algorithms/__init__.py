"""Algorithm registry (port of ``fedtorch_tpu/algorithms/__init__.py``):
every non-personalized algorithm of the JAX package, and DRFA over
``DRFA_INNER``. The personalized ones (APFL, PerFedMe, PerFedAvg) are
refused by name: they need a per-client validation split and
``evaluate_personal``, which the port does not have yet."""
from __future__ import annotations

from fedtorch_tpu_torch.algorithms.afl import AFL
from fedtorch_tpu_torch.algorithms.base import FedAlgorithm
from fedtorch_tpu_torch.algorithms.drfa import DRFA
from fedtorch_tpu_torch.algorithms.fedavg import FedAdam, FedAvg, FedProx
from fedtorch_tpu_torch.algorithms.fedgate import FedGate
from fedtorch_tpu_torch.algorithms.qffl import QFFL
from fedtorch_tpu_torch.algorithms.qsparse import Qsparse
from fedtorch_tpu_torch.algorithms.scaffold import Scaffold
from fedtorch_tpu_torch.config import PERSONALIZED_ALGORITHMS

_REGISTRY = {cls.name: cls for cls in (FedAvg, FedProx, FedAdam, Scaffold,
                                       FedGate, Qsparse, QFFL, AFL)}

# inner aggregations DRFA can wrap
DRFA_INNER = ("fedavg", "fedgate", "scaffold")


def make_algorithm(cfg) -> FedAlgorithm:
    name = cfg.federated.algorithm
    if name in PERSONALIZED_ALGORITHMS:
        raise ValueError(f"algorithm {name!r} is not yet ported: the "
                         "personalized algorithms are the next slice "
                         "(ROADMAP A4)")
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
