"""AFL, Agnostic Federated Learning (arXiv:1902.00146) (port of
``fedtorch_tpu/algorithms/afl.py``).

* aggregation weights are the dual variable itself, ``w_i = lambda_i``
  (not normalized by the online count);
* each online client reports its mean local loss (AFL runs one local
  step a round: the config forces ``local_step=1``); the server ascends
  ``lambda += drfa_gamma * loss_vector`` over the online clients and
  projects with ``project_simplex_floor``;
* lambda lives in the server aux ``[C]``, uniform at the start.
"""
from __future__ import annotations

import torch

from fedtorch_tpu_torch.algorithms.base import FedAlgorithm
from fedtorch_tpu_torch.core import optim
from fedtorch_tpu_torch.ops.simplex import project_simplex_floor


def _device_of(params) -> torch.device:
    return next(iter(params.values())).device


class AFL(FedAlgorithm):
    name = "afl"

    def init_server_aux(self, params, num_clients: int):
        return {"lambda": torch.full((num_clients,), 1.0 / num_clients,
                                     device=_device_of(params))}

    def client_weights(self, server_aux, online_idx, num_online_eff,
                       sizes):
        lam = server_aux["lambda"]
        return lam[online_idx.to(lam.device)]

    def server_update(self, server_params, server_opt, server_aux,
                      payload_sum, *, online_idx, num_online_eff,
                      client_losses=None):
        new_params, new_opt = optim.server_step(
            server_params, payload_sum, server_opt,
            self.cfg.optim.lr_scale_at_sync, self.cfg.optim)
        lam = server_aux["lambda"]
        loss_vec = torch.zeros_like(lam)
        loss_vec[online_idx.to(lam.device)] = client_losses
        lam = project_simplex_floor(
            lam + self.cfg.federated.drfa_gamma * loss_vec, floor=1e-3)
        return new_params, new_opt, {"lambda": lam}
