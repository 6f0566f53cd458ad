"""qFFL / q-FedAvg (arXiv:1905.10497), fairness-weighted aggregation
(port of ``fedtorch_tpu/algorithms/qffl.py``).

* each client's full-data loss F_k on the incoming server model (the
  engine's probe, ``needs_full_loss``) scales its delta:
  ``Delta_k = delta_k * F_k^q / lr``;
* ``h = sum_k [q * F_k^(q-1) * ||Delta_k||^2 + F_k^q / lr]`` rides the
  payload as a scalar summed over the clients;
* the server applies ``(sum_k Delta_k) / (h + 1e-10)``.

The JAX package's ``jnp.float_power`` computes in float32 with x64 off
(its default), so the powers here are float32 ``torch.pow``
(``torch.float_power`` would compute in float64).
"""
from __future__ import annotations

import torch

from fedtorch_tpu_torch.algorithms.base import FedAlgorithm
from fedtorch_tpu_torch.core import optim
from fedtorch_tpu_torch.core.state import tree_map


class QFFL(FedAlgorithm):
    name = "qffl"
    needs_full_loss = True

    def client_payload(self, *, delta, client_aux, params, server_params,
                       server_aux, lr, local_steps, weight, full_loss=None):
        q = self.cfg.federated.qffl_q
        base = full_loss.to(torch.float32) + 1e-10
        fq = torch.pow(base, q)
        scaled = tree_map(lambda d: d * fq / lr, delta)
        sq_norms = sum(torch.sum(torch.square(x)) for x in scaled.values())
        h = q * torch.pow(base, q - 1.0) * sq_norms + fq / lr
        return {"delta": scaled, "h": h}, client_aux

    def server_update(self, server_params, server_opt, server_aux,
                      payload_sum, *, online_idx, num_online_eff,
                      client_losses=None):
        d = tree_map(lambda x: x / (payload_sum["h"] + 1e-10),
                     payload_sum["delta"])
        new_params, new_opt = optim.server_step(
            server_params, d, server_opt, self.cfg.optim.lr_scale_at_sync,
            self.cfg.optim)
        return new_params, new_opt, server_aux
