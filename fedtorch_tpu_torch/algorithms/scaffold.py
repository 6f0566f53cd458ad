"""SCAFFOLD (arXiv:1910.06378), control-variate variance reduction
(port of ``fedtorch_tpu/algorithms/scaffold.py``).

* local step: ``g <- g + c - c_i`` (server minus client control);
* at sync: ``c_i+ = c_i - c + (x_s - x_i)/(K*lr)`` with K the client's
  step budget and lr its round-end LR;
* payload: ``{"delta": w * (x_s - x_i), "control_delta": (c_i+ - c_i)/N}``
  with N the TOTAL client count, not the online count;
* server: ``x_s -= scale * sum(delta)``; ``c += sum(control_delta)``.

Momentum caveat (the JAX package's, measured there): the control update
equals the mean local gradient only under plain SGD; with in-momentum
the controls over-estimate and training diverges. Run SCAFFOLD with
plain local SGD.
"""
from __future__ import annotations

from fedtorch_tpu_torch.algorithms.base import FedAlgorithm
from fedtorch_tpu_torch.core import optim
from fedtorch_tpu_torch.core.state import tree_map, tree_scale, \
    tree_zeros_like


class Scaffold(FedAlgorithm):
    name = "scaffold"

    def init_client_aux(self, params):
        return {"control": tree_zeros_like(params)}

    def init_server_aux(self, params, num_clients: int):
        return {"control": tree_zeros_like(params)}

    def transform_grads(self, grads, *, params, server_params, client_aux,
                        server_aux, lr):
        return tree_map(lambda g, c, ci: g + c - ci, grads,
                        server_aux["control"], client_aux["control"])

    def client_payload(self, *, delta, client_aux, params, server_params,
                       server_aux, lr, local_steps, weight, full_loss=None):
        c_i = client_aux["control"]
        c_new = tree_map(lambda ci, c, d: ci - c + d / (local_steps * lr),
                         c_i, server_aux["control"], delta)
        control_delta = tree_map(lambda cn, ci: cn - ci, c_new, c_i)
        n_total = self.cfg.federated.num_clients
        payload = {"delta": tree_scale(delta, weight),
                   "control_delta": tree_scale(control_delta,
                                               1.0 / n_total)}
        return payload, {"control": c_new}

    def server_update(self, server_params, server_opt, server_aux,
                      payload_sum, *, online_idx, num_online_eff,
                      client_losses=None):
        new_params, new_opt = optim.server_step(
            server_params, payload_sum["delta"], server_opt,
            self.cfg.optim.lr_scale_at_sync, self.cfg.optim)
        new_control = tree_map(lambda c, d: c + d, server_aux["control"],
                               payload_sum["control_delta"])
        return new_params, new_opt, {"control": new_control}

    def payload_scale(self) -> float:
        return 2.0  # the model delta and the control delta per param
