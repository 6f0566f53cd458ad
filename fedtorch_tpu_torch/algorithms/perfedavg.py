"""PerFedAvg, Personalized FedAvg by first-order MAML (arXiv:2002.07948)
(port of ``fedtorch_tpu/algorithms/perfedavg.py``).

After each standard local step (the MAML inner step at the scheduled
LR), one more SGD step on a batch of the client's validation rows at the
fixed outer rate ``perfedavg_beta`` (centered/main.py:156-170; the
reference's scheduler lr_external override), through the same dual-mode
optimizer. Aggregation is FedAvg's; the personalized model is the
adapted local model before the sync, kept as ``local_snapshot``.
"""
from __future__ import annotations

import torch

from fedtorch_tpu_torch.algorithms.fedavg import FedAvg
from fedtorch_tpu_torch.core import optim
from fedtorch_tpu_torch.core.state import tree_map
from fedtorch_tpu_torch.models.common import fold_key


class PerFedAvg(FedAvg):
    name = "perfedavg"
    needs_val_batch = True

    def init_client_aux(self, params):
        return {"local_snapshot": tree_map(torch.clone, params)}

    def client_payload(self, *, delta, client_aux, params, server_params,
                       server_aux, lr, local_steps, weight, full_loss=None):
        payload, aux = super().client_payload(
            delta=delta, client_aux=client_aux, params=params,
            server_params=server_params, server_aux=server_aux, lr=lr,
            local_steps=local_steps, weight=weight, full_loss=full_loss)
        return payload, dict(aux, local_snapshot=params)

    def local_step(self, *, params, opt, client_aux, rnn_carry,
                   server_params, server_aux, bx, by, bval_x, bval_y, lr,
                   step_idx, local_index, step_budget, rng=None):
        # the inner step (centered/main.py:127-141)
        params, opt, client_aux, rnn_carry, loss, acc = super().local_step(
            params=params, opt=opt, client_aux=client_aux,
            rnn_carry=rnn_carry, server_params=server_params,
            server_aux=server_aux, bx=bx, by=by, bval_x=bval_x,
            bval_y=bval_y, lr=lr, step_idx=step_idx,
            local_index=local_index, step_budget=step_budget, rng=rng)
        # the outer step at beta on the val batch (centered/main.py:156-170),
        # a training forward under its own dropout key
        leaves = {k: v.detach().requires_grad_(True)
                  for k, v in params.items()}
        rng_v = None if rng is None else fold_key(rng, 2)
        g = torch.autograd.grad(
            self.criterion(self.forward_reset(leaves, bval_x, train=True,
                                              rng=rng_v), bval_y),
            list(leaves.values()))
        with torch.no_grad():
            params, opt = optim.local_step(
                params, dict(zip(leaves, g)), opt,
                self.cfg.federated.perfedavg_beta, self.cfg.optim)
        return params, opt, client_aux, rnn_carry, loss, acc
