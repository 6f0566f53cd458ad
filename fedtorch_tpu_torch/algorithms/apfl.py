"""APFL, Adaptive Personalized Federated Learning (arXiv:2003.13461)
(port of ``fedtorch_tpu/algorithms/apfl.py``).

* Each local step is two steps (apfl.py:95-116): the standard step of
  the local model, then a step of the personal model on the mixed output
  ``alpha * personal(x) + (1 - alpha) * local(x)`` with the updated local
  model, the gradient taken with respect to the personal params only.
* Adaptive alpha (``adaptive_alpha``; apfl.py:119-123 ->
  flow_utils.py:240-250), in ``pre_round`` on each online client's first
  batch at its scheduled LR: ``grad_alpha = sum_l <p_personal - p_local,
  alpha g_personal + (1 - alpha) g_local> + 0.02 alpha``, ``alpha <-
  clip(alpha - eta grad_alpha, 0, 1)``, then the mean over the online
  clients is written to each (the JAX package's reading of the
  reference's global average). The local model there is the incoming
  server model.
* Aggregation is FedAvg's on the local model (its wire format included);
  the personal model, its optimizer state and alpha stay with the
  client, and ``local_snapshot`` keeps the trained local model before the
  sync for ``evaluate_personal`` (the reference validates before it,
  apfl.py:138-144).
"""
from __future__ import annotations

import torch

from fedtorch_tpu_torch.algorithms.fedavg import FedAvg
from fedtorch_tpu_torch.core import optim
from fedtorch_tpu_torch.core.state import tree_map, tree_take
from fedtorch_tpu_torch.models.common import fold_key


def _grad_leaves(tree):
    return {k: v.detach().requires_grad_(True) for k, v in tree.items()}


class APFL(FedAvg):
    name = "apfl"

    def init_client_aux(self, params):
        # params carry the [C] axis here
        c = next(iter(params.values()))
        return {
            "personal": tree_map(torch.clone, params),
            "personal_opt": optim.init_client_opt_state(params,
                                                        self.cfg.optim),
            "alpha": torch.full((c.shape[0],),
                                self.cfg.federated.personal_alpha,
                                device=c.device),
            "local_snapshot": tree_map(torch.clone, params),
        }

    def _mixed_loss(self, personal, local, alpha, bx, by, rng=None):
        # with a dropout key both forwards drop with the same masks, as
        # the JAX package's two applies under one key do
        train = rng is not None
        out = alpha * self.forward_reset(personal, bx, train, rng) \
            + (1 - alpha) * self.forward_reset(local, bx, train, rng)
        return self.criterion(out, by)

    def pre_round(self, on_aux, *, server, x, y, sizes, lr, plan):
        if not self.cfg.federated.adaptive_alpha:
            return on_aux
        alphas = []
        for j in range(x.shape[0]):
            personal = _grad_leaves(tree_take(on_aux["personal"], j))
            local = _grad_leaves(server.params)
            alpha = on_aux["alpha"][j]
            grads = torch.autograd.grad(
                self._mixed_loss(personal, local, alpha, x[j], y[j]),
                list(personal.values()) + list(local.values()))
            n = len(personal)
            with torch.no_grad():
                grad_alpha = sum(
                    torch.vdot((pp - pl).flatten(),
                               (alpha * gp + (1 - alpha) * gl).flatten())
                    for pp, pl, gp, gl in zip(
                        personal.values(), local.values(), grads[:n],
                        grads[n:])) + 0.02 * alpha
                alphas.append(torch.clamp(alpha - lr[j] * grad_alpha,
                                          0.0, 1.0))
        mean = torch.stack(alphas).mean()
        return dict(on_aux, alpha=mean.expand_as(on_aux["alpha"]).clone())

    def local_step(self, *, params, opt, client_aux, rnn_carry,
                   server_params, server_aux, bx, by, bval_x, bval_y, lr,
                   step_idx, local_index, step_budget, rng=None):
        # 1) the standard step of the local model (apfl.py:95-103)
        params, opt, client_aux, rnn_carry, loss, acc = super().local_step(
            params=params, opt=opt, client_aux=client_aux,
            rnn_carry=rnn_carry, server_params=server_params,
            server_aux=server_aux, bx=bx, by=by, bval_x=bval_x,
            bval_y=bval_y, lr=lr, step_idx=step_idx,
            local_index=local_index, step_budget=step_budget, rng=rng)
        # 2) the personal step on the mixed output with the updated local
        #    model (apfl.py:105-116), under its own dropout key
        personal = _grad_leaves(client_aux["personal"])
        g_p = torch.autograd.grad(
            self._mixed_loss(personal, params, client_aux["alpha"], bx, by,
                             None if rng is None else fold_key(rng, 1)),
            list(personal.values()))
        with torch.no_grad():
            new_personal, p_opt = optim.local_step(
                client_aux["personal"], dict(zip(personal, g_p)),
                client_aux["personal_opt"], lr, self.cfg.optim)
        return params, opt, dict(client_aux, personal=new_personal,
                                 personal_opt=p_opt), rnn_carry, loss, acc

    def client_payload(self, *, delta, client_aux, params, server_params,
                       server_aux, lr, local_steps, weight, full_loss=None):
        payload, aux = super().client_payload(
            delta=delta, client_aux=client_aux, params=params,
            server_params=server_params, server_aux=server_aux, lr=lr,
            local_steps=local_steps, weight=weight, full_loss=full_loss)
        # the trained local model before the sync, for evaluate_personal
        return payload, dict(aux, local_snapshot=params)
