"""PerFedMe / pFedMe, Moreau-envelope personalization (arXiv:2006.08848)
(port of ``fedtorch_tpu/algorithms/perfedme.py``).

* Every local step moves the personal model theta along the prox
  gradient ``grad f(theta) + lambda (theta - w)`` (perfedme.py:99-101).
* Every 5th step of the client's running count, and at the client's own
  last step of the round (its epoch-sync budget, not the round's K:
  perfedme.py:115-124 fires where the reference's local loop exits), the
  local copy of the global model w steps along ``lambda (w - theta)``
  through the main optimizer.
* Aggregation is FedAvg's on w; theta and its optimizer state stay with
  the client. The loss and accuracy reported are the personal model's
  (perfedme.py:93).

The prox step multiplies by ``lr * lambda``: with the reference default
lambda 15 the personal model oscillates unless ``lr < 1/lambda`` (lr
0.05 trains, 0.1 gives lr lambda 1.5), as in the reference.
"""
from __future__ import annotations

import torch

from fedtorch_tpu_torch.algorithms.fedavg import FedAvg
from fedtorch_tpu_torch.core import optim
from fedtorch_tpu_torch.core.losses import accuracy
from fedtorch_tpu_torch.core.state import tree_map


class PerFedMe(FedAvg):
    name = "perfedme"

    def init_client_aux(self, params):
        # params carry the [C] axis here
        return {
            "personal": tree_map(torch.clone, params),
            "personal_opt": optim.init_client_opt_state(params,
                                                        self.cfg.optim),
        }

    def local_step(self, *, params, opt, client_aux, rnn_carry,
                   server_params, server_aux, bx, by, bval_x, bval_y, lr,
                   step_idx, local_index, step_budget, rng=None):
        lam = self.cfg.federated.perfedme_lambda
        ocfg = self.cfg.optim
        personal = client_aux["personal"]
        leaves = {k: v.detach().requires_grad_(True)
                  for k, v in personal.items()}
        logits = self.forward_reset(leaves, bx, train=True, rng=rng)
        loss = self.criterion(logits, by)
        g_p = torch.autograd.grad(loss, list(leaves.values()))
        with torch.no_grad():
            # the prox-to-global gradient (perfedme.py:99-101)
            g_p = {k: g + lam * (personal[k] - params[k])
                   for k, g in zip(leaves, g_p)}
            personal, p_opt = optim.local_step(
                personal, g_p, client_aux["personal_opt"], lr, ocfg)
            g_w = tree_map(lambda w, p: lam * (w - p), params, personal)
            new_params, new_opt = optim.local_step(params, g_w, opt, lr,
                                                   ocfg)
            if step_idx + 1 == step_budget:
                params, opt = new_params, new_opt
            else:
                # every 5th step of the running count (a device value)
                pull = (local_index + 1) % 5 == 0
                params, opt = tree_map(
                    lambda a, b: torch.where(pull, a, b),
                    (new_params, new_opt), (params, opt))
            acc = logits.new_zeros((), dtype=torch.float32) \
                if self.model.is_regression else accuracy(logits, by)
        return params, opt, dict(client_aux, personal=personal,
                                 personal_opt=p_opt), rnn_carry, \
            loss.detach(), acc
