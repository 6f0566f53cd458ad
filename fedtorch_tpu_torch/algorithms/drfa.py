"""DRFA, Distributionally Robust Federated Averaging (NeurIPS 2020)
(port of ``fedtorch_tpu/algorithms/drfa.py``): a minimax wrapper around
an inner aggregation algorithm (fedavg, fedgate or scaffold).

* lambda [C] starts proportional to the client sample sizes;
* the dual step size gamma decays 0.9x every round;
* sampling is uniform in both phases (``drfa_lambda_sampling=True``
  draws the cohort from lambda instead, by Gumbel top-k);
* aggregation weights ``lambda_i * C / num_online_eff``, applied through
  the inner algorithm's payload;
* a shared random step ``k_rand`` in [1, K) a round: every client
  snapshots its model after ``min(k_rand, step_budget)`` local steps
  (the clamp keeps an epoch-sync client that stops early on a real
  model), and the snapshots are averaged with 1/k;
* second phase: a second uniform cohort probes the k-th average model
  on one random batch each; lambda ascends
  ``gamma * K * loss * (C / num_online_eff2)`` over them and is
  projected with ``project_simplex_floor``.

The round's draws (``k_rand``, the probe cohort and its rows) are
:class:`RoundPlan` fields, drawn by :meth:`plan_draws` from the server's
generator or injected. On the stream plane the host schedule draws the
same plan through the same :meth:`plan_draws`, so the port needs no
``host_probe_fn``: the producer packs the probe rows into the feed and
:meth:`post_round_global_feed` takes the dual update over them.
"""
from __future__ import annotations

import torch

from fedtorch_tpu_torch.algorithms.base import (
    FedAlgorithm, num_online_effective,
)
from fedtorch_tpu_torch.core.losses import per_sample_loss
from fedtorch_tpu_torch.core.state import tree_scale, tree_zeros_like
from fedtorch_tpu_torch.data.batching import sample_batch
from fedtorch_tpu_torch.ops.simplex import project_simplex_floor


class DRFA(FedAlgorithm):
    name = "drfa"
    needs_post_probe = True

    def __init__(self, cfg, inner: FedAlgorithm):
        super().__init__(cfg)
        self.inner = inner

    @property
    def participation_replayable(self):
        # the uniform draw comes from the generator alone; the
        # lambda-distributed draw reads the dual variable, which the
        # host schedule cannot see ahead of the round
        return not self.cfg.federated.drfa_lambda_sampling

    def setup(self, data):
        self.inner.setup(data)
        self._sizes = torch.as_tensor(data.sizes).to(torch.float32)

    def bind(self, model, criterion):
        super().bind(model, criterion)
        self.inner.bind(model, criterion)

    # -- state -------------------------------------------------------------
    def init_client_aux(self, params):
        # params carry the [C] axis here
        c = next(iter(params.values()))
        return {"inner": self.inner.init_client_aux(params),
                "kth": tree_zeros_like(params),
                "k_rand": torch.zeros(c.shape[0], dtype=torch.int32,
                                      device=c.device)}

    def init_server_aux(self, params, num_clients: int):
        dev = next(iter(params.values())).device
        sizes = self._sizes.to(dev)
        return {"inner": self.inner.init_server_aux(params, num_clients),
                "lambda": sizes / sizes.sum(),
                "gamma": torch.tensor(self.cfg.federated.drfa_gamma,
                                      dtype=torch.float32, device=dev),
                "kth_avg": tree_zeros_like(params)}

    # -- draws, sampling and weighting ------------------------------------
    def plan_draws(self, generator, sizes) -> dict:
        K = max(self.local_steps_per_round, 2)
        C, k = len(sizes), self.k_online
        B = self.cfg.data.batch_size
        k_rand = int(torch.randint(1, K, (), generator=generator))
        probe_idx = torch.randperm(C, generator=generator)[:k]
        probe_rows = torch.stack([
            sample_batch(generator, sizes[c], B)
            for c in probe_idx.tolist()])
        return dict(k_rand=k_rand, probe_idx=probe_idx,
                    probe_rows=probe_rows)

    def participation(self, generator, num_clients, k, round_idx,
                      server_aux):
        if not self.cfg.federated.drfa_lambda_sampling:
            return None
        # Gumbel top-k = sampling without replacement from lambda
        lam = server_aux["lambda"].detach().to("cpu").clamp_min(1e-12)
        u = torch.rand(num_clients, generator=generator)
        g = -torch.log(-torch.log(u.clamp_min(1e-20)))
        return torch.topk(torch.log(lam) + g, k).indices

    def client_weights(self, server_aux, online_idx, num_online_eff,
                       sizes):
        lam = server_aux["lambda"]
        n = self.cfg.federated.num_clients
        return lam[online_idx.to(lam.device)] * n / num_online_eff

    # -- local loop --------------------------------------------------------
    def pre_round(self, on_aux, *, server, x, y, sizes, lr, plan):
        inner_aux = self.inner.pre_round(
            on_aux["inner"], server=server._replace(aux=server.aux["inner"]),
            x=x, y=y, sizes=sizes, lr=lr, plan=plan)
        # the host copy the local steps read (no device sync a step)
        self._k_rand = int(plan.k_rand)
        k_rand = torch.full_like(on_aux["k_rand"], self._k_rand)
        return dict(on_aux, inner=inner_aux, k_rand=k_rand)

    def local_step(self, *, params, opt, client_aux, rnn_carry,
                   server_params, server_aux, bx, by, bval_x, bval_y, lr,
                   step_idx, local_index, step_budget, rng=None):
        params, opt, inner_aux, rnn_carry, loss, acc = \
            self.inner.local_step(
                params=params, opt=opt, client_aux=client_aux["inner"],
                rnn_carry=rnn_carry, server_params=server_params,
                server_aux=server_aux["inner"], bx=bx, by=by,
                bval_x=bval_x, bval_y=bval_y, lr=lr, step_idx=step_idx,
                local_index=local_index, step_budget=step_budget, rng=rng)
        # the snapshot after min(k_rand, budget) steps; k_rand is the
        # plan's, the same for every client of the round
        k_snap = min(self._k_rand, step_budget)
        kth = params if step_idx + 1 == k_snap else client_aux["kth"]
        return params, opt, dict(client_aux, inner=inner_aux, kth=kth), \
            rnn_carry, loss, acc

    # -- aggregation -------------------------------------------------------
    def client_payload(self, *, delta, client_aux, params, server_params,
                       server_aux, lr, local_steps, weight, full_loss=None):
        inner_payload, inner_aux = self.inner.client_payload(
            delta=delta, client_aux=client_aux["inner"], params=params,
            server_params=server_params, server_aux=server_aux["inner"],
            lr=lr, local_steps=local_steps, weight=weight,
            full_loss=full_loss)
        payload = {"inner": inner_payload,
                   "kth": tree_scale(client_aux["kth"], 1.0 / self.k_online)}
        return payload, dict(client_aux, inner=inner_aux)

    def payload_batch_transform(self, payloads):
        return dict(payloads, inner=self.inner.payload_batch_transform(
            payloads["inner"]))

    def aggregate_transform(self, payload_sum):
        return dict(payload_sum, inner=self.inner.aggregate_transform(
            payload_sum["inner"]))

    def server_update(self, server_params, server_opt, server_aux,
                      payload_sum, *, online_idx, num_online_eff,
                      client_losses=None):
        new_params, new_opt, inner_saux = self.inner.server_update(
            server_params, server_opt, server_aux["inner"],
            payload_sum["inner"], online_idx=online_idx,
            num_online_eff=num_online_eff, client_losses=client_losses)
        return new_params, new_opt, dict(server_aux, inner=inner_saux,
                                         kth_avg=payload_sum["kth"])

    def client_post(self, *, delta, client_aux, payload_sum, lr,
                    local_steps, server_params, params, weight):
        inner_aux = self.inner.client_post(
            delta=delta, client_aux=client_aux["inner"],
            payload_sum=payload_sum["inner"], lr=lr,
            local_steps=local_steps, server_params=server_params,
            params=params, weight=weight)
        return dict(client_aux, inner=inner_aux)

    # -- the dual update (second phase) ------------------------------------
    def post_round_global(self, server, data, plan):
        rows = plan.probe_rows.to(data.x.device)
        batches = [(data.x[c][rows[j]], data.y[c][rows[j]])
                   for j, c in enumerate(plan.probe_idx.tolist())]
        return self._probe_update(server, plan.probe_idx, batches)

    def post_round_global_feed(self, server, probe):
        batches = zip(probe.probe_x, probe.probe_y)
        return self._probe_update(server, probe.probe_idx.long(), batches)

    def _probe_update(self, server, idx2, batches):
        """The k-th average model's mean loss on each probe batch, then
        the dual update."""
        kth_avg = server.aux["kth_avg"]
        with torch.no_grad():
            losses = [per_sample_loss(self.forward_reset(kth_avg, bx), by,
                                      self.model.is_regression).mean()
                      for bx, by in batches]
            return self._dual_update(server, idx2, torch.stack(losses))

    def _dual_update(self, server, idx2, losses):
        C = self.cfg.federated.num_clients
        num_online2 = num_online_effective(idx2)
        lam = server.aux["lambda"]
        gamma = server.aux["gamma"] * 0.9
        loss_vec = torch.zeros_like(lam)
        loss_vec[idx2.to(lam.device)] = losses.to(lam.dtype) * C \
            / num_online2
        lam = lam + gamma * self.local_steps_per_round * loss_vec
        lam = project_simplex_floor(lam, floor=1e-3)
        return server._replace(
            aux=dict(server.aux, **{"lambda": lam, "gamma": gamma}))
