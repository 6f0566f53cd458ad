"""Federated algorithm interface (port of
``fedtorch_tpu/algorithms/base.py``).

An algorithm is one object with hooks the engine
(``parallel/federated.py``) calls: per client inside the local loop
(``local_step``, ``transform_grads``), per client after it
(``client_payload``), on the stacked ``[k]`` payloads
(``payload_batch_transform``), once on their sum
(``aggregate_transform``) and for the server step (``server_update``).
The hooks the ported algorithms leave at identity in the JAX package
(participation, pre_round, client_post, post_round_global) are not part
of the port yet.
"""
from __future__ import annotations

from typing import Any, Tuple

import torch

from fedtorch_tpu_torch.config import ExperimentConfig
from fedtorch_tpu_torch.core import optim
from fedtorch_tpu_torch.core.losses import accuracy
from fedtorch_tpu_torch.core.state import tree_scale


def num_online_effective(online_idx: torch.Tensor) -> float:
    """The reference's weighting denominator (fedavg.py:18-27): |online|
    when client 0 is online, |online|+1 otherwise (the MPI server shares
    rank 0 with a client). ``online_idx`` is the host-side id vector."""
    k = online_idx.shape[0]
    return float(k + (0 if bool((online_idx == 0).any()) else 1))


class FedAlgorithm:
    """Base = FedAvg behavior; subclasses override hooks."""

    name = "fedavg"

    def __init__(self, cfg: ExperimentConfig):
        self.cfg = cfg
        self.model = None
        self.criterion = None

    def bind(self, model, criterion) -> None:
        """The engine hands over the model and criterion."""
        self.model = model
        self.criterion = criterion

    # -- state ---------------------------------------------------------
    def init_client_aux(self, params) -> Any:
        """Per-client aux. () = none."""
        return ()

    def init_server_aux(self, params, num_clients: int) -> Any:
        return ()

    # -- local loop hooks ----------------------------------------------
    def transform_grads(self, grads, *, params, server_params, client_aux,
                        server_aux, lr):
        """Gradient correction before the optimizer step."""
        return grads

    def local_step(self, *, params, opt, client_aux, server_params,
                   server_aux, bx, by, lr):
        """One local step: forward, backward, gradient correction,
        dual-mode optimizer step. Returns (params, opt, client_aux, loss,
        acc) with loss/acc as 0-d tensors (no host sync)."""
        leaves = {k: v.detach().requires_grad_(True)
                  for k, v in params.items()}
        logits = self.model.apply(leaves, bx)
        loss = self.criterion(logits, by)
        grads = dict(zip(leaves, torch.autograd.grad(
            loss, list(leaves.values()))))
        with torch.no_grad():
            grads = self.transform_grads(
                grads, params=params, server_params=server_params,
                client_aux=client_aux, server_aux=server_aux, lr=lr)
            params, opt = optim.local_step(params, grads, opt, lr,
                                           self.cfg.optim)
            acc = accuracy(logits, by)
        return params, opt, client_aux, loss.detach(), acc

    # -- aggregation -----------------------------------------------------
    def client_weights(self, server_aux, online_idx, num_online_eff,
                       sizes) -> torch.Tensor:
        """Aggregation weights [k]: uniform 1/num_online_eff."""
        k = online_idx.shape[0]
        return torch.full((k,), 1.0) / num_online_eff

    def client_payload(self, *, delta, client_aux, params, server_params,
                       server_aux, lr, local_steps,
                       weight) -> Tuple[Any, Any]:
        """Per-client (already-weighted) payload, plus updated aux.
        delta = server - client."""
        return tree_scale(delta, weight), client_aux

    def payload_batch_transform(self, payloads):
        """Uplink wire format on the STACKED [k, ...] payloads (per-client
        semantics). Identity by default."""
        return payloads

    def aggregate_transform(self, payload_sum):
        """Downlink wire format of the aggregated payload, applied once so
        the server step sees the transformed sum. Identity by default."""
        return payload_sum

    def server_update(self, server_params, server_opt, server_aux,
                      payload_sum, *, online_idx, num_online_eff,
                      client_losses=None):
        """The dual-mode server step p -= lr_scale_at_sync * d."""
        new_params, new_opt = optim.server_step(
            server_params, payload_sum, server_opt,
            self.cfg.optim.lr_scale_at_sync, self.cfg.optim)
        return new_params, new_opt, server_aux

    # -- payload accounting ----------------------------------------------
    def payload_scale(self) -> float:
        """Fraction of dense float32 bytes the wire format costs."""
        fed = self.cfg.federated
        if fed.quantized:
            return fed.quantized_bits / 32.0
        return 1.0
