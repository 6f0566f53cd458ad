"""FedAvg, FedProx and FedAdam (port of
``fedtorch_tpu/algorithms/fedavg.py``).

* FedAvg — weighted model-delta sum and server step
  (comms/algorithms/federated/fedavg.py:11-99), with optional adaptive
  int8/int16 quantization of the uplink payloads and of the aggregated
  downlink (fedavg.py:40-64), both through the Hopper quantizer
  (``ops/cuda/quant_kernel.py``).
* FedProx — the proximal gradient mu*(x - x_server) added before the
  step (federated/main.py:123-129).
* FedAdam (arXiv:2003.00295) — per-layer adaptive server denominator
  v = beta*v + (1-beta)*||d||; d /= sqrt(v)+tau (fedavg.py:81-84).
"""
from __future__ import annotations

import torch

from fedtorch_tpu_torch.algorithms.base import FedAlgorithm
from fedtorch_tpu_torch.core import optim
from fedtorch_tpu_torch.core.state import tree_map, tree_scale
from fedtorch_tpu_torch.ops.cuda.quant_kernel import (
    fused_quantize_dequantize_tree,
)


class FedAvg(FedAlgorithm):
    name = "fedavg"

    def client_payload(self, *, delta, client_aux, params, server_params,
                       server_aux, lr, local_steps, weight, full_loss=None):
        # uplink quantization happens on the stacked client axis in
        # payload_batch_transform, not here
        return tree_scale(delta, weight), client_aux

    def payload_batch_transform(self, payloads):
        if self.cfg.federated.quantized:
            # per-client uplink quantization, bucketed by leaf size: one
            # kernel launch per distinct size
            payloads = fused_quantize_dequantize_tree(
                payloads, self.cfg.federated.quantized_bits,
                leading_batch=True)
        return payloads

    def aggregate_transform(self, payload_sum):
        if self.cfg.federated.quantized:
            # downlink re-quantization of the summed delta
            payload_sum = fused_quantize_dequantize_tree(
                payload_sum, self.cfg.federated.quantized_bits)
        return payload_sum


class FedProx(FedAvg):
    """FedProx = FedAvg + proximal gradient mu*(x - x_server)."""

    name = "fedprox"

    def transform_grads(self, grads, *, params, server_params, client_aux,
                        server_aux, lr):
        mu = self.cfg.federated.fedprox_mu
        return tree_map(lambda g, p, s: g + mu * (p - s),
                        grads, params, server_params)


class FedAdam(FedAvg):
    """Server-side adaptivity: the aggregated delta is normalized per
    layer by a running norm estimate before the server step."""

    name = "fedadam"

    def init_server_aux(self, params, num_clients: int):
        # one scalar v per parameter leaf
        return tree_map(lambda p: torch.zeros((), device=p.device), params)

    def server_update(self, server_params, server_opt, server_aux,
                      payload_sum, *, online_idx, num_online_eff,
                      client_losses=None):
        beta = self.cfg.federated.fedadam_beta
        tau = self.cfg.federated.fedadam_tau
        new_v = tree_map(
            lambda v, d: beta * v + (1 - beta)
            * torch.linalg.vector_norm(d.reshape(-1)),
            server_aux, payload_sum)
        payload_sum = tree_map(lambda d, v: d / (torch.sqrt(v) + tau),
                               payload_sum, new_v)
        new_params, new_opt = optim.server_step(
            server_params, payload_sum, server_opt,
            self.cfg.optim.lr_scale_at_sync, self.cfg.optim)
        return new_params, new_opt, new_v
