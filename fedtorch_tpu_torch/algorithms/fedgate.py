"""FedGATE / FedCOMGATE (arXiv:2007.01154), gradient tracking with an
optional top-k or quantized wire format (port of
``fedtorch_tpu/algorithms/fedgate.py``).

* local step: ``g <- g - delta_i`` (the tracking variate);
* wire formats: the dense weighted delta; ``compressed``: top-k of
  ``w*delta_i + w*memory_i`` with error-feedback memory
  ``memory_i += delta_i - d``; ``quantized`` (FedCOMGATE): the stacked
  ``[k, ...]`` uplink and the aggregated downlink through the Hopper
  quantizer (``ops/cuda/quant_kernel.py``'s ragged pair), as quantized
  FedAvg;
* after the server step, per client: ``delta_i += (delta_round_i - d) /
  (lr * K)`` with ``d`` the transformed (re-quantized) aggregate, the
  client's round-end LR and its step budget K.
"""
from __future__ import annotations

from fedtorch_tpu_torch.algorithms.base import FedAlgorithm
from fedtorch_tpu_torch.core.state import tree_map, tree_scale, \
    tree_zeros_like
from fedtorch_tpu_torch.ops.cuda.quant_kernel import (
    fused_quantize_dequantize_tree,
)
from fedtorch_tpu_torch.ops.topk import topk_roundtrip


class FedGate(FedAlgorithm):
    name = "fedgate"

    def init_client_aux(self, params):
        aux = {"delta": tree_zeros_like(params)}
        if self.cfg.federated.compressed:
            aux["memory"] = tree_zeros_like(params)
        return aux

    def transform_grads(self, grads, *, params, server_params, client_aux,
                        server_aux, lr):
        return tree_map(lambda g, d: g - d, grads, client_aux["delta"])

    def client_payload(self, *, delta, client_aux, params, server_params,
                       server_aux, lr, local_steps, weight, full_loss=None):
        fed = self.cfg.federated
        weighted = tree_scale(delta, weight)
        if fed.compressed:  # (the config refuses it with quantized)
            # g = w*delta + w*memory, top-k sparsified
            weighted = tree_map(
                lambda d, m: topk_roundtrip(d + m * weight,
                                            fed.compressed_ratio),
                weighted, client_aux["memory"])
        return weighted, client_aux

    def payload_batch_transform(self, payloads):
        if self.cfg.federated.quantized:
            # FedCOMGATE uplink: per-client stats on the stacked axis
            payloads = fused_quantize_dequantize_tree(
                payloads, self.cfg.federated.quantized_bits,
                leading_batch=True)
        return payloads

    def aggregate_transform(self, payload_sum):
        # the re-quantized aggregate feeds both the server step and the
        # clients' tracking and memory updates
        if self.cfg.federated.quantized:
            payload_sum = fused_quantize_dequantize_tree(
                payload_sum, self.cfg.federated.quantized_bits)
        return payload_sum

    def client_post(self, *, delta, client_aux, payload_sum, lr,
                    local_steps, server_params, params, weight):
        new_aux = dict(client_aux, delta=tree_map(
            lambda t, dr, d: t + (dr - d) / (lr * local_steps),
            client_aux["delta"], delta, payload_sum))
        if self.cfg.federated.compressed:
            new_aux["memory"] = tree_map(
                lambda m, dr, d: m + dr - d, client_aux["memory"], delta,
                payload_sum)
        return new_aux
