"""Qsparse-Local-SGD, top-k sparsified deltas with error feedback (port
of ``fedtorch_tpu/algorithms/qsparse.py``).

* sample-size weights ``w_i = n_i / N_total`` (not 1/num_online);
* wire: top-k of ``w*(delta + memory)``; aggregate ``d = sum_i``;
* error feedback: ``memory_i += delta_i - d``;
* the server step on ``d``.
"""
from __future__ import annotations

import torch

from fedtorch_tpu_torch.algorithms.base import FedAlgorithm
from fedtorch_tpu_torch.core.state import tree_map, tree_zeros_like
from fedtorch_tpu_torch.ops.topk import topk_roundtrip


class Qsparse(FedAlgorithm):
    name = "qsparse"

    def setup(self, data) -> None:
        self._total_samples = float(sum(int(s) for s in data.sizes))

    def init_client_aux(self, params):
        return {"memory": tree_zeros_like(params)}

    def client_weights(self, server_aux, online_idx, num_online_eff,
                       sizes):
        return sizes.to(torch.float32) / self._total_samples

    def client_payload(self, *, delta, client_aux, params, server_params,
                       server_aux, lr, local_steps, weight, full_loss=None):
        ratio = self.cfg.federated.compressed_ratio
        payload = tree_map(
            lambda d, m: topk_roundtrip((d + m) * weight, ratio),
            delta, client_aux["memory"])
        return payload, client_aux

    def client_post(self, *, delta, client_aux, payload_sum, lr,
                    local_steps, server_params, params, weight):
        return {"memory": tree_map(lambda m, dr, d: m + dr - d,
                                   client_aux["memory"], delta,
                                   payload_sum)}
