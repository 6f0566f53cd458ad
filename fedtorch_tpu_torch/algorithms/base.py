"""Federated algorithm interface (port of
``fedtorch_tpu/algorithms/base.py``).

An algorithm is one object with hooks the engine
(``parallel/federated.py``) calls: per client inside the local loop
(``local_step``, ``transform_grads``), per client after it
(``client_payload``), on the stacked ``[k]`` payloads
(``payload_batch_transform``), once on their sum
(``aggregate_transform``), for the server step (``server_update``),
after it per client (``client_post``) and once more on the new server
state (``post_round_global``). Around the local loop: ``setup`` at
construction, ``participation`` before the default draw, ``pre_round``
on the gathered online aux (with each online client's first batch),
the full-data loss probe (``needs_full_loss``) on the incoming server
model, and a validation batch a step (``needs_val_batch``).

Where the JAX package hands a hook a PRNG key, the port hands it the
round's :class:`~fedtorch_tpu_torch.parallel.federated.RoundPlan`: every
random draw of a round is made up front, from the server's
``torch.Generator`` (:meth:`FedAlgorithm.plan_draws`) or injected, so
the tests can feed both packages the same draws. A model with dropout
gets its step's dropout key from the plan as ``local_step``'s ``rng``
(``models/common.py`` ``drop_source``); a hook's own forward derives
another with ``fold_key``, as the JAX package folds its key.
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
    # the engine computes each online client's full-data loss on the
    # incoming server model when set (qFFL)
    needs_full_loss = False
    # the engine hands each local step a batch of the client's validation
    # rows when set (PerFedAvg's outer step)
    needs_val_batch = False
    # True when the stream plane's host schedule can draw this
    # algorithm's cohort ahead of the round: ``participation`` reads no
    # server state (DRFA's lambda-distributed draw does, and the feed
    # source refuses it; ``parallel/round_program.py``)
    participation_replayable = True
    # True when ``post_round_global`` has a stream-plane twin,
    # ``post_round_global_feed``, over probe batches packed into the feed
    # (DRFA's dual update); an override of ``post_round_global`` without
    # one is refused on the feed source
    needs_post_probe = False

    def __init__(self, cfg: ExperimentConfig):
        self.cfg = cfg
        self.model = None
        self.criterion = None
        # set by the engine: the round's scan length and online count
        self.local_steps_per_round = max(cfg.train.local_step, 1)
        self.k_online = max(
            int(cfg.federated.online_client_rate
                * cfg.federated.num_clients), 1)

    def setup(self, data) -> None:
        """One-time hook with the ClientData (sample-size weighting)."""

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

    # -- round plan and participation -----------------------------------
    def participation(self, generator: torch.Generator, num_clients: int,
                      k: int, round_idx: int, server_aux):
        """A [k] index tensor of online clients, or None for the engine's
        uniform draw."""
        return None

    def plan_draws(self, generator: torch.Generator, sizes) -> dict:
        """The algorithm's own random draws of a round, as
        :class:`RoundPlan` fields (DRFA's snapshot step and probe);
        ``sizes`` are the clients' sample counts."""
        return {}

    def pre_round(self, on_aux, *, server, x, y, sizes, lr, plan):
        """Once per round on the online clients' stacked [k] aux, before
        the local loops (APFL's adaptive alpha). ``x``/``y``: each online
        client's first B storage rows ([k, B, ...]); ``lr``: [k]
        scheduled LR at each one's epoch."""
        return on_aux

    # -- local loop hooks ----------------------------------------------
    def forward_reset(self, params, bx, train: bool = False, rng=None):
        """The forward of every auxiliary probe (personal models, the
        outer MAML step, DRFA's kth-model loss): a recurrent model starts
        from a fresh zero carry here; only the engine's main local loop
        threads a carry across steps. ``train``/``rng``: a training
        forward's dropout (``ModelDef.apply``)."""
        return self.model.forward(params, bx, train=train, rng=rng)

    def transform_grads(self, grads, *, params, server_params, client_aux,
                        server_aux, lr):
        """Gradient correction before the optimizer step."""
        return grads

    def local_step(self, *, params, opt, client_aux, rnn_carry,
                   server_params, server_aux, bx, by, bval_x, bval_y, lr,
                   step_idx, local_index, step_budget, rng=None):
        """One local step: a training forward, backward, gradient
        correction, gradient ascent on a robust model's input noise,
        dual-mode optimizer step. Returns (params, opt, client_aux,
        rnn_carry, loss, acc) with loss/acc as 0-d tensors (no host
        sync). ``rnn_carry`` is a recurrent model's hidden state entering
        the step (None for a feed-forward model); the returned one is the
        forward's, detached: the gradient is taken with respect to the
        params only. ``step_idx``
        counts from 0; ``step_budget`` is the steps the client takes this
        round (its epoch-sync budget, else the round's K): the engine
        skips the steps past it, so step-indexed logic anchors on it.
        ``local_index`` is the client's running step count (a 0-d int32
        tensor on the device); ``bval_x``/``bval_y`` the step's
        validation batch when ``needs_val_batch``, else None; ``rng``
        the step's dropout key (None without dropout). An MoE model's
        load-balance loss enters the loss at ``cfg.model.moe_aux_weight``
        when that is positive, as in the JAX package (only this base step
        adds it)."""
        leaves = {k: v.detach().requires_grad_(True)
                  for k, v in params.items()}
        moe_w = self.cfg.model.moe_aux_weight
        aux_reg = None
        if self.model.is_recurrent:
            logits, rnn_carry = self.model.apply(leaves, bx, rnn_carry)
            rnn_carry = rnn_carry.detach()
        elif self.model.has_aux_loss and moe_w > 0:
            logits, aux = self.model.apply_with_aux(leaves, bx, train=True,
                                                    rng=rng)
            aux_reg = moe_w * aux
        else:
            logits = self.model.apply(leaves, bx, train=True, rng=rng)
        loss = self.criterion(logits, by)
        if aux_reg is not None:
            loss = loss + aux_reg
        grads = dict(zip(leaves, torch.autograd.grad(
            loss, list(leaves.values()))))
        with torch.no_grad():
            grads = self.transform_grads(
                grads, params=params, server_params=server_params,
                client_aux=client_aux, server_aux=server_aux, lr=lr)
            if self.model.has_noise_param:
                # robust archs: gradient ASCENT on the adversarial input
                # noise (federated/main.py:131-141)
                grads = dict(grads, noise=-grads["noise"])
            params, opt = optim.local_step(params, grads, opt, lr,
                                           self.cfg.optim)
            acc = accuracy(logits, by) if not self.model.is_regression \
                else logits.new_zeros((), dtype=torch.float32)
        return params, opt, client_aux, rnn_carry, loss.detach(), acc

    # -- aggregation -----------------------------------------------------
    def client_weights(self, server_aux, online_idx, num_online_eff,
                       sizes) -> torch.Tensor:
        """Aggregation weights [k]: uniform 1/num_online_eff."""
        k = online_idx.shape[0]
        return torch.full((k,), 1.0) / num_online_eff

    def client_payload(self, *, delta, client_aux, params, server_params,
                       server_aux, lr, local_steps, weight,
                       full_loss=None) -> Tuple[Any, Any]:
        """Per-client (already-weighted) payload, plus updated aux.
        delta = server - client; ``full_loss`` is given when
        ``needs_full_loss`` is set."""
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

    def client_post(self, *, delta, client_aux, payload_sum, lr,
                    local_steps, server_params, params, weight) -> Any:
        """Per-client aux update that needs the transformed aggregate
        (FedGATE's tracking variate, error-feedback memory): ``delta``
        is the client's round delta, ``params`` its round-end params,
        ``lr`` its round-end LR, ``local_steps`` its step budget."""
        return client_aux

    def post_round_global(self, server, data, plan):
        """A second phase after the server step with access to every
        client's data (DRFA's dual update); returns the ServerState."""
        return server

    def post_round_global_feed(self, server, probe):
        """The stream plane's ``post_round_global``: the same math over
        the probe batches packed into the round's feed (``probe``, a
        ``RoundFeed`` with ``probe_idx``/``probe_x``/``probe_y``) in
        place of the whole population; bitwise the resident phase for
        the same plan. Returns the ServerState."""
        return server

    # -- payload accounting ----------------------------------------------
    def payload_scale(self) -> float:
        """Fraction of dense float32 bytes the wire format costs."""
        fed = self.cfg.federated
        if fed.quantized:
            return fed.quantized_bits / 32.0
        if fed.compressed:
            return fed.compressed_ratio
        return 1.0
