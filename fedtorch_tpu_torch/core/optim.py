"""Dual-mode functional optimizers over dicts of tensors.

Port of ``fedtorch_tpu/core/optim.py`` (the reference's custom ``SGD``,
``optimizers/sgd.py:67-129``, and ``AdamW``, ``adam.py:48-104``):

* ``sgd_local_step`` — a normal local step: weight decay, *in*-momentum
  buffer, ``p -= lr * d``.
* ``sgd_server_step`` — the server step every aggregation rule uses: no
  weight decay, *out*-momentum buffer, ``p -= s * d``.

The functions are pure: they return new dicts and leave their inputs
alone, so one client's step never touches the stacked client state.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from fedtorch_tpu_torch.config import OptimConfig
from fedtorch_tpu_torch.core.state import tree_map, tree_zeros_like

# the port's norm layers are named like the JAX package's flax modules
# (BatchStatsNorm_N in the ResNets, ln1/ln2/ln_f in the transformer),
# their affine pair is weight/bias (flax: scale/bias)
NORM_PREFIX = ("BatchStatsNorm_", "ln")


class SGDState(NamedTuple):
    """Dual momentum buffers, same keys as the params."""
    in_buf: Any
    out_buf: Any


class AdamState(NamedTuple):
    exp_avg: Any
    exp_avg_sq: Any
    step: torch.Tensor  # scalar int32 (or [C] on the stacked client state)
    out_buf: Any        # server-step out-momentum buffer


def init_sgd(params) -> SGDState:
    return SGDState(in_buf=tree_zeros_like(params),
                    out_buf=tree_zeros_like(params))


def init_adam(params) -> AdamState:
    any_leaf = next(iter(params.values()))
    return AdamState(exp_avg=tree_zeros_like(params),
                     exp_avg_sq=tree_zeros_like(params),
                     step=torch.zeros((), dtype=torch.int32,
                                      device=any_leaf.device),
                     out_buf=tree_zeros_like(params))


def _wd_coef(cfg: OptimConfig):
    """Per-leaf weight-decay coefficient by parameter name.

    Every parameter is decayed uniformly by default, norm scale and
    biases included (the reference's sgd.py:96-101). With
    ``cfg.wd_skip_norm_bias`` norm scales (the JAX package's 'scale'
    leaves, the norms' ``weight`` here) and every bias get 0."""
    wd = cfg.weight_decay

    def coef(name: str) -> float:
        if cfg.wd_skip_norm_bias:
            module, _, leaf = name.rpartition(".")
            if leaf == "bias" or (
                    leaf == "weight"
                    and module.rpartition(".")[2].startswith(NORM_PREFIX)):
                return 0.0
        return wd

    return coef


def apply_weight_decay(grads, params, cfg: OptimConfig):
    """grads + wd * params, with the per-leaf coefficient rule above."""
    coef = _wd_coef(cfg)
    return {k: g + coef(k) * params[k] for k, g in grads.items()}


def _momentum_update(buf, d, factor, dampening, nesterov):
    """buf <- factor*buf + (1-dampening)*d ; returns (direction, new_buf).
    With a zero buffer this equals the reference's first-step special
    case (sgd.py:103-106)."""
    new_buf = tree_map(lambda b, g: factor * b + (1.0 - dampening) * g,
                       buf, d)
    if nesterov:
        direction = tree_map(lambda g, b: g + factor * b, d, new_buf)
    else:
        direction = new_buf
    return direction, new_buf


def sgd_local_step(params, grads, state: SGDState, lr, cfg: OptimConfig):
    """Local (client) step: sgd.py step(apply_lr=True). ``lr`` may be a
    0-d tensor (the scheduled LR at the client's epoch)."""
    if cfg.weight_decay:
        grads = apply_weight_decay(grads, params, cfg)
    in_buf = state.in_buf
    if cfg.in_momentum and cfg.in_momentum_factor:
        grads, in_buf = _momentum_update(
            in_buf, grads, cfg.in_momentum_factor, cfg.dampening,
            cfg.use_nesterov)
    new_params = tree_map(lambda p, d: p - lr * d, params, grads)
    return new_params, SGDState(in_buf=in_buf, out_buf=state.out_buf)


def sgd_server_step(params, direction, state: SGDState, scale,
                    cfg: OptimConfig):
    """Server step: sgd.py step(apply_lr=False, scale=s,
    apply_out_momentum=True). ``direction`` is the aggregated delta."""
    out_buf = state.out_buf
    if cfg.out_momentum and cfg.out_momentum_factor:
        direction, out_buf = _momentum_update(
            out_buf, direction, cfg.out_momentum_factor, cfg.dampening,
            cfg.use_nesterov)
    new_params = tree_map(lambda p, d: p - scale * d, params, direction)
    return new_params, SGDState(in_buf=state.in_buf, out_buf=out_buf)


def adam_local_step(params, grads, state: AdamState, lr, cfg: OptimConfig):
    """AdamW local step (adam.py:71-104, correct_wd switch)."""
    step = state.step + 1
    b1, b2 = cfg.adam_beta1, cfg.adam_beta2
    if cfg.weight_decay and not cfg.correct_wd:
        grads = apply_weight_decay(grads, params, cfg)
    exp_avg = tree_map(lambda m, g: b1 * m + (1 - b1) * g,
                       state.exp_avg, grads)
    exp_avg_sq = tree_map(lambda v, g: b2 * v + (1 - b2) * g * g,
                          state.exp_avg_sq, grads)
    stepf = step.to(torch.float32)
    bc1 = 1 - b1 ** stepf
    bc2 = 1 - b2 ** stepf
    step_size = lr * torch.sqrt(bc2) / bc1
    coef = _wd_coef(cfg)

    new_params = {}
    for k, p in params.items():
        new_p = p - step_size * exp_avg[k] / (torch.sqrt(exp_avg_sq[k])
                                              + cfg.adam_eps)
        if cfg.weight_decay and cfg.correct_wd:
            new_p = new_p - lr * coef(k) * p
        new_params[k] = new_p
    return new_params, AdamState(exp_avg=exp_avg, exp_avg_sq=exp_avg_sq,
                                 step=step, out_buf=state.out_buf)


def adam_server_step(params, direction, state: AdamState, scale,
                     cfg: OptimConfig):
    """Server-step escape hatch (adam.py:69-70): plain p -= scale*d."""
    out_buf = state.out_buf
    if cfg.out_momentum and cfg.out_momentum_factor:
        direction, out_buf = _momentum_update(
            out_buf, direction, cfg.out_momentum_factor, cfg.dampening,
            cfg.use_nesterov)
    new_params = tree_map(lambda p, d: p - scale * d, params, direction)
    return new_params, state._replace(out_buf=out_buf)


# -- Dispatch ---------------------------------------------------------------

def init_opt_state(params, cfg: OptimConfig):
    if cfg.optimizer == "sgd":
        return init_sgd(params)
    if cfg.optimizer in ("adam", "adamw"):
        return init_adam(params)
    raise ValueError(f"Unknown optimizer {cfg.optimizer!r}")


def init_client_opt_state(cparams, cfg: OptimConfig):
    """Optimizer state of stacked ``[C, ...]`` client params: Adam's step
    counter is ``[C]`` too (one per client)."""
    state = init_opt_state(cparams, cfg)
    if isinstance(state, AdamState):
        c = next(iter(cparams.values()))
        state = state._replace(step=torch.zeros(
            c.shape[0], dtype=torch.int32, device=c.device))
    return state


def local_step(params, grads, state, lr, cfg: OptimConfig):
    if isinstance(state, SGDState):
        return sgd_local_step(params, grads, state, lr, cfg)
    return adam_local_step(params, grads, state, lr, cfg)


def server_step(params, direction, state, scale, cfg: OptimConfig):
    if isinstance(state, SGDState):
        return sgd_server_step(params, direction, state, scale, cfg)
    return adam_server_step(params, direction, state, scale, cfg)
