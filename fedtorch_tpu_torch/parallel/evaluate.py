"""Evaluation (port of ``fedtorch_tpu/parallel/evaluate.py``).

Batched inference on the model's device under ``torch.inference_mode``
with loss and top-k accuracy (the reference's ``do_validate``,
comms/utils/eval.py:41-150), per-class accuracy, and per-client
evaluation with the worst/best/variance summary (eval_centered.py:94-113).

What the port keeps exactly, and why:

* The models normalise with the **current batch's** statistics
  (``BatchStatsNorm``), so the rows that pad the last batch change every
  real row's logits in it. :func:`_pad_batches` pads as the JAX package
  does, cycling rows from the head of the set (``np.arange(pad) % n``),
  and masks them out of every sum.
* Sequence models (``[B, T, V]`` logits) count per token: the mask is
  repeated over T.
* Each batch's masked sums are taken on the device, stacked, and summed
  once, as the JAX package's scan returns per-batch sums.

``evaluate_clients`` loops over clients where the JAX package vmaps,
taking each client's row of any tree of ``[C, ...]`` tensors (APFL's
``(personal, local_snapshot, alpha)``); size-0 clients (mesh padding
there) stay out of the summary. ``evaluate_personal`` evaluates the
personalized algorithms' per-client models on their validation rows.
Every forward is ``model.forward``, the JAX package's ``forward_fn``: a
recurrent model gets a fresh zero carry per batch. A robust model
(``has_noise_param``) first takes :func:`robust_noise_ascent` over the
eval set in :func:`evaluate` and :func:`evaluate_per_class`, unless
``robust_ascent=False``. Not ported: ``lowered_eval_program``, which
lowers an XLA program for its cost analysis and has no torch meaning.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from fedtorch_tpu_torch.core.losses import (
    make_criterion, per_class_accuracy, per_sample_loss, topk_accuracy,
    topk_indices,
)
from fedtorch_tpu_torch.core.state import tree_take
from fedtorch_tpu_torch.models.common import ModelDef


class EvalResult(NamedTuple):
    loss: torch.Tensor
    top1: torch.Tensor
    top5: torch.Tensor


def _pad_batches(x: np.ndarray, y: np.ndarray, batch_size: int):
    n = x.shape[0]
    n_batches = max((n + batch_size - 1) // batch_size, 1)
    pad = n_batches * batch_size - n
    if pad:
        # cycle rows so padding works even when pad > n (tiny eval sets)
        idx = np.arange(pad) % n
        x = np.concatenate([x, x[idx]])
        y = np.concatenate([y, y[idx]])
    mask = np.concatenate([np.ones(n), np.zeros(pad)])
    return (x.reshape((n_batches, batch_size) + x.shape[1:]),
            # y may be [N] class labels or [N, T] sequence targets
            y.reshape((n_batches, batch_size) + y.shape[1:]),
            mask.reshape(n_batches, batch_size))


def _device_batches(model: ModelDef, x, y, batch_size: int):
    """The padded batches on the model's device: x as float32 (or the
    integer tokens of a sequence model), y as the labels' own type, the
    mask as float32."""
    bx, by, bm = _pad_batches(np.asarray(x), np.asarray(y), batch_size)
    dev = model.sample_input.device
    return (torch.from_numpy(bx).to(dev), torch.from_numpy(by).to(dev),
            torch.from_numpy(bm.astype(np.float32)).to(dev))


def _flat_tokens(logits, yb, mb):
    """``[B, T, V]`` logits and ``[B, T]`` targets to per-token rows, the
    mask repeated over T; feed-forward outputs pass through."""
    if logits.dim() == 3:
        return (logits.reshape(-1, logits.shape[-1]), yb.reshape(-1),
                mb.repeat_interleave(yb.shape[-1]))
    return logits, yb, mb


def _ascent_on_batches(model: ModelDef, params, bx, by, bm,
                       step_size: float = 0.01) -> dict:
    """The noise ascent over padded batches, batch by batch: the
    gradient of the batch's masked mean loss in ``noise`` alone, a step
    up it, the noise projected onto the unit ball."""
    noise = params["noise"].detach()
    for xb, yb, mb in zip(bx, by, bm):
        leaf = noise.clone().requires_grad_(True)
        per = per_sample_loss(model.forward(dict(params, noise=leaf), xb),
                              yb, model.is_regression)
        loss = (per * mb).sum() / torch.clamp(mb.sum(), min=1.0)
        (g,) = torch.autograd.grad(loss, [leaf])
        with torch.no_grad():
            noise = noise + step_size * g
            norm = torch.linalg.vector_norm(noise)
            noise = torch.where(norm > 1.0, noise / norm, noise)
    return dict(params, noise=noise)


def robust_noise_ascent(model: ModelDef, params, x: np.ndarray,
                        y: np.ndarray, batch_size: int = 256,
                        step_size: float = 0.01) -> dict:
    """The adversarial evaluation prelude of the robust archs
    (eval.py:59-68): one gradient-ascent pass over the eval set on the
    input noise, projected onto the unit ball after each step. Returns
    the params with that noise (``params`` itself for other models)."""
    if not model.has_noise_param:
        return params
    return _ascent_on_batches(
        model, params, *_device_batches(model, x, y, batch_size), step_size)


def evaluate(model: ModelDef, params, x: np.ndarray, y: np.ndarray,
             batch_size: int = 256,
             robust_ascent: bool = True) -> EvalResult:
    """Server-side test evaluation (eval.py:83-99): mean loss, top-1 and
    top-5 (top-k capped at the class count) over the real rows, as 0-d
    float32 tensors on the model's device; a robust model after the
    noise ascent on the same batches unless ``robust_ascent=False``."""
    bx, by, bm = _device_batches(model, x, y, batch_size)
    if model.has_noise_param and robust_ascent:
        params = _ascent_on_batches(model, params, bx, by, bm)
    sums = []
    with torch.inference_mode():
        for xb, yb, mb in zip(bx, by, bm):
            logits, yb_f, mb_f = _flat_tokens(model.forward(params, xb),
                                              yb, mb)
            if model.is_regression:
                per = torch.square(logits.reshape(-1) - yb_f)
                t1 = t5 = torch.zeros_like(per)
            else:
                logp = F.log_softmax(logits, dim=-1)
                per = -logp.gather(-1, yb_f.long()[:, None])[:, 0]
                pred = topk_indices(logits, min(5, logits.shape[-1]))
                correct = pred == yb_f[:, None].to(pred.dtype)
                t1 = correct[:, 0].to(torch.float32)
                t5 = correct.any(dim=1).to(torch.float32)
            sums.append(torch.stack([(per * mb_f).sum(), (t1 * mb_f).sum(),
                                     (t5 * mb_f).sum(), mb_f.sum()]))
        loss, t1, t5, w = torch.stack(sums).sum(dim=0)
        total = torch.clamp(w, min=1e-8)
        return EvalResult(loss / total, t1 / total, t5 / total)


def evaluate_clients(model: ModelDef, client_params, data,
                     batch_size: int = 64, max_batches: int = 8,
                     apply_fn=None):
    """Per-client evaluation on per-client shards (``ClientData`` on the
    model's device; ``client_params`` a tree of ``[C, ...]`` tensors,
    each client's row handed to ``apply_fn``):
    ``[C]`` loss and accuracy, and the worst/best/variance summary over
    the clients of size > 0 (eval_centered.py:94-113). Each client reads
    ``min(max_batches, n_max // batch_size)`` batches (at least one),
    its rows cycling over its true size. ``apply_fn(params, x)``
    overrides the forward."""
    criterion = make_criterion(model.is_regression)
    apply_fn = apply_fn or model.forward
    n_b = min(max_batches, max(data.n_max // batch_size, 1))
    sizes = [int(s) for s in data.sizes]
    dev = data.x.device
    losses, accs = [], []
    with torch.inference_mode():
        for c, size in enumerate(sizes):
            params = tree_take(client_params, c)
            step_loss, step_acc = [], []
            for i in range(n_b):
                idx = (i * batch_size + torch.arange(batch_size, device=dev)) \
                    % max(size, 1)
                xb, yb = data.x[c][idx], data.y[c][idx]
                logits = apply_fn(params, xb)
                step_loss.append(criterion(logits, yb))
                step_acc.append(logits.new_zeros((), dtype=torch.float32)
                                if model.is_regression
                                else topk_accuracy(logits, yb, (1,))[0])
            losses.append(torch.stack(step_loss).mean())
            accs.append(torch.stack(step_acc).mean())
        losses, accs = torch.stack(losses), torch.stack(accs)
        valid = torch.tensor(sizes, device=accs.device) > 0
        n = torch.clamp(valid.sum(), min=1).to(torch.float32)
        acc_mean = torch.where(valid, accs, 0.0).sum() / n
        summary = torch.stack([
            torch.where(valid, losses, 0.0).sum() / n, acc_mean,
            torch.where(valid, accs, torch.inf).min(),
            torch.where(valid, accs, -torch.inf).max(),
            torch.where(valid, torch.square(accs - acc_mean), 0.0).sum() / n,
        ]).tolist()
    keys = ("loss_mean", "acc_mean", "acc_worst", "acc_best", "acc_var")
    return losses, accs, dict(zip(keys, summary))


def evaluate_personal(model: ModelDef, client_aux, client_params, data,
                      algorithm_name: str, batch_size: int = 64,
                      max_batches: int = 8):
    """Per-client evaluation of the personalized models on ``data`` (the
    clients' validation rows), against the local model before the sync
    that the algorithms keep in their aux (the reference validates
    personal models before it, apfl.py:138-144):

    * apfl: ``alpha * f(personal) + (1 - alpha) * f(local_snapshot)``
      (inference_personal, eval.py:31-39);
    * perfedme: the personal model theta;
    * perfedavg: the adapted local model before the sync;
    * any other algorithm: ``client_params``.

    Returns what :func:`evaluate_clients` returns. Refused on several
    ranks, whose client state is sharded (``parallel/mesh.py``
    ``owned_client_rows``; ROADMAP A10)."""
    from fedtorch_tpu_torch.parallel.mesh import world_size
    if world_size() > 1:
        raise ValueError(
            f"evaluate_personal on {world_size()} ranks is not yet "
            "ported: it reads every client's personalized models, and "
            "each rank holds its own rows of the client state (run the "
            "personal evaluation in one process; ROADMAP A10)")
    apply_fn = None
    if algorithm_name == "apfl":
        eval_params = (client_aux["personal"],
                       client_aux["local_snapshot"], client_aux["alpha"])

        def apply_fn(ps, x):
            return ps[2] * model.forward(ps[0], x) \
                + (1 - ps[2]) * model.forward(ps[1], x)
    elif algorithm_name == "perfedme":
        eval_params = client_aux["personal"]
    elif algorithm_name == "perfedavg":
        eval_params = client_aux["local_snapshot"]
    else:
        eval_params = client_params
    return evaluate_clients(model, eval_params, data, batch_size=batch_size,
                            max_batches=max_batches, apply_fn=apply_fn)


def evaluate_per_class(model: ModelDef, params, x: np.ndarray,
                       y: np.ndarray, num_classes: int,
                       batch_size: int = 256, robust_ascent: bool = True):
    """Per-class accuracy (components/metrics.py:77-91; the
    ``--per_class_acc`` flag): ``[num_classes]`` accuracy and the
    per-class sample counts, float32 on the model's device; a robust
    model after the same noise ascent as :func:`evaluate`."""
    bx, by, bm = _device_batches(model, x, y, batch_size)
    if model.has_noise_param and robust_ascent:
        params = _ascent_on_batches(model, params, bx, by, bm)
    c_sum = torch.zeros(num_classes, device=bx.device)
    t_sum = torch.zeros(num_classes, device=bx.device)
    with torch.inference_mode():
        for xb, yb, mb in zip(bx, by, bm):
            logits, yb_f, mb_f = _flat_tokens(model.forward(params, xb),
                                              yb, mb)
            correct, total = per_class_accuracy(logits, yb_f, num_classes,
                                                mask=mb_f)
            c_sum += correct
            t_sum += total
        return c_sum / torch.clamp(t_sum, min=1.0), t_sum
