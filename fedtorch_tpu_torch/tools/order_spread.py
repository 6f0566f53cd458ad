"""How far float32 summation order alone moves one quantized round.

    python -m fedtorch_tpu_torch.tools.order_spread [--arch resnet8]
        [--seeds 0-31] [--card]

A pre-activation within float32 rounding of 0 lands on either side of
its ReLU in two summation orders, and that one element moves the
gradient of earlier layers by a few percent. In a small quantized
WideResNet-16-4 round (4 clients, 2 online, batch 8, 2 local steps) this
moves whole leaves of the update by several int8 downlink steps between
any two valid float32 orders, so a card-vs-CPU check of the round cannot
hold a fixed bar of a few steps. ``chip_smoke.py`` instead measures the
spread of the CPU against itself in ``SPREAD_ORDERS`` in the same run and
holds the card to ``SPREAD_FACTOR`` times it.

At ResNet-8 the round has few ReLU inputs, so its gap is set by
whether one or two of them flip: a held-out order lands up to 10x the
spread of ``SPREAD_ORDERS`` and no spread measured in a run bounds the
next order. ``chip_smoke.py`` holds the ResNet-8 round instead to
``SPREAD_FACTOR`` times ``RESNET8_MAX_GAP``, the largest gap this
program measured between any two CPU orders over many seeds.

This program measures, on the CPU, what those bars must be. For each
seed it runs the round of ``--arch`` in the reference order (NHWC
memory, torch's default thread count) and in ``SPREAD_ORDERS`` +
``HELD_OUT_ORDERS`` (and on the card with ``--card``), and prints one
JSON line per seed with each order's gap to the reference (the worst
leaf's max |diff| in int8 downlink steps of the reference update, and
the update's relative L2). Last it prints the largest ratio, over
seeds, of a held-out order's gap to the larger gap of
``SPREAD_ORDERS`` (the card is one more order, so its gap should stay
within that ratio of the measured spread), and the largest gap of any
CPU order (and of the card).

The helpers (:func:`small_round_cfg`, :func:`run_round`,
:func:`update_gap`) are the ones ``chip_smoke.py``'s reference phase
uses.
"""
from __future__ import annotations

import argparse
import dataclasses
import json

import numpy as np
import torch

from fedtorch_tpu_torch import config as tcfg
from fedtorch_tpu_torch.algorithms import make_algorithm
from fedtorch_tpu_torch.data.batching import stack_partitions
from fedtorch_tpu_torch.models import define_model
from fedtorch_tpu_torch.parallel import FederatedTrainer

# orders whose spread chip_smoke.py measures in its own run
SPREAD_ORDERS = ("cpu-nchw", "cpu-1thread")
# further orders, held out to measure how far past that spread one more
# order can land
HELD_OUT_ORDERS = ("cpu-2thread", "cpu-3thread", "cpu-nchw-1thread")
# chip_smoke.py's bar: the card within this factor of the measured spread.
# Over seeds 0-31 on an 8-core CPU this program measured the 96 held-out
# gaps at a median of 0.88x the spread in steps (0.79x in relative L2)
# and at most 1.56x (1.55x); the factor sits above every one of them.
SPREAD_FACTOR = 2.0
# the largest (steps, relative L2) gap to the reference of any order in
# SPREAD_ORDERS + HELD_OUT_ORDERS over seeds 0-63 of the ResNet-8 round
# (``--arch resnet8 --seeds 0-63`` on an 8-core CPU)
RESNET8_MAX_GAP = (24.07326656326615, 0.015189800411462784)
SAMPLES_PER_CLIENT = 16
WIDEN = 4  # chip_smoke.py's WideResNet-16-4 round


def small_round_cfg(arch: str, **model):
    """The small quantized round of the card-vs-CPU checks."""
    return tcfg.ExperimentConfig(
        data=tcfg.DataConfig(dataset="cifar10", batch_size=8),
        federated=tcfg.FederatedConfig(
            federated=True, num_clients=4, online_client_rate=0.5,
            sync_type="local_step", quantized=True),
        model=tcfg.ModelConfig(arch=arch, **model),
        optim=tcfg.OptimConfig(lr=0.1, in_momentum=True),
        train=tcfg.TrainConfig(local_step=2)).finalize()


def round_cfg(arch: str):
    """The round of the card-vs-CPU check of ``arch``."""
    if arch == "resnet8":
        return small_round_cfg("resnet8")
    return small_round_cfg("wideresnet16", wideresnet_widen_factor=WIDEN)


def _nchw_inside(module, args):
    """Forward pre-hook: the same NHWC batch with NCHW memory, so every
    layer sums in another (equally valid) float32 order."""
    return (args[0].permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1),)


def run_round(cfg, seed: int, run: str, wrap_algorithm=None, data=None,
              val_data=None, with_metrics: bool = False):
    """One quantized round from the weights and plan of ``seed``, in
    ``run``: ``"cuda"``, ``"cpu"``, or ``"cpu-"`` followed by ``nchw``
    (NCHW memory inside the model), ``<n>thread`` (``n`` CPU threads)
    and/or ``float32`` (the round in float32 whatever the config's compute
    dtype). ``wrap_algorithm`` may wrap the algorithm's methods before
    the round. ``data`` (and ``val_data``): the clients' ``ClientData``,
    by default ``SAMPLES_PER_CLIENT`` CIFAR-10-shaped rows a client from
    ``seed``. Returns (update, initial params), both on the CPU, and with
    ``with_metrics`` the round's ``RoundMetrics`` on the CPU too."""
    if data is None:
        C = cfg.federated.num_clients
        n = SAMPLES_PER_CLIENT
        rng = np.random.RandomState(seed)
        data = stack_partitions(
            rng.randn(n * C, 32, 32, 3).astype(np.float32),
            rng.randint(0, 10, n * C),
            [np.arange(n * i, n * i + n) for i in range(C)])
    dev, *opts = run.split("-")
    if "float32" in opts:
        cfg = dataclasses.replace(cfg, mesh=dataclasses.replace(
            cfg.mesh, compute_dtype="float32"))
    threads = torch.get_num_threads()
    try:
        for opt in opts:
            if opt.endswith("thread"):
                torch.set_num_threads(int(opt[:-len("thread")]))
        model = define_model(cfg, cfg.data.batch_size, device=dev)
        if "nchw" in opts:
            model.module.register_forward_pre_hook(_nchw_inside)
        alg = make_algorithm(cfg)
        if wrap_algorithm is not None:
            wrap_algorithm(alg)
        tr = FederatedTrainer(cfg, model, alg, data, val_data=val_data,
                              device=dev)
        server, clients = tr.init_state(seed + 1)
        p0 = {k: v.cpu() for k, v in server.params.items()}
        server, _, m = tr.round_fn(server, clients, tr.draw_plan(server))
        update = {k: v.cpu() - p0[k] for k, v in server.params.items()}
        if with_metrics:
            return update, p0, type(m)(*(None if f is None else f.cpu()
                                         for f in m))
        return update, p0
    finally:
        torch.set_num_threads(threads)


def update_gap(a: dict, b: dict):
    """(worst leaf's max |a - b| in int8 downlink steps of a, relative
    L2 of the whole update)."""
    worst = 0.0
    for k, u in a.items():
        step = float(u.max() - u.min()) / 255.0
        worst = max(worst, float((b[k] - u).abs().max()) / max(step, 1e-12))
    ua = torch.cat([u.flatten() for u in a.values()])
    ub = torch.cat([b[k].flatten() for k in a])
    return worst, float((ub - ua).norm() / ua.norm())


def spread(ref: dict, updates: dict):
    """The larger gap, in steps and in relative L2, of ``SPREAD_ORDERS``'
    updates to ``ref``."""
    gaps = [update_gap(ref, updates[o]) for o in SPREAD_ORDERS]
    return max(g[0] for g in gaps), max(g[1] for g in gaps)


def _seeds(text: str):
    lo, _, hi = text.partition("-")
    return range(int(lo), int(hi or lo) + 1)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", default="0-31",
                    help="inclusive range, e.g. 0-31")
    ap.add_argument("--arch", default="wideresnet16",
                    choices=("wideresnet16", "resnet8"))
    ap.add_argument("--card", action="store_true",
                    help="also run the round on the card")
    args = ap.parse_args(argv)
    if args.card:  # float32 on the card as on the CPU, as chip_smoke.py
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    cfg = round_cfg(args.arch)
    cpu_orders = SPREAD_ORDERS + HELD_OUT_ORDERS
    ratio_steps = ratio_l2 = 0.0
    worst = {"cpu": [0.0, 0.0], "cuda": [0.0, 0.0]}
    for seed in _seeds(args.seeds):
        ref, _ = run_round(cfg, seed, "cpu")
        ups = {o: run_round(cfg, seed, o)[0]
               for o in cpu_orders + (("cuda",) if args.card else ())}
        gaps = {o: update_gap(ref, u) for o, u in ups.items()}
        s_steps, s_l2 = spread(ref, ups)
        held = [gaps[o] for o in HELD_OUT_ORDERS]
        ratio_steps = max(ratio_steps,
                          max(h[0] for h in held) / max(s_steps, 1e-12))
        ratio_l2 = max(ratio_l2, max(h[1] for h in held) / max(s_l2, 1e-12))
        for o, g in gaps.items():
            w = worst["cuda" if o == "cuda" else "cpu"]
            w[:] = max(w[0], g[0]), max(w[1], g[1])
        print(json.dumps(dict(seed=seed, threads=torch.get_num_threads(),
                              gaps=gaps)), flush=True)
    print(json.dumps(dict(arch=args.arch, widen=WIDEN, seeds=args.seeds,
                          max_held_out_ratio_steps=ratio_steps,
                          max_held_out_ratio_l2=ratio_l2,
                          max_cpu_gap=worst["cpu"],
                          max_card_gap=worst["cuda"] if args.card else None,
                          spread_factor=SPREAD_FACTOR)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
