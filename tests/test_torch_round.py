"""Federated rounds, port vs the JAX package, on the CPU.

ResNet-8, 8 clients of 16 samples, online rate 0.25 (k = 2), batch 8, 2
local steps, no augmentation, float32. Both packages start from the
same weights (bridged). The cohort and rows of every round are derived
here with the JAX package's own ``participation_indices`` and
``round_row_plan`` from the key chain its ``round_fn`` folds
(``parallel/federated.py:514-538``) and injected into the port.

Tolerances: unquantized, every leaf within 1e-5 of its max |param|
after 1 and after 3 rounds (the convolutions sum in other orders); int8,
each round's server update within 1e-3 relative L2 and every element
within two downlink quantization steps (a last-bit difference in a
client's delta can move a value across a rounding boundary, on the
uplink and again on the downlink). Such a one-step flip is a real
difference of the next round's starting point, which the next local
steps amplify into more flips, so a quantized trajectory drifts apart
by whole steps over rounds; the int8 test therefore starts every round
from the JAX package's state, copied into the port, and holds each
round's update to the bar.
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import torch_threads  # noqa: F401 (two torch threads a worker)
from fedtorch_tpu import config as jcfg
from fedtorch_tpu.algorithms import make_algorithm as jmake
from fedtorch_tpu.data.batching import (
    round_row_plan as j_round_row_plan, stack_partitions as jstack,
)
from fedtorch_tpu.models import define_model as jdefine
from fedtorch_tpu.parallel import FederatedTrainer as JTrainer
from fedtorch_tpu.parallel.federated import participation_indices
from fedtorch_tpu_torch import config as tcfg
from fedtorch_tpu_torch.algorithms import make_algorithm as tmake
from fedtorch_tpu_torch.bridge import params_from_jax, params_to_jax
from fedtorch_tpu_torch.data.batching import stack_partitions as tstack
from fedtorch_tpu_torch.models import define_model as tdefine
from fedtorch_tpu_torch.parallel import FederatedTrainer, RoundPlan

C, N, B, K = 8, 16, 8, 2


def _build(algorithm="fedavg", quantized=False, sync_type="local_step",
           sizes=(N,) * C, model=None):
    sections = dict(
        data=("DataConfig", dict(dataset="cifar10", batch_size=B,
                                 augment=False)),
        federated=("FederatedConfig", dict(
            federated=True, num_clients=C, online_client_rate=0.25,
            algorithm=algorithm, sync_type=sync_type,
            quantized=quantized)),
        model=("ModelConfig", model or dict(arch="resnet8")),
        optim=("OptimConfig", dict(lr=0.1, in_momentum=True)),
        train=("TrainConfig", dict(local_step=K)))

    def cfg(mod):
        return mod.ExperimentConfig(**{
            name: getattr(mod, cls)(**kw)
            for name, (cls, kw) in sections.items()}).finalize()

    jc, tc = cfg(jcfg), cfg(tcfg)
    rng = np.random.RandomState(0)
    feats = rng.randn(sum(sizes), 32, 32, 3).astype(np.float32)
    labels = rng.randint(0, 10, sum(sizes))
    ends = np.cumsum(sizes)
    parts = [np.arange(e - s, e) for s, e in zip(sizes, ends)]

    jtr = JTrainer(jc, jdefine(jc, batch_size=B), jmake(jc),
                   jstack(feats, labels, parts))
    js, jcl = jtr.init_state(jax.random.key(0))
    ttr = FederatedTrainer(tc, tdefine(tc, batch_size=B, device="cpu"),
                           tmake(tc), tstack(feats, labels, parts),
                           device="cpu")
    ts, tcl = ttr.init_state(0)
    bridged = params_from_jax(_flat(js.params), expect=ts.params)
    ts = ts._replace(params=bridged)
    for n, p in tcl.params.items():
        p[:] = bridged[n]
    return jtr, js, jcl, ttr, ts, tcl


def _flat(params):
    return {"/".join(k.key for k in path): np.array(v) for path, v in
            jax.tree_util.tree_flatten_with_path(params)[0]}


def _plans(jtr, js, num_rounds):
    """The JAX round_fn's cohort and rows, replayed from its key chain
    (server.rng is threaded through every round unchanged)."""
    key = jax.random.wrap_key_data(jax.random.key_data(js.rng))
    k, n_max = jtr.k_online, jtr.data.x.shape[1]
    plans = []
    for r in range(num_rounds):
        rng_sample, rng_train = jax.random.split(
            jax.random.fold_in(key, r))
        idx = participation_indices(rng_sample, jtr.num_clients, k,
                                    jnp.int32(r))
        rngs = jax.random.split(rng_train, k)
        rows = jax.vmap(lambda rc, s: j_round_row_plan(
            rc, s, n_max, jtr.local_steps * jtr.batch_size))(
                rngs, jnp.take(jtr.data.sizes, idx))
        plans.append(RoundPlan(torch.from_numpy(np.array(idx)).long(),
                               torch.from_numpy(np.array(rows)).long()))
    return plans


def _copy_state(js, jcl, ts, tcl, module=None):
    """The JAX package's server and client state, into the port's
    (``module``: the port's model, for the bridge)."""
    params = params_from_jax(_flat(js.params), expect=ts.params,
                             module=module)
    n_clients = tcl.epoch.shape[0]
    for name, tree in (("params", jcl.params),
                       ("in_buf", jcl.opt.in_buf)):
        flat = _flat(tree)
        dst = tcl.params if name == "params" else tcl.opt.in_buf
        for c in range(n_clients):
            row = params_from_jax({k: v[c] for k, v in flat.items()},
                                  module=module)
            for n, v in row.items():
                dst[n][c] = v
    # the JAX package may pad its client axis to the device count
    tcl.epoch[:] = torch.from_numpy(np.array(jcl.epoch)[:n_clients])
    tcl.local_index[:] = torch.from_numpy(
        np.array(jcl.local_index)[:n_clients])
    return ts._replace(params=params)


def _run(jtr, js, jcl, ttr, ts, tcl, num_rounds, resync=False):
    """Per round: (jax params, port params, jax losses, port losses),
    params as flat numpy dicts; index 0 is the starting point. With
    ``resync`` each round after the first starts from the JAX state."""
    module = ttr.model.module
    out = [(_flat(js.params), params_to_jax(ts.params, module), None,
            None)]
    for r, plan in enumerate(_plans(jtr, js, num_rounds)):
        if resync and r:
            ts = _copy_state(js, jcl, ts, tcl, module)
            out[-1] = out[-1][:1] + (params_to_jax(ts.params, module),) \
                + out[-1][2:]
        js, jcl, jm = jtr.run_round(js, jcl)
        ts, tcl, tm = ttr.round_fn(ts, tcl, plan)
        np.testing.assert_array_equal(tm.online_mask.numpy(),
                                      np.asarray(jm.online_mask))
        out.append((_flat(js.params), params_to_jax(ts.params, module),
                    np.array(jm.train_loss), tm.train_loss.numpy()))
    return out


def _assert_params_close(got, want):
    for k, v in want.items():
        err = np.abs(got[k] - v).max()
        assert err <= 1e-5 * np.abs(v).max(), (k, err)


def test_fedavg_rounds_match():
    trace = _run(*_build(), num_rounds=3)
    for r in (1, 3):
        jp, tp, jl, tl = trace[r]
        _assert_params_close(tp, jp)
        np.testing.assert_allclose(tl, jl, rtol=1e-4, atol=1e-6)


def test_quantized_fedavg_rounds_match():
    trace = _run(*_build(quantized=True), num_rounds=3, resync=True)
    for r in (1, 2, 3):
        (jp0, tp0, _, _), (jp, tp, jl, tl) = trace[r - 1], trace[r]
        ju = np.concatenate([(jp[k] - jp0[k]).ravel() for k in jp])
        tu = np.concatenate([(tp[k] - tp0[k]).ravel() for k in jp])
        assert np.linalg.norm(tu - ju) <= 1e-3 * np.linalg.norm(ju)
        for k in jp:
            u = jp[k] - jp0[k]
            step = (u.max() - u.min()) / 255.0
            assert np.abs((tp[k] - tp0[k]) - u).max() <= 2 * step + 1e-7, k
        np.testing.assert_allclose(tl, jl, rtol=1e-3, atol=1e-5)


@pytest.mark.parametrize("algorithm, sync_type, sizes", [
    ("fedprox", "local_step", (N,) * C),
    ("fedadam", "local_step", (N,) * C),
    # epoch sync over unequal clients: K = 2 batches of the largest
    # client, a client of <= 8 samples stops after its one batch
    ("fedavg", "epoch", (16, 5, 9, 16, 8, 12, 3, 16)),
])
def test_one_round_of_each_algorithm_matches(algorithm, sync_type, sizes):
    trace = _run(*_build(algorithm, sync_type=sync_type, sizes=sizes),
                 num_rounds=1)
    jp, tp, jl, tl = trace[1]
    _assert_params_close(tp, jp)
    np.testing.assert_allclose(tl, jl, rtol=1e-4, atol=1e-6)


def test_drawn_plans_are_seeded_and_force_client0():
    """Without an injected plan the port draws from its own generator:
    the same seed gives the same run, round 0 has client 0 online."""
    runs = []
    for _ in range(2):
        _, _, _, ttr, _, _ = _build()
        ts, tcl = ttr.init_state(123)
        plan = ttr.draw_plan(ts)
        assert 0 in plan.idx.tolist() and plan.rows.shape == (2, K * B)
        ts, tcl, m = ttr.run_rounds(ts, tcl, 2)
        assert m.train_loss.shape == (2, C) and ts.round == 2
        runs.append(params_to_jax(ts.params))
    for k, v in runs[0].items():
        np.testing.assert_array_equal(runs[1][k], v)


def test_client_state_is_written_back():
    jtr, js, jcl, ttr, ts, tcl = _build()
    plan = _plans(jtr, js, 1)[0]
    ts, tcl, _ = ttr.round_fn(ts, tcl, plan)
    on = plan.idx.tolist()
    off = [c for c in range(C) if c not in on]
    # K steps of 1/nb epochs each, nb = 2 batches per epoch
    assert tcl.epoch[on].tolist() == [1.0] * len(on)
    assert tcl.local_index[on].tolist() == [K] * len(on)
    assert tcl.epoch[off].abs().sum() == 0
    for n, p in tcl.params.items():
        torch.testing.assert_close(p[on], ts.params[n].expand_as(p[on]))
    assert all(float(b[off].abs().sum()) == 0
               for b in tcl.opt.in_buf.values())
    assert any(float(b[on].abs().sum()) > 0
               for b in tcl.opt.in_buf.values())
    assert dataclasses.is_dataclass(ttr.cfg)
