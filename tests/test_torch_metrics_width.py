"""The per-client round metrics' layout, port against the JAX package, on
the CPU: under ``participation_mode='perm'`` the round's ``train_loss``,
``train_acc`` and ``online_mask`` are ``[C]`` (offline rows zero), under
``'sparse'`` they are cohort-aligned ``[k]``, and ``run_rounds`` stacks
``[R, metrics_width]``; on both data planes.

An MLP (hidden 16) on 8 clients of 8 MNIST-shaped rows, k = 2, batch 4,
2 local steps, from the same (bridged) weights. The port takes the JAX
``RoundSchedule``'s cohorts and rows (its device plane through an
injected plan, its stream plane through ``plan_fn`` and, for
``run_rounds``, through its plan drawer) and is held on both planes to
the JAX device plane's metrics (the JAX stream plane runs the same plans
bitwise): two rounds through the per-round entry, then
``run_rounds(2)`` against the JAX rounds 3 and 4 stacked. Shapes must be equal, the mask
and ``comm_bytes`` exactly, losses and accuracies within rtol 1e-4 /
atol 1e-6.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401 (two torch threads a worker)
from fedtorch_tpu import config as jcfg
from fedtorch_tpu.algorithms import make_algorithm as jmake
from fedtorch_tpu.data import streaming as jst
from fedtorch_tpu.data.batching import stack_partitions as jstack
from fedtorch_tpu.models import define_model as jdefine
from fedtorch_tpu.parallel import FederatedTrainer as JTrainer
from fedtorch_tpu_torch import config as tcfg
from fedtorch_tpu_torch.algorithms import make_algorithm as tmake
from fedtorch_tpu_torch.bridge import params_from_jax
from fedtorch_tpu_torch.data import streaming as tst
from fedtorch_tpu_torch.data.batching import stack_partitions as tstack
from fedtorch_tpu_torch.models import define_model as tdefine
from fedtorch_tpu_torch.parallel import FederatedTrainer, RoundPlan
from test_torch_zoo import _flat

C, N, B, K = 8, 8, 4, 2
TIMEOUT_S = 20.0


def _cfg(mod, mode, plane):
    return mod.ExperimentConfig(
        data=mod.DataConfig(dataset="mnist", batch_size=B, augment=False,
                            data_plane=plane),
        federated=mod.FederatedConfig(
            federated=True, num_clients=C, online_client_rate=0.25,
            sync_type="local_step", participation_mode=mode),
        model=mod.ModelConfig(arch="mlp", mlp_hidden_size=16),
        optim=mod.OptimConfig(lr=0.1),
        train=mod.TrainConfig(local_step=K)).finalize()


@functools.lru_cache(maxsize=None)
def _jax_run(mode):
    """The JAX trainer's weights, the plans of its ``RoundSchedule``, and
    its metrics of four rounds through ``run_round`` (its stream plane
    runs the same plans, bitwise; its ``run_rounds`` scans the same
    round and stacks ``[R, metrics_width]``)."""
    jc = _cfg(jcfg, mode, "device")
    jtr = JTrainer(jc, jdefine(jc, batch_size=B), jmake(jc),
                   jstack(*_population()))
    js, jcl = jax.jit(jtr.init_state)(jax.random.key(0))
    weights = _flat(js.params)
    sched = jst.RoundSchedule(
        np.asarray(jax.random.key_data(js.rng)), jax.random.key_impl(js.rng),
        C, jtr.k_online, K * B, N, np.full(C, N), participation_mode=mode)
    plans = []
    for r in range(4):
        idx, rows = sched(r)
        plans.append(RoundPlan(torch.from_numpy(np.array(idx)).long(),
                               torch.from_numpy(np.array(rows)).long()))
    per_round = []
    for _ in range(4):
        js, jcl, jm = jtr.run_round(js, jcl)
        per_round.append(jm)
    stacked = type(jm)(*(None if a is None else jnp.stack([a, b])
                         for a, b in zip(*per_round[2:])))
    return jtr.metrics_width, weights, plans, per_round[:2], stacked


def _population():
    rng = np.random.RandomState(0)
    x = rng.randn(C * N, 28, 28, 1).astype(np.float32)
    y = rng.randint(0, 10, C * N)
    return x, y, [np.arange(i * N, (i + 1) * N) for i in range(C)]


def _assert_metrics_match(tm, jm):
    for name in ("train_loss", "train_acc", "online_mask"):
        got, want = getattr(tm, name).numpy(), np.asarray(getattr(jm, name))
        assert got.shape == want.shape, (name, got.shape, want.shape)
        if name == "online_mask":
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6,
                                       err_msg=name)
    np.testing.assert_array_equal(tm.comm_bytes.numpy(),
                                  np.asarray(jm.comm_bytes))


@pytest.mark.parametrize("plane", ["device", "stream"])
@pytest.mark.parametrize("mode", ["perm", "sparse"])
def test_round_metrics_have_the_jax_package_s_layout(mode, plane):
    j_width, weights, plans, j_rounds, j_scan = _jax_run(mode)
    tc = _cfg(tcfg, mode, plane)
    ttr = FederatedTrainer(tc, tdefine(tc, batch_size=B, device="cpu"),
                           tmake(tc), tstack(*_population()), device="cpu")
    ttr.stream_timeout_s = TIMEOUT_S
    ts, tcl = ttr.init_state(0)
    ts = ts._replace(params=params_from_jax(weights, expect=ts.params,
                                            module=ttr.model.module))
    for n, p in tcl.params.items():
        p[:] = ts.params[n]
    width = ttr.k_online if mode == "sparse" else C
    assert ttr.metrics_width == j_width == width
    producer = None
    if plane == "stream":
        producer = tst.StreamFeedProducer(
            ttr.host_store, batch_size=B, timeout_s=TIMEOUT_S,
            plan_fn=lambda step: (step, plans[step]))
    try:
        for r, jm in enumerate(j_rounds):
            if producer is None:
                ts, tcl, tm = ttr.round_fn(ts, tcl, plans[r])
            else:
                ts, tcl, tm = ttr.round_stream_fn(
                    ts, tcl, producer.next_feed().feed)
            assert tm.train_loss.shape == (width,)
            _assert_metrics_match(tm, jm)
            if mode == "perm":
                assert sorted(np.flatnonzero(tm.online_mask).tolist()) \
                    == sorted(plans[r].idx.tolist())
        # run_rounds: the port's own entry on the next two plans
        ttr.draw_plan = lambda server: plans[server.round]
        ttr.plan_drawer = lambda: (lambda gen, r, aux=None: plans[r])
        ts, tcl, tms = ttr.run_rounds(ts, tcl, 2)
        assert tms.train_loss.shape == (2, width)
        _assert_metrics_match(tms, j_scan)
        # every consumer sums the leaves: the same in either layout
        sc = ttr.round_host_scalars(tcl, type(tms)(*(
            None if f is None else f[-1] for f in tms)))
        assert sc["n_online"] == ttr.k_online
    finally:
        if producer is not None:
            producer.close()
        ttr.close()
