"""Local-SGD mode (``parallel/local_sgd.py``), port vs the JAX package, on
the CPU.

An MLP (2 layers of 32, batch statistics) on 60-feature synthetic rows,
4 workers over an IID partition of 96 rows, float32. Both packages start
from the same weights (bridged). Every round's plan (all workers, in the
order ``participation_indices`` draws them, and each one's K*B rows for
the round's K and B) is replayed from the key chain the JAX
``round_fn`` folds and injected into the port. Server params are held
within 1e-5 of their largest |value| (``test_torch_zoo.py``'s bar) after
each round, every ``fit`` round from the JAX package's state; the
schedule of (K, B) rounds exactly; the reshuffled partition bitwise.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import torch_threads  # noqa: F401 (two torch threads a worker)
from fedtorch_tpu import config as jcfg
from fedtorch_tpu.data.batching import (
    growing_batch_schedule as j_growing, round_row_plan as j_round_row_plan,
)
from fedtorch_tpu.models import define_model as jdefine
from fedtorch_tpu.parallel.federated import participation_indices
from fedtorch_tpu.parallel.local_sgd import (
    LocalSGDTrainer as JLocalSGD, build_local_sgd as j_build,
)
from fedtorch_tpu_torch import config as tcfg
from fedtorch_tpu_torch.bridge import params_from_jax, params_to_jax
from fedtorch_tpu_torch.data.batching import growing_batch_schedule
from fedtorch_tpu_torch.models import define_model as tdefine
from fedtorch_tpu_torch.parallel import RoundPlan
from fedtorch_tpu_torch.parallel.federated import FederatedTrainer
from fedtorch_tpu_torch.parallel.local_sgd import (
    LocalSGDAggregation, LocalSGDTrainer, build_local_sgd,
)

from test_torch_zoo import _flat

W, ROWS, B = 4, 96, 8
REL = 1e-5


def _config(mod, train=None, data=None, fed=None):
    return mod.ExperimentConfig(
        data=mod.DataConfig(dataset="synthetic", batch_size=B,
                            **(data or {})),
        federated=mod.FederatedConfig(federated=False, num_clients=W,
                                      sync_type="local_step",
                                      **(fed or {})),
        model=mod.ModelConfig(arch="mlp", mlp_hidden_size=32),
        optim=mod.OptimConfig(lr=0.1, in_momentum=True),
        train=mod.TrainConfig(**{"local_step": 2, "num_epochs": 2,
                                 **(train or {})})).finalize()


def _rows():
    rng = np.random.RandomState(0)
    return (rng.randn(ROWS, 60).astype(np.float32),
            rng.randint(0, 10, ROWS))


def jax_plan(key, r, sizes, n_max, k, num_rows):
    """Round ``r``'s cohort and rows of a JAX round program whose server
    key is ``key``, for clients of ``sizes`` and ``num_rows`` = K*B."""
    rng_sample, rng_train = jax.random.split(jax.random.fold_in(key, r))
    idx = participation_indices(rng_sample, len(sizes), k, jnp.int32(r))
    rngs = jax.random.split(rng_train, k)
    rows = jax.vmap(lambda rc, s: j_round_row_plan(rc, s, n_max, num_rows))(
        rngs, jnp.take(jnp.asarray(sizes, jnp.int32), idx))
    return RoundPlan(torch.from_numpy(np.array(idx)).long(),
                     torch.from_numpy(np.array(rows)).long())


def replay_jax_plans(monkeypatch, js):
    """The port's trainer draws each round's plan from ``js``'s key
    chain, at the trainer's own sizes, K and B of that round."""
    key = jax.random.wrap_key_data(jax.random.key_data(js.rng))
    monkeypatch.setattr(
        FederatedTrainer, "draw_plan", lambda self, server: jax_plan(
            key, server.round, self.sizes, self.data.n_max,
            self.k_online, self.local_steps * self.batch_size))


def bridge_jax_weights(monkeypatch, js):
    """The port's ``init_state`` starts from ``js``'s weights."""
    flat = _flat(js.params)
    init_state = FederatedTrainer.init_state

    def bridged(self, rng):
        server, clients = init_state(self, rng)
        params = params_from_jax(flat, expect=server.params,
                                 module=self.model.module)
        for n, p in clients.params.items():
            p[:] = params[n]
        return server._replace(params=params), clients
    monkeypatch.setattr(FederatedTrainer, "init_state", bridged)


def _build(**kw):
    jc, tc = _config(jcfg, **kw), _config(tcfg, **kw)
    feats, labels = _rows()
    jtr = j_build(jc, jdefine(jc, batch_size=B), feats, labels)
    ttr = build_local_sgd(tc, tdefine(tc, batch_size=B, device="cpu"),
                          feats, labels, device="cpu")
    return jtr, ttr


def _assert_params_close(want, tparams, module):
    """``want``: the JAX params as ``_flat`` gives them."""
    got = params_to_jax(tparams, module)
    scale = max(float(np.abs(v).max()) for v in want.values())
    for k, v in want.items():
        assert np.abs(got[k] - v).max() <= REL * scale, k


@pytest.mark.parametrize("avg_model", [True, False])
def test_one_round_with_an_injected_plan_matches(avg_model):
    """K = 3, B = 8: every worker online, weights 1/n (or 1 without
    ``avg_model``), the round's step count and batch restored after."""
    jtr, ttr = _build(train=dict(avg_model=avg_model))
    assert ttr.k_online == W and ttr.cfg.federated.online_client_rate == 1.0
    js, jcl = jtr.init_state(jax.random.key(0))
    ts, tcl = ttr.init_state(0)
    params = params_from_jax(_flat(js.params), expect=ts.params,
                             module=ttr.model.module)
    ts = ts._replace(params=params)
    for n, p in tcl.params.items():
        p[:] = params[n]
    key = jax.random.wrap_key_data(jax.random.key_data(js.rng))
    plan = jax_plan(key, 0, ttr.sizes, ttr.data.n_max, W, 3 * B)
    js, jcl, jm = jtr._round_with_steps(3, B)(js, jcl, jtr.data,
                                              jtr.val_data)
    ts, tcl, tm = ttr._round_with_steps(3, B)(ts, tcl, plan)
    assert (ttr.local_steps, ttr.batch_size) == (jtr.local_steps,
                                                 jtr.batch_size)
    _assert_params_close(_flat(js.params), ts.params, ttr.model.module)
    np.testing.assert_allclose(tm.train_loss.numpy(),
                               np.asarray(jm.train_loss)[:W], rtol=1e-4)
    assert tcl.local_index.tolist() == [3] * W
    w = ttr.algorithm.client_weights((), plan.idx, W, None)
    assert w.tolist() == [1.0 / W if avg_model else 1.0] * W
    assert isinstance(ttr.algorithm, LocalSGDAggregation)


SCHEDULES = {
    # the sync scheme's linear warm-up: K = 1, 2, then 4 a round
    "warmup": dict(train=dict(local_step=4, num_epochs=3,
                              local_step_warmup_type="linear",
                              local_step_warmup_period=2)),
    # growing minibatches in power-of-two buckets (4, 8, 16 here), to
    # an iteration count
    "growing_batch": dict(
        train=dict(local_step=10, stop_criteria="iteration",
                   num_iterations=150),
        data=dict(growing_batch_size=True, base_batch_size=2,
                  max_batch_size=32)),
    # a new IID partition at each epoch
    "reshuffle": dict(train=dict(local_step=4, num_epochs=3),
                      data=dict(reshuffle_per_epoch=True)),
}


def _resync(server, clients, jflat, jbuf, module):
    """The port's server params, client params and momentum buffers set
    in place to the JAX package's after the same round."""
    with torch.no_grad():
        params = params_from_jax(jflat, expect=server.params, module=module)
        for n, p in server.params.items():
            p.copy_(params[n])
            clients.params[n][:] = params[n]
        for c in range(clients.epoch.shape[0]):
            row = params_from_jax({k: v[c] for k, v in jbuf.items()},
                                  module=module)
            for n, b in clients.opt.in_buf.items():
                b[c] = row[n]


@pytest.mark.parametrize("case", sorted(SCHEDULES))
def test_fit_runs_the_jax_schedule_round_for_round(case, monkeypatch):
    """``fit`` from the same weights and plans: the same (K, B) a round
    and the same number of rounds; each round's server params within
    ``REL`` of the JAX package's, every round starting from the JAX
    package's state (as ``test_torch_round.py``'s int8 test does): over
    tens of rounds a ReLU kink that one summation order crosses and the
    other does not parts the trajectories by ~1e-3 at once."""
    kw = SCHEDULES[case]
    jtr, ttr = _build(**kw)
    module = ttr.model.module
    js0, _ = jtr.init_state(jax.random.key(5))
    bridge_jax_weights(monkeypatch, js0)
    replay_jax_plans(monkeypatch, js0)
    seen = {}
    for name, tr in (("jax", jtr), ("port", ttr)):
        steps, real = [], tr._round_with_steps

        def record(K, B=None, _real=real, _steps=steps):
            _steps.append((K, B))
            return _real(K, B)
        tr._round_with_steps = record
        seen[name] = steps
    # (the JAX package's rounds donate their inputs: copy now)
    jstates = []
    _, _, jhist = jtr.fit(jax.random.key(5), callback=lambda s, c, m:
                          jstates.append((_flat(s.params),
                                          _flat(c.opt.in_buf))))
    rounds = iter(jstates)

    def check_and_resync(server, clients, metrics):
        jflat, jbuf = next(rounds)
        _assert_params_close(jflat, server.params, module)
        _resync(server, clients, jflat, jbuf, module)
    _, _, thist = ttr.fit(5, callback=check_and_resync)
    assert seen["port"] == seen["jax"] and len(thist) == len(jhist)
    # the schedule moved (a reshuffle keeps K and B)
    assert (len(set(seen["port"])) > 1) == (case != "reshuffle")
    if case == "reshuffle":
        np.testing.assert_array_equal(ttr.data.x.numpy(),
                                      np.asarray(jtr.data.x)[:W])


@pytest.mark.parametrize("seed", [1, 7])
def test_reshuffled_partition_is_bitwise(seed):
    jtr, ttr = _build(data=dict(reshuffle_per_epoch=True))
    jtr._reshuffle(seed)
    ttr._reshuffle(seed)
    for field in ("x", "y", "sizes"):
        np.testing.assert_array_equal(getattr(ttr.data, field).numpy(),
                                      np.asarray(getattr(jtr.data,
                                                         field))[:W])
    assert ttr.sizes == [int(s) for s in np.asarray(jtr.data.sizes)[:W]]


@pytest.mark.parametrize("kw", [
    dict(base_batch_size=2, max_batch_size=32, num_samples_per_epoch=24,
         num_epochs=3),
    dict(base_batch_size=1, max_batch_size=0, num_samples_per_epoch=50,
         num_epochs=2),
    dict(base_batch_size=4, max_batch_size=16, num_iterations=200),
])
def test_growing_batch_schedule_is_the_jax_package_s(kw):
    assert growing_batch_schedule(**kw) == j_growing(**kw)


def test_bucketed_batches_follow_the_jax_package():
    kw = SCHEDULES["growing_batch"]
    jtr, ttr = _build(**kw)
    assert isinstance(jtr, JLocalSGD) and isinstance(ttr, LocalSGDTrainer)
    got = [ttr._bucketed_batch(i) for i in range(400)]
    assert got == [jtr._bucketed_batch(i) for i in range(400)]
    # buckets of 4 to 16; past the 150-step schedule its largest size
    assert got[0] == 4 and 8 in got and max(got) == 16 == got[-1]
