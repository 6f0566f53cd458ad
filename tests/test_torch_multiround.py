"""Many unquantized rounds (FedAvg; SCAFFOLD and DRFA on the MLP), port
vs the JAX package, on the CPU,
with both packages' ``evaluate`` on the server model after every round.

Both packages build their data with their own ``build_federated_data``
from one config, start from the same weights (the JAX init, bridged)
and run the same cohort and rows every round: the plans are replayed
from the JAX package's key chain (``parallel/federated.py:514-538``) and
injected into the port. float32, no augmentation.

- MLP, 30 rounds: the synthetic(0, 0) tasks, 20 clients (about 32
  training and 8 test samples each), k = 5, batch 8, 2 local steps, SGD
  lr 0.05; 134 test samples. Largest gaps over the 30 rounds, measured
  (CPU): test loss 1.12e-7 relative, top-1 0 samples. Bars: loss within
  1e-5 relative, top-1 within 2 test samples.
- ResNet-8, 5 rounds: CIFAR-10 pickle files the test writes (random
  pixels and labels; 128 training images iid over 8 clients, 100 test
  images), k = 2, batch 8, 2 local steps, SGD lr 0.1 with momentum.
  Largest gaps, measured (CPU, 1 to 8 threads): test loss 4.0e-5 to
  1.04e-4 relative (growing over the rounds), top-1 0 samples. Bars:
  loss within 1e-3 relative, top-1 within 2 test samples.

The convolutions and matrix products sum in other orders in the two
packages, and in other orders again at other thread counts, so the
trajectories are held to bars, not bitwise; a ReLU input within float32
rounding of 0 turns such an order difference into a larger one, which
is why the ResNet-8 gap moves with the thread count. Quantized
runs are held per round instead (``tests/test_torch_round.py``): one
quantization flip moves the next round's start by a whole step.
"""
import os
import pickle

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import torch_threads  # noqa: F401 (two torch threads a worker)
from fedtorch_tpu import config as jcfg
from fedtorch_tpu.algorithms import make_algorithm as jmake
from fedtorch_tpu.data import build_federated_data as jbuild
from fedtorch_tpu.data.batching import round_row_plan as j_round_row_plan
from fedtorch_tpu.models import define_model as jdefine
from fedtorch_tpu.parallel import FederatedTrainer as JTrainer
from fedtorch_tpu.parallel import evaluate as jevaluate
from fedtorch_tpu.parallel.federated import participation_indices
from fedtorch_tpu_torch import config as tcfg
from fedtorch_tpu_torch.algorithms import make_algorithm as tmake
from fedtorch_tpu_torch.bridge import params_from_jax
from fedtorch_tpu_torch.data import build_federated_data as tbuild
from fedtorch_tpu_torch.models import define_model as tdefine
from fedtorch_tpu_torch.parallel import FederatedTrainer, RoundPlan
from fedtorch_tpu_torch.parallel.evaluate import evaluate as tevaluate


def _cfgs(sections):
    def cfg(mod):
        return mod.ExperimentConfig(**{
            name: getattr(mod, cls)(**kw)
            for name, (cls, kw) in sections.items()}).finalize()
    return cfg(jcfg), cfg(tcfg)


def _flat(params):
    return {"/".join(k.key for k in path): np.array(v) for path, v in
            jax.tree_util.tree_flatten_with_path(params)[0]}


def _plans(jtr, js, num_rounds):
    """The JAX round_fn's cohort and rows, replayed from its key chain."""
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


def _trajectories(jc, tc, num_rounds, plans=_plans, port_threads=()):
    """Per round, after it: (jax loss, port loss, jax top-1, port top-1)
    on the test set, and the test set's size. With ``port_threads``,
    also the port's own float32 order spread: per round, the largest
    relative gap in test loss between the port's run at the ambient
    torch thread count and its runs at each of these counts."""
    jfd, tfd = jbuild(jc), tbuild(tc)
    np.testing.assert_array_equal(tfd.test_x, jfd.test_x)
    B = jc.data.batch_size
    jmodel = jdefine(jc, batch_size=B)
    jtr = JTrainer(jc, jmodel, jmake(jc), jfd.train)
    js, jcl = jtr.init_state(jax.random.key(0))
    tmodel = tdefine(tc, batch_size=B, device="cpu")
    ttr = FederatedTrainer(tc, tmodel, tmake(tc), tfd.train, device="cpu")
    round_plans = plans(jtr, js, num_rounds)
    bridged = params_from_jax(_flat(js.params),
                              expect=ttr.init_state(0)[0].params,
                              module=tmodel.module)

    def port_run():
        ts, tcl = ttr.init_state(0)
        ts = ts._replace(params={n: v.clone() for n, v in bridged.items()})
        for n, p in tcl.params.items():
            p[:] = bridged[n]
        for plan in round_plans:
            ts, tcl, tm = ttr.round_fn(ts, tcl, plan)
            if tmodel.is_regression:  # no accuracy on a regression
                assert not tm.train_acc.any()
            tr = tevaluate(tmodel, ts.params, tfd.test_x, tfd.test_y)
            yield float(tr.loss), float(tr.top1)

    out = []
    for (tl, ta), _ in zip(port_run(), round_plans):
        js, jcl, jm = jtr.run_round(js, jcl)
        if tmodel.is_regression:
            assert not np.asarray(jm.train_acc).any()
        jr = jevaluate(jmodel, js.params, jfd.test_x, jfd.test_y)
        out.append((float(jr.loss), tl, float(jr.top1), ta))
    out = np.asarray(out)
    if not port_threads:
        return out, len(jfd.test_y)
    spread = np.zeros(num_rounds)
    for n in port_threads:
        with torch_threads.threads(n):
            other = np.array([loss for loss, _ in port_run()])
        spread = np.maximum(spread, np.abs(other - out[:, 1])
                            / np.abs(out[:, 1]))
    return out, len(jfd.test_y), spread


def _hold(traj, n_test, loss_rel, top1_samples, spread=None):
    """Test loss within ``loss_rel`` relative of the JAX package's each
    round, or within twice the port's own order ``spread`` where that is
    larger; top-1 within ``top1_samples`` test samples."""
    jl, tl, ja, ta = traj.T
    loss_gap = np.abs(tl - jl) / np.abs(jl)
    bar = loss_rel if spread is None else np.maximum(loss_rel, 2 * spread)
    top1_gap = np.abs(ta - ja) * n_test
    assert (loss_gap <= bar).all(), (loss_gap, bar)
    assert top1_gap.max() <= top1_samples + 1e-6, top1_gap
    # the bar is far below how much the trajectory itself moves
    assert np.ptp(jl) > 10 * np.max(bar) * np.abs(jl).max()


def test_mlp_30_fedavg_rounds_track_the_jax_package():
    jc, tc = _cfgs(dict(
        data=("DataConfig", dict(dataset="synthetic", batch_size=8,
                                 synthetic_samples_per_client=20)),
        federated=("FederatedConfig", dict(
            federated=True, num_clients=20, online_client_rate=0.25,
            algorithm="fedavg", sync_type="local_step")),
        model=("ModelConfig", dict(arch="mlp", mlp_hidden_size=32)),
        optim=("OptimConfig", dict(lr=0.05)),
        train=("TrainConfig", dict(local_step=2))))
    traj, n_test = _trajectories(jc, tc, 30)
    _hold(traj, n_test, loss_rel=1e-5, top1_samples=2)
    assert traj[-1, 0] < traj[0, 0]  # it learns the synthetic task


@pytest.mark.parametrize("algorithm, drfa", [("scaffold", False),
                                              ("fedavg", True)],
                         ids=["scaffold", "drfa"])
def test_mlp_30_zoo_rounds_track_the_jax_package(algorithm, drfa):
    """SCAFFOLD (plain local SGD) and DRFA over FedAvg on the MLP
    trajectory above, with DRFA's snapshot steps and probes replayed
    too. Bars as FedAvg's, or twice the port's own order spread (its
    trajectory at the ambient torch thread count against its runs at 1
    and 4) where that is larger: a ReLU input within rounding of 0
    parts SCAFFOLD's trajectory at round 30 from the JAX one by 4.96e-4
    at 2 and 3 threads, by <= 2.35e-7 at 1, 4 and 8, and the port's own
    runs part by as much. Largest gaps over the 30 rounds, measured
    (CPU) at an ambient 1, 2, 3, 4 and 8 threads: SCAFFOLD 2.35e-7,
    4.96e-4, 4.96e-4, 3.01e-7, 2.35e-7 relative (the two large ones at
    round 30, where the spread read 4.96e-4), DRFA <= 2.26e-7 at each
    (spread <= 2.45e-7); top-1 at most 1 sample."""
    from test_torch_zoo import _plans as zoo_plans
    jc, tc = _cfgs(dict(
        data=("DataConfig", dict(dataset="synthetic", batch_size=8,
                                 synthetic_samples_per_client=20)),
        federated=("FederatedConfig", dict(
            federated=True, num_clients=20, online_client_rate=0.25,
            algorithm=algorithm, drfa=drfa, sync_type="local_step")),
        model=("ModelConfig", dict(arch="mlp", mlp_hidden_size=32)),
        optim=("OptimConfig", dict(lr=0.05)),
        train=("TrainConfig", dict(local_step=2))))
    traj, n_test, spread = _trajectories(jc, tc, 30, plans=zoo_plans,
                                         port_threads=(1, 4))
    _hold(traj, n_test, loss_rel=1e-5, top1_samples=2, spread=spread)
    assert traj[-1, 0] < traj[0, 0]


def test_least_square_5_rounds_track_the_jax_package():
    """Regression on the synthetic tasks' float targets (which the port's
    stack_partitions once cast to int64), with the local steps' accuracy
    0 as in the JAX package."""
    jc, tc = _cfgs(dict(
        data=("DataConfig", dict(dataset="synthetic", batch_size=8,
                                 synthetic_regression=True,
                                 synthetic_samples_per_client=20)),
        federated=("FederatedConfig", dict(
            federated=True, num_clients=10, online_client_rate=0.3,
            algorithm="fedavg", sync_type="local_step")),
        model=("ModelConfig", dict(arch="least_square")),
        optim=("OptimConfig", dict(lr=0.01)),
        train=("TrainConfig", dict(local_step=2))))
    traj, n_test = _trajectories(jc, tc, 5)
    _hold(traj, n_test, loss_rel=1e-5, top1_samples=0)
    assert traj[-1, 0] < traj[0, 0]


def _write_cifar10(root, n_train, n_test, seed):
    """A CIFAR-10 python-pickle tree of random pixels and labels."""
    rng = np.random.RandomState(seed)
    base = os.path.join(root, "cifar-10-batches-py")
    os.makedirs(base)
    per = n_train // 5
    names = [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]
    for name, n in zip(names, [per] * 5 + [n_test]):
        batch = {b"data": rng.randint(0, 256, (n, 3072)).astype(np.uint8),
                 b"labels": rng.randint(0, 10, n).tolist()}
        with open(os.path.join(base, name), "wb") as f:
            pickle.dump(batch, f)


def test_resnet8_5_fedavg_rounds_track_the_jax_package(tmp_path):
    _write_cifar10(str(tmp_path), 128, 100, seed=1)
    jc, tc = _cfgs(dict(
        data=("DataConfig", dict(dataset="cifar10", data_dir=str(tmp_path),
                                 batch_size=8, augment=False)),
        federated=("FederatedConfig", dict(
            federated=True, num_clients=8, online_client_rate=0.25,
            algorithm="fedavg", sync_type="local_step")),
        model=("ModelConfig", dict(arch="resnet8")),
        optim=("OptimConfig", dict(lr=0.1, in_momentum=True)),
        train=("TrainConfig", dict(local_step=2))))
    traj, n_test = _trajectories(jc, tc, 5)
    _hold(traj, n_test, loss_rel=1e-3, top1_samples=2)
