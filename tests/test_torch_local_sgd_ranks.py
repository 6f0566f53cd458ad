"""Local-SGD mode on several ranks (``parallel/local_sgd.py`` at
``client_shards`` 0), on the CPU.

``build_local_sgd`` -> ``fit`` on the JAX package's
``tests/test_mesh_padding.py`` task (``logistic_regression`` on 12
synthetic features pooled from 4 tasks, batch 10, lr 0.2, 2 epochs of
K = 2). Each rank holds its ``C_pad/W`` workers' rows of the state and
of the shards and runs its ``ceil(C/W)`` workers of each round; the
cohort gather brings every rank every worker's rows before the average.
Two spawned gloo groups, world 2 and world 4 (``tests/torch_dist.py``),
run ``fit`` with ``avg_model`` on and off, with ``reshuffle_per_epoch``
(each rank keeps its workers' rows of the new partition), with growing
batches, and with 6 workers on 4 ranks (blocks of 2, 2, 2 and 0); each
is held **bitwise** to the port's one-rank ``fit`` in this process:
every round's server params and metrics, the replicated epochs and
local indices, and the workers' rows, which the ranks hold together.
Every round issues one exchange and one cohort gather. 6 workers on 4
ranks stop as ``test_mesh_padding.py`` requires (every real worker at
2 epochs and less than 2.5), after as many rounds as the JAX package's
``fit`` on 4 devices. Against the JAX package: its ``build_local_sgd``
on W of the conftest's CPU devices, its weights and each round's plan
(every worker, in the order its key chain draws them) replayed into the
port, every round's server params within atol = rtol = 1e-5. The CLI's
``--federated false`` on two processes logs the one-process run's test
line.
"""
import dataclasses
import functools
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401 (two torch threads a worker)
from torch_dist import (
    Group, _numpy, bridged, local_sgd_cfg, local_sgd_data, local_sgd_fit,
)
from fedtorch_tpu import config as jcfg
from fedtorch_tpu.models import define_model as jdefine
from fedtorch_tpu.parallel.local_sgd import build_local_sgd as j_build
from fedtorch_tpu_torch.bridge import params_to_jax
from fedtorch_tpu_torch.models import define_model as tdefine
from fedtorch_tpu_torch.parallel.local_sgd import build_local_sgd
from test_torch_local_sgd import jax_plan
from test_torch_mesh import REPO, _train_lines
from test_torch_podscale import _assert_bitwise, _leaves
from test_torch_zoo import _flat

FITS = {
    2: {"avg": {}, "sum": dict(avg_model=False),
        "reshuffle": dict(reshuffle=True), "growing": dict(growing=True)},
    4: {"avg": {}, "sum": dict(avg_model=False), "six": dict(num_clients=6),
        "six_reshuffle_growing": dict(num_clients=6, reshuffle=True,
                                      growing=True)},
}
# the JAX comparisons: one epoch of K = 2 (the plans replayed)
JAX_FIT = dict(num_epochs=1)


def _jax_cfg(world, **kw):
    jc = local_sgd_cfg(mod=jcfg, **kw)
    return dataclasses.replace(jc, mesh=dataclasses.replace(
        jc.mesh, num_devices=world))


@functools.lru_cache(maxsize=None)
def _one_rank(world, name):
    """The fit in this one process."""
    return _numpy(local_sgd_fit(None, **FITS[world][name]))


@functools.lru_cache(maxsize=None)
def _jax_fit(world):
    """The JAX package's fit on ``world`` CPU devices: its weights, each
    round's server params; and the port's one-rank fit on its weights
    and plans (each round's plan replayed from the JAX key chain at that
    round's K and B), with the plans it took."""
    jc = _jax_cfg(world, **JAX_FIT)
    feats, labels = local_sgd_data()
    jtr = j_build(jc, jdefine(jc, batch_size=10), feats, labels)
    assert jtr.mesh.devices.size == world
    js0, _ = jtr.init_state(jax.random.key(5))
    weights = _flat(js0.params)
    key = jax.random.wrap_key_data(jax.random.key_data(js0.rng))
    jrounds = []
    jtr.fit(jax.random.key(5), callback=lambda s, c, m: jrounds.append(
        _flat(s.params)))
    tc = local_sgd_cfg(**JAX_FIT)
    ttr = build_local_sgd(tc, tdefine(tc, batch_size=10, device="cpu"),
                          feats, labels, device="cpu")
    plans = []

    def draw(server):
        plans.append(jax_plan(key, server.round, ttr.sizes, ttr.data.n_max,
                              ttr.k_online,
                              ttr.local_steps * ttr.batch_size))
        return plans[-1]
    ttr.draw_plan = draw
    bridged(ttr, weights)
    steps = []
    ttr.fit(5, callback=lambda s, c, m: steps.append(
        {n: v.clone() for n, v in s.params.items()}))
    return dict(weights=weights, jax=jrounds, plans=plans,
                port=_numpy(steps), module=ttr.model.module)


def _case_table(world):
    table = {name: ("local_sgd_fit", kw) for name, kw in FITS[world].items()}
    ref = _jax_fit(world)
    table["jax"] = ("local_sgd_fit", dict(JAX_FIT, seed=5,
                                          plans=ref["plans"],
                                          weights=ref["weights"]))
    return table


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    started = {}
    for world in (2, 4):
        d = tmp_path_factory.mktemp(f"lsgd{world}")
        started[world] = Group(world, [(n, fn, kw) for n, (fn, kw)
                                       in _case_table(world).items()], d)
    yield started
    for g in started.values():
        if g.results is None:
            g.results = g._collect()


CASES = [(w, n) for w in (2, 4) for n in FITS[w]]


@pytest.mark.parametrize("world, name", CASES)
def test_fit_on_ranks_is_bitwise_the_one_rank_fit(world, name, groups):
    runs = groups[world].result(name)
    whole = _one_rank(world, name)
    C = whole["clients"][3].shape[0]
    per = -(-C // world)
    owned = []
    for rank, got in enumerate(runs):
        assert got["rounds"] == whole["rounds"]
        _assert_bitwise([got["steps"], got["params"], got["metrics"]],
                        [whole["steps"], whole["params"], whole["metrics"]])
        _assert_bitwise(got["clients"][3:], whole["clients"][3:])
        assert got["rows"] == [rank * per, (rank + 1) * per]
        owned.append(_leaves(got["clients"][:3]))
        # a round: one exchange and one cohort gather, no seam; the
        # rows' layout once where a rank runs no worker (6 on 4 ranks)
        n = whole["rounds"]
        empty = (world - 1) * per >= C
        assert got["counts"] == dict(seam=0, exchange=n, norms=0, cohort=n,
                                     layout=int(empty))
    _assert_bitwise([np.concatenate(xs)[:C] for xs in zip(*owned)],
                    _leaves(whole["clients"][:3]))


def test_six_workers_on_four_ranks_stop_as_the_jax_package_requires(
        groups):
    """Every real worker finishes ~2 epochs, at most one round over
    (``test_mesh_padding.py``), in as many rounds as the JAX package's
    fit of the 6 workers on 4 devices; no rank holds a pad row's epoch."""
    runs = groups[4].result("six")
    for got in runs:
        epochs = got["clients"][3]
        assert epochs.shape == (6,)
        assert epochs.min() >= 2.0 and epochs.max() < 2.5
    jc = _jax_cfg(4, num_clients=6)
    feats, labels = local_sgd_data()
    jtr = j_build(jc, jdefine(jc, batch_size=10), feats, labels)
    assert jtr.padded_clients == 8
    _, jclients, jhist = jtr.fit(jax.random.key(0))
    assert len(jhist) == runs[0]["rounds"]
    jepochs = np.asarray(jclients.epoch)
    assert jepochs[:6].min() >= 2.0 and jepochs[:6].max() < 2.5


@pytest.mark.parametrize("world", [2, 4])
def test_fit_against_the_jax_package_on_w_devices(world, groups):
    """The JAX ``build_local_sgd`` on W devices and the port on W ranks
    from its weights and plans: every round's server params within
    atol = rtol = 1e-5; the ranks bitwise the port's one-rank fit on the
    same plans."""
    ref = _jax_fit(world)
    assert len(ref["jax"]) == len(ref["port"]) > 1
    for got in groups[world].result("jax"):
        _assert_bitwise(got["steps"], ref["port"])
    for want, step in zip(ref["jax"], ref["port"]):
        flat = params_to_jax({n: torch.from_numpy(v) for n, v in
                              step.items()}, ref["module"])
        for n, v in want.items():
            np.testing.assert_allclose(flat[n], v, atol=1e-5, rtol=1e-5,
                                       err_msg=n)


def test_the_cli_local_sgd_on_two_ranks_logs_the_one_process_line(tmp_path):
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="1")

    def argv(run_dir, extra):
        return [sys.executable, "-m", "fedtorch_tpu_torch.cli", "--backend",
                "cpu", "-f", "false", "-d", "synthetic", "-a",
                "logistic_regression", "--num_workers", "4", "--num_epochs",
                "1", "--local_step", "4", "-b", "10", "--debug", "false",
                "--run_dir", str(run_dir)] + extra
    procs = [subprocess.Popen(
        argv(tmp_path / "run", [
            "--num_processes", "2", "--process_id", str(rank),
            "--coordinator_address", f"file://{tmp_path / 'store'}"]),
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for rank in (0, 1)]
    procs.append(subprocess.Popen(argv(tmp_path / "one", []), cwd=REPO,
                                  env=env, stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True))
    try:
        outs = [(p.communicate(timeout=240), p.returncode) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for (out, err), rc in outs:
        assert rc == 0, err[-3000:]
    lines = [_train_lines(tmp_path / "run" / f"record{r}") for r in (0, 1)]
    assert len(lines[0]) == 1 and "Mode: test" in lines[0][0]
    assert lines[0] == lines[1] == _train_lines(tmp_path / "one" / "record0")
