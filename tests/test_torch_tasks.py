"""The federated tasks' rounds in the port against the JAX package, on the
CPU: the LeNet ``cnn`` (MNIST-shaped images) and the char-GRU ``rnn``
(Shakespeare-shaped token windows) through ``FederatedTrainer``, the
recurrent carry's rules, and the CLI on the tasks' own file formats.

8 clients of 8 rows, k = 2, batch 4, 2 local steps; the ``rnn`` at
hidden 8 on windows of 8. Both packages start from the same (bridged)
weights and take the JAX round's cohorts and rows, replayed from its key
chain. Bars:

* quantized FedAvg (int8 both ways), each round from the JAX package's
  state (a one-step flip of a wire value is a real difference that the
  next round's steps amplify, ``tests/test_torch_round.py``): the
  server update within 1e-3 relative L2 and every element within two
  downlink quantization steps, the clients' losses within rtol 1e-3;
* DRFA over FedAvg and PerFedMe on the ``rnn`` (their probes and
  personal forwards start from a fresh zero carry, the main local loop
  threads it): every leaf of the server params, lambda and the personal
  models within 1e-5 of its tree's largest value
  (``tests/test_torch_zoo.py``'s bar);
* ``evaluate`` on the ``rnn`` (a fresh carry per batch, the last batch
  padded): loss, top-1 and top-5 within 1e-5;
* the ``rnn`` on the stream plane: bit for bit the resident plane's
  server, clients and metrics, through ``run_round`` and
  ``run_rounds(2)``.
"""
import glob
import os

import jax
import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401 (two torch threads a worker)
from fedtorch_tpu import config as jcfg
from fedtorch_tpu.algorithms import make_algorithm as jmake
from fedtorch_tpu.data.batching import stack_partitions as jstack
from fedtorch_tpu.models import define_model as jdefine
from fedtorch_tpu.parallel import FederatedTrainer as JTrainer
from fedtorch_tpu.parallel.evaluate import evaluate as jevaluate
from fedtorch_tpu_torch import cli as tcli
from fedtorch_tpu_torch import config as tcfg
from fedtorch_tpu_torch.algorithms import make_algorithm as tmake
from fedtorch_tpu_torch.bridge import params_from_jax, params_to_jax
from fedtorch_tpu_torch.data.batching import stack_partitions as tstack
from fedtorch_tpu_torch.models import define_model as tdefine
from fedtorch_tpu_torch.parallel import FederatedTrainer
from fedtorch_tpu_torch.parallel.evaluate import evaluate as tevaluate
from format_fixtures import (
    emnist_writer_id, write_tff_emnist, write_tff_shakespeare,
)
from test_torch_personalized import _assert_close
from test_torch_round import _copy_state
from test_torch_zoo import _flat, _plans
from test_torch_zoo import _copy_state as _copy_aux

C, N, B, K, H, T = 8, 8, 4, 2, 8, 8
TIMEOUT_S = 20.0
TASKS = {
    "cnn": dict(dataset="mnist", arch="cnn"),
    "rnn": dict(dataset="shakespeare", arch="rnn"),
}


def _population(arch, seed=0):
    rng = np.random.RandomState(seed)
    if arch == "cnn":
        x = rng.randn(C * N, 28, 28, 1).astype(np.float32)
        y = rng.randint(0, 10, C * N)
    else:
        x = rng.randint(0, 86, (C * N, T)).astype(np.int32)
        y = rng.randint(0, 86, (C * N, T)).astype(np.int32)
    return x, y, [np.arange(i * N, (i + 1) * N) for i in range(C)]


def _cfg(mod, task, plane="device", **fed):
    return mod.ExperimentConfig(
        data=mod.DataConfig(dataset=TASKS[task]["dataset"], batch_size=B,
                            augment=False, data_plane=plane),
        federated=mod.FederatedConfig(
            federated=True, num_clients=C, online_client_rate=0.25,
            sync_type="local_step", **fed),
        model=mod.ModelConfig(arch=TASKS[task]["arch"], rnn_hidden_size=H,
                              rnn_seq_len=T),
        optim=mod.OptimConfig(lr=0.1, in_momentum=True),
        train=mod.TrainConfig(local_step=K)).finalize()


def _port(task, plane="device", **fed):
    cfg = _cfg(tcfg, task, plane, **fed)
    x, y, parts = _population(TASKS[task]["arch"])
    t = FederatedTrainer(cfg, tdefine(cfg, batch_size=B, device="cpu"),
                         tmake(cfg), tstack(x, y, parts), device="cpu")
    t.stream_timeout_s = TIMEOUT_S
    return t


def _pair(task, **fed):
    """Both packages' trainers, the port's state on the JAX weights."""
    jc = _cfg(jcfg, task, **fed)
    x, y, parts = _population(TASKS[task]["arch"])
    jtr = JTrainer(jc, jdefine(jc, batch_size=B), jmake(jc),
                   jstack(x, y, parts))
    js, jcl = jax.jit(jtr.init_state)(jax.random.key(0))
    ttr = _port(task, **fed)
    ts, tcl = ttr.init_state(0)
    ts = _copy_state(js, jcl, ts, tcl, ttr.model.module)
    ts = _copy_aux(js, jcl, ts, tcl, ttr.model.module)
    return jtr, js, jcl, ttr, ts, tcl


@pytest.mark.parametrize("task", sorted(TASKS))
def test_quantized_fedavg_rounds_match(task):
    jtr, js, jcl, ttr, ts, tcl = _pair(task, quantized=True)
    module = ttr.model.module
    for r, plan in enumerate(_plans(jtr, js, 2)):
        if r:
            ts = _copy_state(js, jcl, ts, tcl, module)
        jp0 = _flat(js.params)
        js, jcl, jm = jtr.run_round(js, jcl)
        ts, tcl, tm = ttr.round_fn(ts, tcl, plan)
        jp, tp = _flat(js.params), params_to_jax(ts.params, module)
        ju = np.concatenate([(jp[k] - jp0[k]).ravel() for k in jp])
        tu = np.concatenate([(tp[k] - jp0[k]).ravel() for k in jp])
        assert np.linalg.norm(tu - ju) <= 1e-3 * np.linalg.norm(ju), r
        for k in jp:
            u = jp[k] - jp0[k]
            step = (u.max() - u.min()) / 255.0
            assert np.abs((tp[k] - jp0[k]) - u).max() <= 2 * step + 1e-7, k
        np.testing.assert_array_equal(tm.online_mask.numpy(),
                                      np.asarray(jm.online_mask))
        np.testing.assert_allclose(tm.train_loss.numpy(),
                                   np.asarray(jm.train_loss), rtol=1e-3,
                                   atol=1e-5)
        assert float(tm.comm_bytes) == float(jm.comm_bytes)


@pytest.mark.parametrize("algorithm, fed", [
    ("fedavg", dict(drfa=True)), ("perfedme", dict(perfedme_lambda=5.0))],
    ids=["drfa", "perfedme"])
def test_fresh_carry_rules_on_the_rnn_match(algorithm, fed):
    """DRFA's dual update probes the k-th average model from a fresh
    carry (``forward_reset``); PerFedMe's personal model takes every
    step from a fresh carry while the carry it hands on is never
    advanced. One round each, and lambda or the personal models."""
    jtr, js, jcl, ttr, ts, tcl = _pair("rnn", algorithm=algorithm, **fed)
    (plan,) = _plans(jtr, js, 1)
    js, jcl, _ = jtr.run_round(js, jcl)
    ts, tcl, _ = ttr.round_fn(ts, tcl, plan)
    assert _assert_close(js, jcl, ts, tcl, ttr.model.module) >= 9
    if algorithm == "fedavg":
        lam = ts.aux["lambda"]
        assert float(lam.max() - lam.min()) > 0


def test_evaluate_on_the_rnn_matches():
    """Server-side evaluation of 10 windows at batch 4: a fresh zero
    carry per batch, the last batch padded and masked."""
    jc = _cfg(jcfg, "rnn")
    jm = jdefine(jc, batch_size=B)
    jp = jax.jit(jm.init)(jax.random.key(1))
    tm = tdefine(_cfg(tcfg, "rnn"), batch_size=B, device="cpu")
    tp = params_from_jax(_flat(jp), expect=tm.init(torch.Generator()),
                         module=tm.module)
    x, y, _ = _population("rnn", seed=2)
    want = jevaluate(jm, jp, x[:10], y[:10], batch_size=4)
    got = tevaluate(tm, tp, x[:10], y[:10], batch_size=4)
    for g, w in zip(got, want):
        assert float(g) == pytest.approx(float(w), rel=1e-5, abs=1e-6)
    assert 0.0 < float(got.loss)


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [v for k in sorted(tree) for v in _leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [v for t in tree for v in _leaves(t)]
    return []


@pytest.mark.parametrize("dispatch", ["round", "window2"])
def test_rnn_on_the_stream_plane_is_bitwise_the_resident_plane(dispatch):
    """Three rounds from one seed on each plane (the token windows pack
    and copy as the resident plane gathers them), quantized."""
    runs = []
    for plane in ("device", "stream"):
        t = _port("rnn", plane, quantized=True)
        try:
            server, clients = t.init_state(5)
            for n in ([1, 1, 1] if dispatch == "round" or plane == "device"
                      else [1, 2]):
                if dispatch == "round" or plane == "device":
                    server, clients, m = t.run_round(server, clients)
                else:
                    server, clients, ms = t.run_rounds(server, clients, n)
                    m = type(ms)(*(None if f is None else f[-1] for f in ms))
        finally:
            t.close()
        assert (t.data is None) == (plane == "stream")
        runs.append((server, clients, m))
    (sa, ca, ma), (sb, cb, mb) = runs
    assert sa.round == sb.round == 3
    assert torch.equal(sa.rng.get_state(), sb.rng.get_state())
    want, got = (_leaves((s.params, s.opt, c, m))
                 for s, c, m in ((sa, ca, ma), (sb, cb, mb)))
    assert len(want) == len(got) > 10
    for w, g in zip(want, got):
        assert torch.equal(w, g)


def _write_tasks(root):
    write_tff_emnist(os.path.join(root, "emnist",
                                  "fed_emnist_digitsonly_train.h5"),
                     {emnist_writer_id(i): 6 + i for i in range(8)})
    write_tff_emnist(os.path.join(root, "emnist",
                                  "fed_emnist_digitsonly_test.h5"),
                     {emnist_writer_id(9): 7})
    text = "To be, or not to be: that is the question. " * 3
    write_tff_shakespeare(
        os.path.join(root, "shakespeare", "shakespeare_train.h5"),
        {f"PLAY_{i}_CHARACTER": [text[i:], "Exeunt."] for i in range(8)})


@pytest.mark.parametrize("words", [
    ["-d", "emnist", "-a", "cnn", "--quantized", "true"],
    ["-d", "shakespeare", "-a", "rnn", "--rnn_hidden_size", "8",
     "--rnn_seq_len", "8", "--quantized", "true"],
    ["-d", "shakespeare", "-a", "rnn", "--rnn_hidden_size", "8",
     "--rnn_seq_len", "8", "-f", "false", "--num_epochs", "1",
     "--local_step", "2"],
], ids=["emnist_cnn", "shakespeare_rnn", "shakespeare_rnn_local_sgd"])
def test_cli_runs_the_tasks_from_their_files(words, tmp_path):
    """The port's CLI on TFF files written here: the natural partitions
    (the first 8 writers or characters), a round and an evaluation;
    local-SGD mode runs the ``rnn`` too, as the JAX package's library
    does (its local-SGD trainer is the federated round, carry and
    all)."""
    _write_tasks(tmp_path / "data")
    argv = ["--backend", "cpu", "-p", str(tmp_path / "data"),
            "--num_workers", "8", "-b", "4", "--lr", "0.1",
            "--num_comms", "1", "--eval_freq", "1", "--debug", "false",
            "-c", str(tmp_path / "ck")] + words
    if "-f" not in words:
        argv += ["-f", "true", "--online_client_rate", "0.25",
                 "--federated_sync_type", "local_step", "--local_step",
                 "2"]
    res = tcli.main(argv)
    assert 0.0 <= res["test_top1"] <= 1.0 and res["rounds"] >= 1
    (record,) = glob.glob(str(tmp_path / "ck" / "**" / "record0"),
                          recursive=True)
    assert "Mode: test" in open(record).read()
