"""The port's command line, against the JAX package's, on the CPU.

The parser must take every JAX flag with the same option strings,
default, type and choices, and ``args_to_config`` must build the same
config; a ``--backend cpu`` synthetic run must return the JAX package's
results dict and log its train and val lines; every flag the port has
not ported must be refused by name; and without ``--backend cpu`` and
without a card the run must raise rather than run on the CPU.
"""
import argparse
import dataclasses
import glob
import os
import re
import subprocess
import sys

import pytest
import torch

import torch_threads  # noqa: F401 (two torch threads a worker)
from fedtorch_tpu import cli as jcli
from fedtorch_tpu.utils.logging import RunLogger as JLogger
from fedtorch_tpu_torch import cli as tcli
from fedtorch_tpu_torch.utils.logging import RunLogger as TLogger

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _actions(parser):
    return {a.option_strings[0] if a.option_strings else a.dest: a
            for a in parser._actions
            if not isinstance(a, argparse._HelpAction)}


def _kind(t):
    return None if t is None else t.__name__


def test_every_jax_flag_has_the_same_port_flag():
    want, got = _actions(jcli.build_parser()), _actions(tcli.build_parser())
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        g = got[name]
        assert g.option_strings == w.option_strings, name
        assert g.dest == w.dest, name
        assert g.default == w.default, name
        assert _kind(g.type) == _kind(w.type), name
        assert (tuple(g.choices) if g.choices else None) == \
            (tuple(w.choices) if w.choices else None), name
        assert type(g) is type(w) and g.nargs == w.nargs, name


ARGVS = [
    [],
    ["-d", "synthetic", "-a", "mlp", "-f", "true", "--num_workers", "20",
     "--online_client_rate", "0.25", "--local_step", "3", "-b", "16"],
    ["-d", "cifar10", "-p", "/data", "-a", "resnet20", "-f", "true",
     "--num_workers", "100", "--online_client_rate", "0.1",
     "--federated_sync_type", "local_step", "--local_step", "10", "-b", "50",
     "--lr", "0.1", "--in_momentum", "true", "--quantized", "true",
     "--compute_dtype", "bfloat16", "--num_comms", "3", "--evaluate", "true",
     "--eval_freq", "1"],
    ["-d", "shakespeare", "-a", "transformer", "--rnn_hidden_size", "128",
     "--mlp_num_layers", "4", "--rnn_seq_len", "2048", "--attention",
     "flash", "--federated_type", "fedprox", "--fedprox_mu", "0.01",
     "--lr_schedule_scheme", "custom_multistep", "--lr_change_epochs",
     "10,20", "--num_epochs", "30"],
    ["--iid_data", "false", "--dirichlet", "true", "-j", "8",
     "--federated_type", "fedadam", "--fedadam_beta", "0.5", "--optimizer",
     "adam", "--weight_decay", "0", "--manual_seed", "11", "--backend",
     "cpu", "--per_class_acc", "true", "-e", "true"],
]


@pytest.mark.parametrize("argv", ARGVS, ids=range(len(ARGVS)))
def test_args_to_config_builds_the_jax_package_s_config(argv):
    want = jcli.args_to_config(jcli.build_parser().parse_args(argv))
    got = tcli.args_to_config(tcli.build_parser().parse_args(argv))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


_TRAIN = re.compile(r"Round: (\d+)\. Epoch: [\d.]+\. Local index: \d+\. .*"
                    r"Loss: [\d.]+ \| top1: [\d.]+ \| lr: [\d.]+ \| "
                    r"CommBytes: \d+")
_VAL = re.compile(r"Round: (\d+)\. Mode: test\. Loss: [\d.]+ \| top1: "
                  r"[\d.]+ \| top5: [\d.]+ \| best: [\d.]+")


def _synthetic_argv(tmp_path, arch, rounds=3):
    return ["--backend", "cpu", "-f", "true", "-d", "synthetic", "-a", arch,
            "--num_workers", "8", "--online_client_rate", "0.5",
            "--federated_sync_type", "local_step", "--local_step", "2",
            "-b", "16", "--lr", "0.1", "--mlp_hidden_size", "32",
            "--num_comms", str(rounds), "--eval_freq", "1", "--debug",
            "false", "-c", str(tmp_path / "ck")]


@pytest.mark.parametrize("arch", ["logistic_regression", "mlp"])
def test_synthetic_cpu_run_returns_results_and_logs_both_lines(arch,
                                                               tmp_path):
    res = tcli.main(_synthetic_argv(tmp_path, arch) + ["--per_class_acc",
                                                       "true"])
    assert set(res) == {"test_top1", "best_top1", "rounds", "timer",
                        "data_plane"}
    assert res["rounds"] == 3 and res["data_plane"] == "device"
    assert 0.0 <= res["test_top1"] <= res["best_top1"] <= 1.0
    assert {"data", "round", "eval", "comm_bytes_total"} <= set(res["timer"])
    (record,) = glob.glob(str(tmp_path / "ck" / "synthetic" / arch / "*"
                              / "record0"))
    text = open(record).read()
    assert [int(m) for m in _TRAIN.findall(text)] == [0, 1, 2]
    assert [int(m) for m in _VAL.findall(text)] == [0, 1, 2]
    assert text.count("Per-class acc:") == 3
    run = os.path.dirname(record)
    assert {"checkpoint.ckpt", "metrics.jsonl", "health.json"} <= \
        set(os.listdir(run))
    # the anomaly detector watches the rows at its default threshold
    with open(os.path.join(run, "events.jsonl")) as f:
        assert '"event": "anomaly.summary"' in f.read()


@pytest.mark.parametrize("arch, words", [
    ("mlp", ["--drop_rate", "0.3", "--norm", "gn"]),
    ("robust_mlp", ["--robust_agg", "krum", "--guard_updates", "true"]),
], ids=["mlp_dropout_gn", "robust_mlp_krum"])
def test_zoo_model_and_robustness_flags_run_on_the_cpu(arch, words,
                                                       tmp_path):
    """Flags the port once refused by name now run: dropout and
    GroupNorm, a robust model, a robust rule with the guards; a guarded
    round that rejects nothing logs no ``faults`` line."""
    res = tcli.main(_synthetic_argv(tmp_path, arch) + words)
    assert res["rounds"] == 3
    assert 0.0 <= res["test_top1"] <= res["best_top1"] <= 1.0
    (record,) = glob.glob(str(tmp_path / "ck" / "synthetic" / arch / "*"
                              / "record0"))
    text = open(record).read()
    assert [int(m) for m in _VAL.findall(text)] == [0, 1, 2]
    assert "guards rejected EVERY" not in text


def _replay_the_jax_run(monkeypatch, argv, rounds):
    """Make the port's trainer start from the JAX CLI's initial weights
    (and the client aux made from them) and take its cohorts, rows,
    validation rows and DRFA draws, replayed from the key chain of a JAX
    trainer built as the JAX CLI builds it."""
    import jax
    from fedtorch_tpu.algorithms import make_algorithm as jmake
    from fedtorch_tpu.data import build_federated_data as jbuild
    from fedtorch_tpu.models import define_model as jdefine
    from fedtorch_tpu.parallel import FederatedTrainer as JTrainer
    from fedtorch_tpu_torch.bridge import params_from_jax
    from fedtorch_tpu_torch.parallel import FederatedTrainer
    from test_torch_personalized import _plans
    from test_torch_zoo import _flat

    jc = jcli.args_to_config(jcli.build_parser().parse_args(argv))
    jdata = jbuild(jc)
    jtr = JTrainer(jc, jdefine(jc, batch_size=jc.data.batch_size),
                   jmake(jc), jdata.train, val_data=jdata.val)
    js, _ = jtr.init_state(jax.random.key(jc.train.manual_seed))
    flat = _flat(js.params)
    plans = iter(_plans(jtr, js, rounds))
    init_state = FederatedTrainer.init_state

    def bridged_init_state(self, rng):
        server, clients = init_state(self, rng)
        params = params_from_jax(flat, expect=server.params,
                                 module=self.model.module)
        for n, p in clients.params.items():
            p[:] = params[n]
        clients = clients._replace(
            aux=self.algorithm.init_client_aux(clients.params))
        return server._replace(params=params), clients

    monkeypatch.setattr(FederatedTrainer, "init_state", bridged_init_state)
    monkeypatch.setattr(FederatedTrainer, "draw_plan",
                        lambda self, server: next(plans))


def test_train_and_val_lines_are_the_jax_package_s():
    lines = []
    for logger in (JLogger(debug=False), TLogger(debug=False)):
        logger.log = lines.append
        logger.log_train(3, 1.25, 0.5, 0.25, 0.1, comm_bytes=1024,
                         round_time=0.5)
        logger.log_val(3, "test", 2.0, 0.3, 0.7, best=0.4)
    assert lines[:2] == lines[2:]


def test_module_entry_point_runs_on_the_cpu(tmp_path):
    """``python -m fedtorch_tpu_torch.cli``, as a user runs it."""
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    r = subprocess.run([sys.executable, "-m", "fedtorch_tpu_torch.cli"]
                       + _synthetic_argv(tmp_path, "mlp", rounds=2)
                       + ["--debug", "true"],
                       cwd=str(tmp_path), env=env, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert len(_VAL.findall(r.stdout)) == 2


def test_without_a_card_and_without_backend_cpu_it_raises(monkeypatch,
                                                          tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = _synthetic_argv(tmp_path, "mlp")
    argv = argv[2:]  # no --backend cpu
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tcli.main(argv)


def _other_value(action):
    """A valid value other than the flag's default, as argv words."""
    special = {"--over_select_frac": "1.5", "--dp_delta": "0.001",
               "--snapshot_ring": "4", "--host_fault_seams": "ckpt.write",
               "--data_store_dir": "/tmp/store", "--data_store": "mmap",
               "--checkpoint_keep_last_n": "2", "--resume": "/tmp/run",
               "--compressed_ratio": "0.5", "--num_devices": "2",
               "--num_processes": "2", "--process_id": "1",
               "--coordinator_address": "localhost:1234",
               "--client_shards": "2", "--save_some_models": "1,2",
               "--checkpoint_index": "3", "--robust_trim_frac": "0.2"}
    flag = action.option_strings[-1]
    if isinstance(action, argparse._StoreTrueAction):
        return [flag]
    if flag in special:
        return [flag, special[flag]]
    if action.choices:
        return [flag, next(c for c in action.choices if c != action.default)]
    if action.type is not None and action.type.__name__ == "str2bool":
        return [flag, str(not action.default).lower()]
    if action.type is int:
        return [flag, str((action.default or 0) + 1)]
    if action.type is float:
        return [flag, str((action.default or 0.0) + 0.25)]
    return [flag, "x"]


@pytest.mark.parametrize("flag", sorted(tcli.UNPORTED_FLAGS))
def test_unported_flags_are_refused_by_name(flag, tmp_path):
    action = _actions(tcli.build_parser())[f"--{flag}"]
    # the flags the config only takes together with another one
    companion = {"dp_epsilon_budget": ["--dp_noise_multiplier", "1.0"]}
    argv = _synthetic_argv(tmp_path, "mlp") + _other_value(action) \
        + companion.get(flag, [])
    with pytest.raises(ValueError, match=re.escape(f"--{flag} ")):
        tcli.main(argv)
    assert not os.path.exists(tmp_path / "ck")  # refused before it ran


@pytest.mark.parametrize("words, name", [
    (["--backend", "tpu"], "--backend"),
    (["--download", "true"], "--download"),
])
def test_other_unported_modes_are_refused_by_name(words, name, tmp_path):
    with pytest.raises(ValueError, match=re.escape(name)):
        tcli.main(_synthetic_argv(tmp_path, "mlp") + words)


def test_client_fusion_runs_from_the_cli(tmp_path):
    """Once refused by name, now ported: ``--client_fusion fused`` on the
    ``cnn`` (EMNIST files written here, int8 both ways) logs the rounds
    and evaluations of the per-client ('vmap') run from the same seed,
    its train losses within 1e-4 and its test top-1 equal."""
    from format_fixtures import emnist_writer_id, write_tff_emnist
    root = tmp_path / "data" / "emnist"
    write_tff_emnist(str(root / "fed_emnist_digitsonly_train.h5"),
                     {emnist_writer_id(i): 6 + i for i in range(8)})
    write_tff_emnist(str(root / "fed_emnist_digitsonly_test.h5"),
                     {emnist_writer_id(9): 7})
    runs = {}
    for fusion in ("fused", "vmap"):
        ck = tmp_path / fusion
        res = tcli.main([
            "--backend", "cpu", "-p", str(tmp_path / "data"), "-d",
            "emnist", "-a", "cnn", "--quantized", "true", "-f", "true",
            "--num_workers", "8", "--online_client_rate", "0.25",
            "--federated_sync_type", "local_step", "--local_step", "2",
            "-b", "4", "--lr", "0.1", "--num_comms", "2", "--eval_freq",
            "1", "--debug", "false", "-c", str(ck), "--client_fusion",
            fusion])
        (record,) = glob.glob(str(ck / "**" / "record0"), recursive=True)
        runs[fusion] = (res, open(record).read())
    (fres, ftext), (vres, vtext) = runs["fused"], runs["vmap"]
    assert fres["rounds"] == vres["rounds"] == 2
    assert fres["test_top1"] == vres["test_top1"]
    assert [int(m) for m in _TRAIN.findall(ftext)] == [0, 1]
    assert [int(m) for m in _VAL.findall(ftext)] == [0, 1]
    loss = re.compile(r"Round: \d+\. Epoch.*?Loss: ([\d.]+)")
    for f, v in zip(loss.findall(ftext), loss.findall(vtext)):
        assert abs(float(f) - float(v)) <= 1e-4 * max(float(v), 1.0)


@pytest.mark.parametrize("sub", tcli.SUBCOMMANDS)
def test_the_jax_package_s_subcommands_are_refused_by_name(sub):
    with pytest.raises(ValueError, match=f"{sub}.*not yet ported"):
        tcli.main([sub, "--help"])


@pytest.mark.parametrize("argv, says", [
    (["lint"], "fedtorch_tpu_torch.lint: 0 NEW finding(s)"),
    (["lint", "--explain"], "no eager-torch meaning"),
    (["audit", "--registry-only"], "0 NEW finding(s) (0 registry, 0 "
                                   "concurrency); no program audit")])
def test_the_lint_and_audit_subcommands_run(argv, says, capsys):
    """Once refused by name, now the port's own (fedtorch_tpu_torch/lint):
    each returns its exit code, 0 on the tree."""
    assert tcli.main(argv) == 0
    assert says in capsys.readouterr().out


def test_cost_capture_scan_rounds_runs_from_the_cli(tmp_path):
    """Once refused by name: ``--cost_capture_scan_rounds 3`` adds the
    host loop's ``rounds_scan[3]`` entry, 3 rounds' FLOPs."""
    import json
    tcli.main(_synthetic_argv(tmp_path, "mlp") + [
        "--cost_capture_scan_rounds", "3"])
    (path,) = glob.glob(str(tmp_path / "ck" / "**" / "program_costs.json"),
                        recursive=True)
    programs = json.load(open(path))["programs"]
    assert programs["rounds_scan[3]"]["flops"] == \
        3 * programs["round"]["flops"] > 0


def test_the_port_names_its_console_script():
    text = open(os.path.join(REPO, "pyproject.toml")).read()
    assert 'fedtorch-tpu-torch = "fedtorch_tpu_torch.cli:main"' in text
