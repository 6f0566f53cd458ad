"""The port's command line against the JAX package's on the personalized
algorithms, on the CPU: the results dict and each round's
``validation_personal`` line from the JAX run's weights and draws.
"""
import glob
import re

import pytest

import torch_threads  # noqa: F401 (two torch threads a worker)
from fedtorch_tpu import cli as jcli
from fedtorch_tpu_torch import cli as tcli
from test_torch_cli import _replay_the_jax_run, _synthetic_argv


_PERSONAL = re.compile(r"Round: (\d+)\. Mode: validation_personal\. Loss: "
                       r"([\d.]+) \| top1: ([\d.]+)")


def _personal_lines(root):
    (record,) = glob.glob(str(root / "synthetic" / "mlp" / "*" / "record0"))
    return [(int(r), float(loss), float(top1))
            for r, loss, top1 in _PERSONAL.findall(open(record).read())]


@pytest.mark.parametrize("words", [
    ["--federated_type", "apfl", "--fed_adaptive_alpha", "true"],
    ["--federated_type", "perfedme", "--lr", "0.05"],
    ["--federated_type", "perfedavg", "--perfedavg_beta", "0.05"],
    ["--federated_type", "apfl", "--quantized", "true"],
    ["--fed_personal", "true"],
], ids=["apfl", "perfedme", "perfedavg", "apfl_quantized",
        "fedavg_fed_personal"])
def test_personalized_cpu_run_returns_the_jax_cli_s_results(
        words, tmp_path, monkeypatch):
    """The personalized algorithms (and FedAvg with the val split) on one
    command line in both CLIs, from the same weights and draws: the
    results dict as for the zoo, and each round's
    ``validation_personal`` line (the three algorithms only) at the
    JAX line's printed digits (loss within 1e-5 relative, top-1 within
    1/128)."""
    base = _synthetic_argv(tmp_path, "mlp")
    argv = base + words
    want = jcli.main(base[:-2] + ["-c", str(tmp_path / "jax")] + words)
    _replay_the_jax_run(monkeypatch, argv, 3)
    got = tcli.main(argv)
    assert got["rounds"] == 3
    for key in ("test_top1", "best_top1"):
        assert abs(got[key] - want[key]) <= 1.0 / 128, (key, got, want)
    jlines = _personal_lines(tmp_path / "jax")
    tlines = _personal_lines(tmp_path / "ck")
    assert [r for r, _, _ in tlines] == [r for r, _, _ in jlines] == (
        [] if words == ["--fed_personal", "true"] else [0, 1, 2])
    for (_, tl, ta), (_, jl, ja) in zip(tlines, jlines):
        assert abs(tl - jl) <= 1e-5 * jl + 1e-6, (tl, jl)
        assert abs(ta - ja) <= 1.0 / 128, (ta, ja)
