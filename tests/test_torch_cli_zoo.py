"""The port's command line against the JAX package's on the algorithm zoo
(and the robust rules and update guards), on the CPU: from the JAX run's
weights and draws (``test_torch_cli.py``'s ``_replay_the_jax_run``), the
results dict's test and best top-1 within 1/128 and the same rounds.
"""

import pytest

import torch_threads  # noqa: F401 (two torch threads a worker)
from fedtorch_tpu import cli as jcli
from fedtorch_tpu_torch import cli as tcli
from test_torch_cli import _replay_the_jax_run, _synthetic_argv


@pytest.mark.parametrize("words", [
    ["--federated_type", "scaffold"],
    ["--federated_type", "fedgate", "--compressed", "true",
     "--compressed_ratio", "0.5"],
    ["--federated_type", "qsparse", "--compressed_ratio", "0.5"],
    ["--federated_type", "qffl", "--qffl_q", "1.0"],
    ["--federated_type", "afl"],
    ["--federated_type", "fedgate", "--federated_drfa", "true",
     "--drfa_gamma", "0.2"],
    ["--robust_agg", "median", "--guard_updates", "true"],
    ["--robust_agg", "norm_bound", "--robust_norm_tau", "1.5",
     "--guard_updates", "true", "--guard_mode", "clip",
     "--guard_norm_multiplier", "2.0"],
    ["-a", "robust_logistic_regression", "--robust_agg", "trimmed_mean",
     "--robust_trim_frac", "0.25"],
], ids=["scaffold", "fedgate_topk", "qsparse", "qffl", "afl",
        "drfa_fedgate", "median_guards", "norm_bound_clip",
        "robust_lr_trimmed_mean"])
def test_zoo_cpu_run_returns_the_jax_cli_s_results(words, tmp_path,
                                                   monkeypatch):
    """The port's CLI and the JAX package's on one command line: from the
    same weights and draws, the results dict's test and best top-1
    within 1/128 (the matrix products sum in other orders; the logs agree
    at their printed digits) and the same rounds."""
    base = _synthetic_argv(tmp_path, "mlp")
    argv = base + words
    want = jcli.main(base[:-2] + ["-c", str(tmp_path / "jax")] + words)
    _replay_the_jax_run(monkeypatch, argv, 3)
    got = tcli.main(argv)
    assert got["rounds"] == 3
    for key in ("test_top1", "best_top1"):
        assert abs(got[key] - want[key]) <= 1.0 / 128, (key, got, want)
