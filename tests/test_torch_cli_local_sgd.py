"""The port's command line against the JAX package's in local-SGD mode
(``--federated false``), on the CPU.
"""

import numpy as np
import pytest

import torch_threads  # noqa: F401 (two torch threads a worker)
from fedtorch_tpu import cli as jcli
from fedtorch_tpu_torch import cli as tcli


@pytest.mark.parametrize("words", [
    [],
    ["--local_step_warmup_type", "linear", "--local_step_warmup_period",
     "2", "--reshuffle_per_epoch", "true"],
], ids=["plain", "warmup_reshuffle"])
def test_local_sgd_cpu_run_returns_the_jax_cli_s_results(words, tmp_path,
                                                         monkeypatch):
    """``--federated false``: the pooled training set re-partitioned over
    the workers, ``fit`` to the epoch count, one test evaluation. From
    the JAX CLI's weights and each round's draws (at that round's K):
    the JAX package's results dict, its keys and its round count, and
    the test top-1 within 1/128."""
    import jax
    from fedtorch_tpu.data import build_federated_data as jbuild
    from fedtorch_tpu.models import define_model as jdefine
    from fedtorch_tpu.parallel.local_sgd import build_local_sgd as j_build
    from test_torch_local_sgd import bridge_jax_weights, replay_jax_plans

    argv = ["--backend", "cpu", "-f", "false", "-d", "synthetic", "-a",
            "mlp", "--num_workers", "4", "--num_epochs", "3",
            "--local_step", "4", "-b", "16", "--lr", "0.1",
            "--mlp_hidden_size", "32", "--debug", "false"] + words
    want = jcli.main(argv + ["-c", str(tmp_path / "jax")])
    jc = jcli.args_to_config(jcli.build_parser().parse_args(argv))
    train = jbuild(jc).train
    x, y = np.asarray(train.x), np.asarray(train.y)
    jtr = j_build(jc, jdefine(jc, batch_size=jc.data.batch_size),
                  x.reshape((-1,) + x.shape[2:]), y.reshape(-1))
    js, _ = jtr.init_state(jax.random.key(jc.train.manual_seed))
    bridge_jax_weights(monkeypatch, js)
    replay_jax_plans(monkeypatch, js)
    got = tcli.main(argv + ["-c", str(tmp_path / "ck")])
    assert set(got) == set(want) == {"test_top1", "rounds"}
    assert got["rounds"] == want["rounds"] > 1
    assert abs(got["test_top1"] - want["test_top1"]) <= 1.0 / 128, (got,
                                                                    want)
