"""The port's command line against the JAX package's on the fault planes,
on the CPU.

* ``--fault_client_drop_rate 1.0``: every dispatched client crashes, so
  the server holds. From the JAX run's initial weights, both CLIs log the
  same ``faults`` line (``dropped = k``) and all-rejected line every
  round, and return the same rounds and a test top-1 within 1/128 (the
  held model's evaluation in two frameworks).
* The DP budget lifecycle, sized as the JAX package's slow-lane drill
  (``tests/test_privacy.py``: q 0.5, 6 rounds, a budget of 3 rounds'
  epsilon x 1.0001): ``stop`` ends at the last affordable round and
  ``degrade`` finishes noise-free, with ``results["dp"]`` equal in
  ``charged_rounds``, ``exhausted`` and ``degraded`` and the epsilon
  within 1e-12, and the same exhaustion round. The accountant charges
  what the rounds' participation says, whatever either package's noise
  draws, so the two runs compare at these rates.
* ``--avail_quorum_action abort`` without ``--supervisor`` stays
  refused by the config, by name (with it, it runs:
  ``tests/test_torch_supervisor.py``).
"""
import glob
import re

import pytest

import torch_threads  # noqa: F401 (two torch threads a worker)
from fedtorch_tpu import cli as jcli
from fedtorch_tpu.robustness.privacy import PrivacyAccountant
from fedtorch_tpu_torch import cli as tcli
from test_torch_cli import _TRAIN, _synthetic_argv

_FAULTS = re.compile(r"Round \d+: faults — .*")
_HELD = re.compile(r"Round \d+: guards rejected EVERY update.*")


def _log(root):
    (record,) = glob.glob(str(root / "synthetic" / "mlp" / "*" / "record0"))
    return open(record).read()


def _bridge_init(monkeypatch, argv):
    """The port's trainer on the JAX CLI's initial weights (the plans
    stay the port's: at a crash rate of 1 every draw crashes)."""
    import jax
    from fedtorch_tpu.algorithms import make_algorithm as jmake
    from fedtorch_tpu.data import build_federated_data as jbuild
    from fedtorch_tpu.models import define_model as jdefine
    from fedtorch_tpu.parallel import FederatedTrainer as JTrainer
    from fedtorch_tpu_torch.bridge import params_from_jax
    from fedtorch_tpu_torch.parallel import FederatedTrainer
    from test_torch_zoo import _flat

    jc = jcli.args_to_config(jcli.build_parser().parse_args(argv))
    jtr = JTrainer(jc, jdefine(jc, batch_size=jc.data.batch_size),
                   jmake(jc), jbuild(jc).train)
    js, _ = jtr.init_state(jax.random.key(jc.train.manual_seed))
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


def test_every_client_crashes_and_both_clis_hold_the_server(tmp_path,
                                                             monkeypatch):
    base = _synthetic_argv(tmp_path, "mlp", rounds=2)
    words = ["--fault_client_drop_rate", "1.0"]
    want = jcli.main(base[:-2] + ["-c", str(tmp_path / "jax")] + words)
    _bridge_init(monkeypatch, base + words)
    got = tcli.main(base + words)
    assert got["rounds"] == 2
    for key in ("test_top1", "best_top1"):
        assert abs(got[key] - want[key]) <= 1.0 / 128, (key, got, want)
    jlog, tlog = _log(tmp_path / "jax"), _log(tmp_path / "ck")
    assert _TRAIN.findall(tlog) == _TRAIN.findall(jlog) == ["0", "1"]
    faults = _FAULTS.findall(tlog)
    assert faults == _FAULTS.findall(jlog) and len(faults) == 2
    assert all("dropped=4 " in line for line in faults)  # k = 4 of 8
    assert _HELD.findall(tlog) == _HELD.findall(jlog) != []


@pytest.mark.parametrize("action", ["stop", "degrade"])
def test_dp_budget_lifecycle_matches_the_jax_cli(action, tmp_path):
    q, rounds, half = 0.5, 6, 3
    affordable = PrivacyAccountant(1.0, 1e-5)
    affordable.charge(q, rounds=half)
    budget = affordable.epsilon() * 1.0001
    base = _synthetic_argv(tmp_path, "mlp", rounds=rounds)
    base[base.index("--eval_freq") + 1] = str(rounds)
    words = ["--dp_noise_multiplier", "1.0", "--dp_clip_norm", "0.5",
             "--dp_delta", "1e-5", "--dp_epsilon_budget", repr(budget),
             "--dp_budget_action", action]
    want = jcli.main(base[:-2] + ["-c", str(tmp_path / "jax")] + words)
    got = tcli.main(base + words)
    for key in ("charged_rounds", "exhausted", "degraded", "delta"):
        assert got["dp"][key] == want["dp"][key], key
    e, w = got["dp"]["epsilon_spent"], want["dp"]["epsilon_spent"]
    assert abs(e - w) <= 1e-12 * w
    assert got["dp_exhausted_at_round"] == want["dp_exhausted_at_round"] \
        == half
    trained = [str(r) for r in range(half if action == "stop" else rounds)]
    jlog, tlog = _log(tmp_path / "jax"), _log(tmp_path / "ck")
    assert _TRAIN.findall(tlog) == _TRAIN.findall(jlog) == trained
    assert got["rounds"] == len(trained)
    assert got["dp"]["charged_rounds"] == half
    assert got["dp"]["degraded"] == (action == "degrade")
    assert "privacy budget exhausted before round 3" in tlog


@pytest.mark.parametrize("words, name", [
    (["--avail_quorum_frac", "0.5", "--avail_quorum_action", "abort"],
     "supervisor"),
])
def test_quorum_abort_stays_refused_by_name(words, name, tmp_path):
    with pytest.raises(ValueError, match=re.escape(name)):
        tcli.main(_synthetic_argv(tmp_path, "mlp") + words)
