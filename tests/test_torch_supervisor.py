"""The port's round supervisor (``robustness/supervisor.py``) and model
diagnostics (``utils/diagnostics.py``), mirroring the JAX package's
``test_fault_injection.py`` ``TestSupervisor`` and ``TestDiagnostics``,
on the CPU.

* A rollback restores what the round wrote in place: after a round whose
  every attempt diverged (nan poison on every client, guards off) the
  whole client state and the server are bitwise the pre-round state
  (sha256 of the bytes), on both data planes, although each reseeded
  retry dispatched another cohort; the generator stands where the first
  attempt's plan draw left it.
* The round after a skip draws afresh and can commit: it dispatches
  another cohort than the skipped round's first attempt, comes out
  healthy, and equals, bitwise, a plain round from the pre-round state
  whose generator made that one plan draw, on both planes. A skip whose
  rollback fell back to the on-disk checkpoint keeps that checkpoint's
  generator.
* A retry is the port's reseed replayed: a round whose first attempt is
  made to diverge equals, bitwise, a plain round from the pre-round
  state with the generator ``reseeded_generator(state, 1)``.
* A round that raises on every attempt re-raises its own exception; so
  does one that raises on one attempt and diverges on another, in either
  order; a host seam's error that a retry outlives commits the round.
* ``model_norms`` and ``aggregation_tracking`` against the JAX package's
  on the same float32 params (relative 1e-6: two frameworks' sums).
* ``--avail_quorum_action abort`` runs under ``--supervisor`` and counts
  its sub-quorum skips.
"""
import math

import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401 (two torch threads a worker)
from fedtorch_tpu_torch import cli as tcli
from fedtorch_tpu_torch.config import FaultConfig
from fedtorch_tpu_torch.robustness.supervisor import (
    RoundSupervisor, reseeded_generator,
)
from fedtorch_tpu_torch.utils.diagnostics import (
    aggregation_tracking, check_finite, model_norms, runtime_snapshot,
)
from torch_lifecycle import cli_argv, make_trainer, state_digest


def _sup(trainer, **fault):
    flt = FaultConfig(**dict(dict(max_retries=2, backoff_base_s=0.0),
                             **fault))
    return RoundSupervisor(trainer, fault=flt, sleep_fn=lambda s: None)


@pytest.mark.parametrize("plane", ["device", "stream"])
def test_rollback_restores_every_written_row_bit_exactly(plane):
    t = make_trainer(plane=plane, fault=dict(nan_inject_rate=1.0))
    try:
        sup = _sup(t, nan_inject_rate=1.0)
        s, c = t.init_state(0)
        s, c, _ = t.run_round(s, c)  # a round of state to protect
        t.invalidate_stream()
        before = state_digest(s, c)
        pre_rng = s.rng.get_state()
        cohorts = []
        orig = t.run_round

        def spy(server, clients):
            cohorts.append(sup._dispatched(server)[0].tolist())
            return orig(server, clients)

        t.run_round = spy
        s2, c2, m = sup.run_round(s, c)
        assert len(cohorts) == 3 and len({tuple(x) for x in cohorts}) > 1
        assert sup.stats.skipped_rounds == sup.stats.skipped_fault == 1
        assert sup.stats.rollbacks == 3 and sup.stats.retries == 2
        assert s2.round == s.round + 1
        pre = torch.Generator()
        pre.set_state(pre_rng)
        assert state_digest(s2._replace(round=s.round, rng=pre),
                            c2) == before
        # the generator moved on by the first attempt's plan draw
        t.plan_drawer()(pre, s.round, t._alg_aux(s.aux))
        assert torch.equal(s2.rng.get_state(), pre.get_state())
        assert float(m.online_mask.sum()) == 0.0
        assert m.online_mask.shape == (t.metrics_width,)
    finally:
        t.close()


def _poisoned(params):
    return {k: v * math.nan for k, v in params.items()}


@pytest.mark.parametrize("plane", ["device", "stream"])
def test_the_round_after_a_skip_draws_afresh_and_can_commit(plane):
    t = make_trainer(plane=plane)
    try:
        orig = t.run_round
        calls = {"n": 0}

        def first_round_diverges(server, clients):
            s, c, m = orig(server, clients)
            calls["n"] += 1
            if calls["n"] <= 3:  # every attempt of the first round
                s = s._replace(params=_poisoned(s.params))
            return s, c, m

        t.run_round = first_round_diverges
        sup = _sup(t)
        s, c = t.init_state(0)
        skipped = sup._dispatched(s)[0].tolist()
        s, c, _ = sup.run_round(s, c)
        assert sup.stats.skipped_rounds == 1 and s.round == 1
        assert sup._dispatched(s)[0].tolist() != skipped
        s, c, _ = sup.run_round(s, c)
        assert (sup.stats.rollbacks, sup.stats.healthy_rounds,
                calls["n"]) == (3, 1, 4)
        assert s.round == 2 and check_finite(s.params)
        # the replay: the pre-round state, one plan draw, round index 1
        r = make_trainer()
        s0, c0 = r.init_state(0)
        r.draw_plan(s0)
        s1, c1, _ = r.run_round(s0._replace(round=1), c0)
        assert state_digest(s, c) == state_digest(s1, c1)
    finally:
        t.close()


def test_a_skip_from_the_disk_keeps_the_checkpoint_s_generator(tmp_path):
    from fedtorch_tpu_torch.utils.checkpoint import save_checkpoint
    t = make_trainer(fault=dict(nan_inject_rate=1.0))
    s, c = t.init_state(0)
    saved = s.rng.get_state()
    save_checkpoint(str(tmp_path), s, c, t.cfg, 0.0, False)
    # a caller that hands in diverged state: the snapshot is sick too
    s = s._replace(params=_poisoned(s.params))
    sup = RoundSupervisor(t, fault=FaultConfig(
        nan_inject_rate=1.0, max_retries=1, backoff_base_s=0.0),
        checkpoint_dir=str(tmp_path), sleep_fn=lambda s: None)
    s2, _, _ = sup.run_round(s, c)
    assert sup.stats.disk_restores >= 1 and sup.stats.skipped_rounds == 1
    assert s2.round == 1 and check_finite(s2.params)
    assert torch.equal(s2.rng.get_state(), saved)


def test_forced_divergence_retries_on_the_reseeded_generator():
    t = make_trainer()
    orig = t.run_round
    calls = {"n": 0}

    def flaky(server, clients):
        s, c, m = orig(server, clients)
        calls["n"] += 1
        if calls["n"] == 1:
            s = s._replace(params=_poisoned(s.params))
        return s, c, m

    t.run_round = flaky
    sup = _sup(t)
    s, c = t.init_state(0)
    state = s.rng.get_state()
    s2, c2, _ = sup.run_round(s, c)
    assert (sup.stats.rollbacks, sup.stats.retries,
            sup.stats.skipped_rounds, calls["n"]) == (1, 1, 0, 2)
    assert check_finite(s2.params) and s2.round == 1
    # the replay: a plain round from the pre-round state on the reseed
    r = make_trainer()
    s0, c0 = r.init_state(0)
    s0 = s0._replace(rng=reseeded_generator(state, 1))
    s1, c1, _ = r.run_round(s0, c0)
    assert state_digest(s2, c2) == state_digest(s1, c1)


def test_reseed_is_a_pure_function_of_state_and_attempt():
    g = torch.Generator().manual_seed(3)
    state = g.get_state()
    a = reseeded_generator(state, 1).get_state()
    assert torch.equal(a, reseeded_generator(state, 1).get_state())
    assert not torch.equal(a, reseeded_generator(state, 2).get_state())
    assert not torch.equal(a, state)


class KernelLaunchFailed(RuntimeError):
    pass


def test_persistent_exception_reraises_as_itself():
    t = make_trainer()

    def boom(server, clients):
        raise KernelLaunchFailed("qdq_ragged_stats_f32 failed to launch")

    t.run_round = boom
    sup = _sup(t, max_retries=1)
    s, c = t.init_state(0)
    with pytest.raises(KernelLaunchFailed, match="qdq_ragged"):
        sup.run_round(s, c)
    assert sup.stats.rollbacks == 2 and sup.stats.skipped_rounds == 0


@pytest.mark.parametrize("order", [("diverge", "raise"),
                                   ("raise", "diverge")])
def test_a_raise_beside_a_divergence_reraises_as_itself(order):
    t = make_trainer()
    orig = t.run_round
    calls = {"n": 0}

    def attempt(server, clients):
        what = order[calls["n"]]
        calls["n"] += 1
        if what == "raise":
            raise KernelLaunchFailed("qdq_ragged_apply_f32 failed to launch")
        s, c, m = orig(server, clients)
        return s._replace(params=_poisoned(s.params)), c, m

    t.run_round = attempt
    sup = _sup(t, max_retries=1)
    s, c = t.init_state(0)
    with pytest.raises(KernelLaunchFailed, match="qdq_ragged"):
        sup.run_round(s, c)
    assert calls["n"] == 2
    assert sup.stats.rollbacks == 2 and sup.stats.skipped_rounds == 0


def test_healthy_rounds_pass_through_with_one_fetch_scalars():
    t = make_trainer()
    sup = _sup(t)
    s, c = t.init_state(0)
    r = make_trainer()
    rs, rc = r.init_state(0)
    for _ in range(3):
        s, c, _ = sup.run_round(s, c)
        rs, rc, _ = r.run_round(rs, rc)
    assert sup.stats.rollbacks == 0 and sup.stats.healthy_rounds == 3
    assert sup.stats.loss_ema is not None and s.round == 3
    assert sup.last_scalars["finite"] == 1.0
    assert sup.last_scalars["loss_sum"] > 0.0
    assert state_digest(s, c) == state_digest(rs, rc)  # untouched


def test_zero_participation_round_does_not_poison_loss_ema():
    t = make_trainer()
    sup = _sup(t)
    s, c = t.init_state(0)
    sup.run_round(s, c)
    ema0 = sup.stats.loss_ema
    assert ema0 is not None and ema0 > 0.0
    sup._note_healthy({"finite": True, "n": 0.0, "loss": 0.0, "round": 2})
    assert sup.stats.loss_ema == ema0
    sup.fault = FaultConfig(loss_blowup_factor=2.0)
    assert sup._healthy({"finite": True, "n": 0.0, "loss": 0.0,
                         "round": 3})


def test_loss_blowup_detection():
    t = make_trainer()
    orig = t.run_round
    calls = {"n": 0}

    def blowup(server, clients):
        s, c, m = orig(server, clients)
        calls["n"] += 1
        if calls["n"] == 2:
            m = m._replace(train_loss=m.train_loss * 1e6)
        return s, c, m

    t.run_round = blowup
    sup = _sup(t, loss_blowup_factor=10.0, max_retries=1)
    s, c = t.init_state(0)
    s, c, _ = sup.run_round(s, c)
    s, c, _ = sup.run_round(s, c)
    assert sup.stats.rollbacks == 1 and sup.stats.healthy_rounds == 2


def test_host_seam_failures_are_counted_per_seam():
    from fedtorch_tpu_torch.robustness.host_recovery import HostSeamError
    t = make_trainer()
    orig = t.run_round
    calls = {"n": 0}

    def flaky(server, clients):
        calls["n"] += 1
        if calls["n"] == 1:
            raise HostSeamError("stream.producer", "producer died")
        return orig(server, clients)

    t.run_round = flaky
    sup = RoundSupervisor(t, fault=FaultConfig(max_retries=2,
                                               backoff_base_s=0.0),
                          sleep_fn=lambda s: None)
    s, c = t.init_state(0)
    s, c, _ = sup.run_round(s, c)
    assert sup.stats.host_seam_failures == {"stream.producer": 1}
    assert (sup.stats.rollbacks, sup.stats.healthy_rounds) == (1, 1)
    assert s.round == 1 and check_finite(s.params)


# -- diagnostics against the JAX package -------------------------------------
def _params():
    rng = np.random.RandomState(0)
    return {"w": rng.randn(5, 7).astype(np.float32),
            "b": rng.randn(7).astype(np.float32)}


def test_model_norms_match_the_jax_package():
    import jax.numpy as jnp
    from fedtorch_tpu.utils.diagnostics import model_norms as jnorms
    p = _params()
    want = jnorms({k: jnp.asarray(v) for k, v in p.items()})
    got = model_norms({k: torch.from_numpy(v) for k, v in p.items()})
    for key in ("l2", "max_abs"):
        assert float(got[key]) == pytest.approx(float(want[key]),
                                                rel=1e-6)
    assert bool(got["all_finite"]) and bool(want["all_finite"])
    p["w"][0, 0] = np.inf
    assert not bool(model_norms({k: torch.from_numpy(v)
                                 for k, v in p.items()})["all_finite"])
    empty = model_norms({})
    assert float(empty["l2"]) == 0.0 and bool(empty["all_finite"])


def test_aggregation_tracking_matches_the_jax_package():
    import jax.numpy as jnp
    from fedtorch_tpu.utils.diagnostics import (
        aggregation_tracking as jtrack,
    )
    old = _params()
    new = {k: v + 0.1 * np.sign(v) for k, v in old.items()}
    want = jtrack({k: jnp.asarray(v) for k, v in old.items()},
                  {k: jnp.asarray(v) for k, v in new.items()})
    got = aggregation_tracking({k: torch.from_numpy(v)
                                for k, v in old.items()},
                               {k: torch.from_numpy(v)
                                for k, v in new.items()})
    for key in ("cosine", "distance", "rel_change"):
        assert float(got[key]) == pytest.approx(float(want[key]),
                                                rel=1e-6), key


def test_runtime_snapshot_reports_the_jax_package_s_keys():
    snap = runtime_snapshot()
    assert {"pid", "threads", "max_rss_kb", "process",
            "local_devices"} <= set(snap)
    assert snap["process"] == "0/1"
    assert snap["local_devices"] == torch.cuda.device_count()


# -- through the CLI -------------------------------------------------------
def test_quorum_abort_runs_under_the_supervisor(tmp_path):
    words = ["--avail_quorum_frac", "1.0", "--avail_quorum_action",
             "abort", "--avail_dropout_rate", "0.5", "--supervisor",
             "true", "--supervisor_max_retries", "1",
             "--supervisor_backoff_base", "0", "--backend", "cpu"]
    res = tcli.main(cli_argv(tmp_path / "run", rounds=3, extra=words))
    sup = res["supervisor"]
    assert sup["rounds"] == 3
    assert sup["skipped_quorum"] >= 1 and sup["skipped_fault"] == 0
    assert sup["skipped_rounds"] == sup["skipped_quorum"]


def test_cli_diagnostics_log_norms_and_aggregation_cosine(tmp_path):
    words = ["--check_model_at_sync", "true", "--track_model_aggregation",
             "true", "--backend", "cpu", "--debug", "false"]
    tcli.main(cli_argv(tmp_path / "run", rounds=2, extra=words))
    text = open(tmp_path / "run" / "record0").read()
    assert text.count("server model l2=") == 2
    assert text.count("aggregation cosine=") == 2
