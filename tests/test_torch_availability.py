"""The availability plane in the port against the JAX package, on the CPU.

* **Exact**: ``sync_lifecycle``'s decisions (accept, dropped,
  deadline_miss) under both models, with dropout, over-selection and a
  closing deadline, fed the JAX lifecycle's own uniforms (its
  per-client folds off the round key and, for the trace model, the
  classes off the run key), and ``_class_draw``'s. The trace model's
  ``_offness`` is a float32 ``cos`` on both sides, XLA's and torch's: a
  dropout uniform within an ulp of its probability could flip, so the
  bar is exact decisions except where ``|u - p| < 1e-6``, a count the
  test reads and that must be 0 on its seeds.
* ``finish`` of both async models: bitwise the JAX package's float64
  host math on the same columns.
* **rounds**: a round each of the ``default`` model (dropout, a quorum)
  and the ``trace`` model (diurnal, dropout, a quorum), both with
  over-selection, against the JAX round on its plans and uniforms
  (``test_torch_chaos.py``'s harness), every counter equal.
* the sync lifecycle's part of the JAX package's
  ``test_availability.py`` on the port: seeded replay, over-selection
  widening the dispatch and not the acceptance, every sync cell
  (resident and stream rounds, the resident scan) bitwise to each
  other, an all-dropped round holding the server, the disarmed
  counters at 0, the config's refusals.
* ``metrics_width``: under ``'sparse'`` with over-selection the JAX
  round emits ``[k_dispatch]`` per-client leaves while its
  ``metrics_width`` says ``k_online``; the port's leaves have the JAX
  round's shape and its ``metrics_width`` names it.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401 (two torch threads a worker)
from fedtorch_tpu import config as jcfg
from fedtorch_tpu.robustness import availability as javail
from fedtorch_tpu_torch import config as tcfg
from fedtorch_tpu_torch.algorithms import make_algorithm as tmake
from fedtorch_tpu_torch.data import build_federated_data
from fedtorch_tpu_torch.models import define_model as tdefine
from fedtorch_tpu_torch.parallel import FederatedTrainer
from fedtorch_tpu_torch.robustness import availability as tavail
from test_torch_chaos import (
    _fault_plans, _run_rounds, _t, _trainers,
)

ARMED = dict(avail_model="trace", avail_dropout_rate=0.3,
             avail_diurnal_period=8, over_select_frac=1.5,
             avail_quorum_frac=0.5)


def _uniforms(rng_round, idx, flt):
    ukey = jax.random.fold_in(rng_round, javail.AVAIL_SYNC_SALT)
    u = jax.vmap(lambda c: jax.random.uniform(
        jax.random.fold_in(ukey, c), (2,)))(idx)
    dkey = jax.random.fold_in(rng_round, javail.AVAIL_DROP_SALT)
    ud = jax.vmap(lambda c: jax.random.uniform(
        jax.random.fold_in(dkey, c), ()))(idx)
    return _t(u), _t(ud)


def _classes(server_rng, idx):
    ckey = jax.random.fold_in(server_rng, javail.AVAIL_CLASS_SALT)
    return _t(jax.vmap(lambda c: jax.random.uniform(
        jax.random.fold_in(ckey, c), (2,)))(idx))


LIFECYCLES = {
    "default_dropout": dict(avail_dropout_rate=0.3, over_select_frac=1.5),
    "default_straggler_tail": dict(straggler_rate=0.4,
                                   straggler_step_frac=0.25,
                                   over_select_frac=2.0),
    "default_no_dropout": dict(over_select_frac=1.25),
    "trace_flat": dict(avail_model="trace", avail_dropout_rate=0.2,
                       over_select_frac=1.5),
    "trace_diurnal": dict(avail_model="trace", avail_dropout_rate=0.4,
                          avail_diurnal_period=6, over_select_frac=1.5),
    "trace_all_dropped": dict(avail_model="trace", avail_dropout_rate=1.0,
                              avail_diurnal_period=2, over_select_frac=1.0,
                              avail_quorum_frac=0.5),
}


@pytest.mark.parametrize("case", sorted(LIFECYCLES))
def test_sync_lifecycle_decides_as_the_jax_package(case):
    """Over seeds and rounds: the port's (accept, dropped, deadline_miss)
    on the JAX uniforms equal the JAX lifecycle's; a dropout uniform
    within 1e-6 of its probability would be excused, and none is."""
    kw = LIFECYCLES[case]
    jf, tf = jcfg.FaultConfig(**kw), tcfg.FaultConfig(**kw)
    k_online, C = 8, 64
    k = max(math.ceil(jf.over_select_frac * k_online), k_online)
    near = 0
    for seed in range(6):
        server_rng = jax.random.key(seed)
        idx = jax.random.permutation(jax.random.key(100 + seed), C)[:k]
        for r in range(4):
            rng_round = jax.random.fold_in(server_rng, r)
            want = javail.sync_lifecycle(server_rng, rng_round, idx,
                                         jnp.int32(r), jf, k_online)
            u, ud = _uniforms(rng_round, idx, jf)
            drop_drawn = jf.avail_model == "trace" \
                or jf.avail_dropout_rate > 0
            cls = _classes(server_rng, idx) \
                if jf.avail_model == "trace" else None
            got = tavail.sync_lifecycle(u, ud if drop_drawn else None, cls,
                                        r, tf, k_online)
            if cls is not None:
                _, phase = tavail._class_draw(cls)
                off = tavail._offness(r, phase, tf.avail_diurnal_period)
                p = torch.clamp(2.0 * tf.avail_dropout_rate * off, 0, 1)
                near += int(((ud - p).abs() < 1e-6).sum())
            for w, g in zip(want, got):
                np.testing.assert_array_equal(g.numpy(), np.asarray(w))
            assert int(got[0].sum()) <= k_online
    assert near == 0


def test_class_draw_on_the_jax_uniforms():
    key = jax.random.key(3)
    idx = jnp.arange(200, dtype=jnp.int32)
    mult, phase = javail._class_draw(key, idx)
    got_m, got_p = tavail._class_draw(_classes(key, idx))
    np.testing.assert_array_equal(got_m.numpy(), np.asarray(mult))
    np.testing.assert_array_equal(got_p.numpy(), np.asarray(phase))
    assert set(got_m.tolist()) == {1.0, 2.0, 4.0}


@pytest.mark.parametrize("model", ["default", "default_dropout", "trace"])
def test_finish_is_the_jax_float64_host_math(model):
    rng = np.random.RandomState(4)
    versions = rng.randint(0, 30, 64).astype(np.float64)
    if model == "trace":
        kw = dict(dropout_rate=0.3, diurnal_period=7, jitter=0.25)
        u = np.stack([rng.rand(64), rng.choice([1.0, 2.0, 4.0], 64),
                      rng.rand(64), rng.rand(64)], axis=1)
        pair = javail.TraceAvailability(**kw), tavail.TraceAvailability(**kw)
    else:
        drop = 0.2 if model == "default_dropout" else 0.0
        kw = dict(straggler_rate=0.3, straggler_step_frac=0.5,
                  dropout_rate=drop)
        u = rng.rand(64, 3 if drop else 2)
        pair = javail.DefaultAvailability(**kw), \
            tavail.DefaultAvailability(**kw)
    want, got = (m.finish(u, versions) for m in pair)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)


def test_make_availability_model_and_synthesized_trace():
    f = tcfg.FaultConfig(avail_model="trace", avail_dropout_rate=0.1,
                         avail_diurnal_period=24)
    assert isinstance(tavail.make_availability_model(f),
                      tavail.TraceAvailability)
    assert isinstance(tavail.make_availability_model(tcfg.FaultConfig()),
                      tavail.DefaultAvailability)
    trace = tavail.synthesize_trace(7, 1000, 24)
    fracs = np.bincount(trace["class_id"], minlength=3) / 1000.0
    np.testing.assert_allclose(fracs, [0.5, 0.3, 0.2], atol=0.05)
    again = tavail.synthesize_trace(7, 1000, 24)
    assert np.array_equal(trace["speed_multiplier"],
                          again["speed_multiplier"])
    # the model's columns carry the same fleet
    cols = tavail.make_availability_model(f).columns(
        7, np.arange(5), np.arange(5), np.zeros(5))
    np.testing.assert_array_equal(cols[:, 1],
                                  trace["speed_multiplier"][:5])


ROUND_CASES = {
    "default": dict(avail_dropout_rate=0.3, over_select_frac=1.5,
                    avail_quorum_frac=0.9),
    "trace": dict(ARMED, guard_updates=True, robust_agg="median"),
}


@pytest.mark.parametrize("case", sorted(ROUND_CASES))
def test_round_matches_the_jax_round(case, monkeypatch):
    """Over-selected rounds on the JAX plans, uniforms and classes:
    the state within ``test_torch_zoo.py``'s bar, every counter equal
    (rolled-back dropouts, kept deadline misses)."""
    jtr, *_, jm, ttr, ts, tcl, tm = _run_rounds(
        ROUND_CASES[case], rounds=2, monkeypatch=monkeypatch)
    assert ttr.k_dispatch == jtr.k_dispatch > ttr.k_online
    assert tm.online_mask.shape == (ttr.num_clients,)


# -- the sync lifecycle's part of test_availability.py, on the port ----------

def _cfg(fault, plane="device", mode="perm", rate=0.5):
    return tcfg.ExperimentConfig(
        data=tcfg.DataConfig(dataset="synthetic", synthetic_dim=20,
                             batch_size=16, synthetic_alpha=0.5,
                             synthetic_beta=0.5, data_plane=plane),
        federated=tcfg.FederatedConfig(
            federated=True, num_clients=8, num_comms=6,
            online_client_rate=rate, algorithm="fedavg",
            sync_type="local_step", participation_mode=mode),
        model=tcfg.ModelConfig(arch="logistic_regression"),
        optim=tcfg.OptimConfig(lr=0.3, weight_decay=0.0),
        train=tcfg.TrainConfig(local_step=2),
        fault=fault).finalize()


def _trainer(fault, **kw):
    cfg = _cfg(fault, **kw)
    data = build_federated_data(cfg)
    t = FederatedTrainer(cfg, tdefine(cfg, batch_size=16, device="cpu"),
                         tmake(cfg), data.train, device="cpu")
    t.stream_timeout_s = 20.0
    return t


def _bytes(tree):
    return [v.numpy().tobytes() for v in tree.values()]


def test_counters_replay():
    flt = tcfg.FaultConfig(robust_agg="median", guard_updates=True, **ARMED)

    def run():
        t = _trainer(flt)
        s, c = t.init_state(0)
        totals = dict.fromkeys(("avail_dropped", "deadline_missed",
                                "quorum_degraded"), 0.0)
        for _ in range(4):
            s, c, m = t.run_round(s, c)
            for f in totals:
                totals[f] += float(getattr(m, f))
        return _bytes(s.params), totals
    (a, ta), (b, tb) = run(), run()
    assert a == b and ta == tb
    assert ta["avail_dropped"] + ta["deadline_missed"] > 0


def test_over_selection_widens_dispatch_not_acceptance():
    t = _trainer(tcfg.FaultConfig(**ARMED))
    assert t.k_dispatch == math.ceil(1.5 * t.k_online)
    s, c = t.init_state(0)
    for _ in range(3):
        s, c, m = t.run_round(s, c)
        assert float(m.online_mask.sum()) <= t.k_online
        assert float(m.avail_dropped) + float(m.deadline_missed) \
            + float(m.online_mask.sum()) == t.k_dispatch


def test_armed_cells_are_bitwise_each_other():
    """The lifecycle lives in the round core, so the resident round, the
    stream round and the resident scan run it alike: the same params
    and generator state after four rounds."""
    flt = tcfg.FaultConfig(robust_agg="trimmed_mean", **ARMED)
    outs = []
    for plane, scan in (("device", False), ("stream", False),
                        ("device", True)):
        t = _trainer(flt, plane=plane)
        s, c = t.init_state(0)
        if scan:
            for _ in range(2):
                s, c, _ = t.run_rounds(s, c, 2)
        else:
            for _ in range(4):
                s, c, _ = t.run_round(s, c)
        t.close()
        outs.append((_bytes(s.params), s.rng.get_state()))
    for p, g in outs[1:]:
        assert p == outs[0][0] and torch.equal(g, outs[0][1])


def test_all_dropped_round_degrades_and_holds_server():
    flt = tcfg.FaultConfig(avail_dropout_rate=1.0, over_select_frac=1.5,
                           avail_quorum_frac=0.9)
    t = _trainer(flt)
    s, c = t.init_state(0)
    p0 = _bytes(s.params)
    s, c, m = t.run_round(s, c)
    assert _bytes(s.params) == p0 and s.round == 1
    assert float(m.quorum_degraded) == 1.0
    assert float(m.avail_dropped) == t.k_dispatch
    assert float(m.online_mask.sum()) == 0.0


def test_disarmed_counters_stay_zero():
    t = _trainer(tcfg.FaultConfig())
    s, c = t.init_state(0)
    _, _, m = t.run_round(s, c)
    for f in ("avail_dropped", "deadline_missed", "quorum_degraded"):
        assert float(getattr(m, f)) == 0.0
    assert t.k_dispatch == t.k_online


def test_config_refusals():
    with pytest.raises(ValueError, match="supervisor"):
        _cfg(tcfg.FaultConfig(avail_quorum_frac=0.5,
                              avail_quorum_action="abort"))
    with pytest.raises(ValueError, match="avail_model"):
        _cfg(tcfg.FaultConfig(avail_model="fedscale"))
    with pytest.raises(ValueError, match="avail_quorum_frac"):
        _cfg(tcfg.FaultConfig(avail_quorum_frac=1.5))
    with pytest.raises(ValueError, match="over_select_frac"):
        _cfg(tcfg.FaultConfig(over_select_frac=5.0))


# -- metrics_width under over-selection ---------------------------------------

def test_sparse_leaves_have_the_jax_round_s_width():
    """'sparse' with over-selection: the JAX round's per-client leaves
    are [k_dispatch] although its metrics_width says k_online; on the
    JAX plan and uniforms the port's leaves have the JAX round's shape
    and values, and its metrics_width names that width."""
    fault = dict(avail_dropout_rate=0.3, over_select_frac=1.5)
    jtr, js, jcl, ttr, ts, tcl = _trainers(fault, mode="sparse")
    plan, = _fault_plans(jtr, js, 1, ttr)
    _, _, jm = jtr.run_round(js, jcl)
    _, _, tm = ttr.round_fn(ts, tcl, plan)
    assert jtr.metrics_width == jtr.k_online == 5
    assert ttr.metrics_width == ttr.k_dispatch == jtr.k_dispatch == 8
    for f in ("online_mask", "train_loss", "train_acc"):
        want, got = np.asarray(getattr(jm, f)), getattr(tm, f).numpy()
        assert want.shape == got.shape == (ttr.metrics_width,), f
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)
    np.testing.assert_array_equal(tm.online_mask.numpy(),
                                  np.asarray(jm.online_mask))
