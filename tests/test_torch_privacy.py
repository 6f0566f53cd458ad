"""The privacy plane in the port against the JAX package, on the CPU.

* **The accountant**: the port's copy against the JAX package's over a
  grid of (noise multiplier, sampling probability, rounds), the
  epsilons bitwise or within 1e-12 relative where a float64 ``log`` /
  ``exp`` order could differ (none does today); ``calibrate_noise_multiplier``;
  the ``state`` / ``save`` / ``load_existing`` round trip, across the two
  packages' files, with its refusals; and the JAX package's
  ``TestAccountant`` on the port.
* **1e-6 relative**: ``dp_clip_payloads`` and its ``clipped_frac``
  (exact), ``dp_add_noise`` with the JAX function's normals injected.
* **rounds**: DP-FedAvg, DP with ``trimmed_mean`` and a degraded round
  (two rounds, the noise scale set to 0 between them on both sides)
  against the JAX round on its plans and normals (``test_torch_chaos.py``'s
  harness), the state within ``test_torch_zoo.py``'s bar, every counter,
  ``dp_clipped_frac`` and ``dp_noise_sigma`` equal.
* the JAX package's ``TestConfigRefusals``, ``TestRadialClipFactoring``
  and the sync cases of ``TestDPRound``, on the port.
"""
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401 (two torch threads a worker)
from fedtorch_tpu.robustness import privacy as jpriv
from fedtorch_tpu_torch import config as tcfg
from fedtorch_tpu_torch.algorithms import make_algorithm as tmake
from fedtorch_tpu_torch.data import build_federated_data
from fedtorch_tpu_torch.models import define_model as tdefine
from fedtorch_tpu_torch.parallel import FederatedTrainer
from fedtorch_tpu_torch.robustness import privacy as tpriv
from fedtorch_tpu_torch.robustness.aggregators import (
    _unit_updates, radial_clip, radial_distances,
)
from test_torch_chaos import _run_rounds, _t

DELTA = 1e-5
DP = dict(dp_noise_multiplier=1.0, dp_clip_norm=0.5, dp_delta=DELTA)


# -- the accountant against the JAX package's --------------------------------

GRID = [(z, q, t) for z in (0.6, 1.1, 2.5) for q in (0.01, 0.1, 0.5, 1.0)
        for t in (1, 17, 300)]


def _close(a, b):
    assert a == b or abs(a - b) <= 1e-12 * abs(b), (a, b)


def test_epsilons_over_a_grid_equal_the_jax_accountant():
    for z, q, t in GRID:
        ja, ta = jpriv.PrivacyAccountant(z, DELTA), \
            tpriv.PrivacyAccountant(z, DELTA)
        ja.charge(q, rounds=t)
        ta.charge(q, rounds=t)
        _close(ta.epsilon(), ja.epsilon())
        _close(ta.preview_epsilon(q, 3), ja.preview_epsilon(q, 3))
        for a in (1.5, 2.0, 7.25, 64.0):
            _close(tpriv.subsampled_gaussian_rdp(q, z, a),
                   jpriv.subsampled_gaussian_rdp(q, z, a))
    assert tpriv.DEFAULT_ORDERS == jpriv.DEFAULT_ORDERS
    _close(tpriv.closed_form_epsilon(1.1, 100, DELTA),
           jpriv.closed_form_epsilon(1.1, 100, DELTA))


def test_calibration_equals_the_jax_accountant():
    for target, rounds, q in ((8.0, 50, 0.5), (2.0, 200, 0.1)):
        _close(tpriv.calibrate_noise_multiplier(target, rounds, q, DELTA),
               jpriv.calibrate_noise_multiplier(target, rounds, q, DELTA))


def test_state_and_files_round_trip_across_the_packages(tmp_path):
    ja, ta = jpriv.PrivacyAccountant(1.0, DELTA), \
        tpriv.PrivacyAccountant(1.0, DELTA)
    for r in range(5):
        assert ja.charge_round(r, 0.5) and ta.charge_round(r, 0.5)
    assert ta.state() == ja.state()
    assert ta.save(str(tmp_path / "port"))
    assert ja.save(str(tmp_path / "jax"))
    for src in ("port", "jax"):
        for mod in (tpriv, jpriv):
            fresh = mod.PrivacyAccountant(1.0, DELTA)
            assert fresh.load_existing(str(tmp_path / src))
            assert fresh.epsilon() == ta.epsilon()
            assert not fresh.charge_round(4, 0.5)
            assert fresh.charge_round(5, 0.5)
    with open(tmp_path / "port" / tpriv.ACCOUNTANT_FILE) as f:
        assert json.load(f)["schema"] == jpriv.ACCOUNTANT_SCHEMA


def test_adopt_refusals_match_the_jax_accountant(tmp_path):
    acc = tpriv.PrivacyAccountant(1.0, DELTA)
    acc.charge_round(0, 0.5)
    acc.save(str(tmp_path))
    for mod in (tpriv, jpriv):
        with pytest.raises(ValueError, match="noise_multiplier"):
            mod.PrivacyAccountant(2.0, DELTA).load_existing(str(tmp_path))
        with pytest.raises(ValueError, match="delta"):
            mod.PrivacyAccountant(1.0, 1e-6).load_existing(str(tmp_path))
        with pytest.raises(ValueError, match="schema"):
            mod.PrivacyAccountant(1.0, DELTA).adopt_state(
                {"schema": "somebody.else/v9"})
        doc = acc.state()
        doc["rdp"] = doc["rdp"][:3]
        with pytest.raises(ValueError, match="torn"):
            mod.PrivacyAccountant(1.0, DELTA).adopt_state(doc)
    (tmp_path / "bad").mkdir()
    (tmp_path / "bad" / tpriv.ACCOUNTANT_FILE).write_text("{not json")
    with pytest.raises(ValueError, match="unreadable"):
        tpriv.PrivacyAccountant(1.0, DELTA).load_existing(
            str(tmp_path / "bad"))
    assert not tpriv.PrivacyAccountant(1.0, DELTA).load_existing(
        str(tmp_path / "none"))


# -- the JAX package's TestAccountant, on the port ----------------------------

def test_matches_closed_form_pure_gaussian():
    for z, T in ((1.1, 100), (0.7, 10), (1.0, 50), (2.0, 500)):
        acc = tpriv.PrivacyAccountant(z, DELTA)
        acc.charge(1.0, rounds=T)
        cf = tpriv.closed_form_epsilon(z, T, DELTA)
        assert abs(acc.epsilon() - cf) / cf < 0.01


def test_subsampling_amplifies_and_is_monotone_in_q():
    eps = []
    for q in (0.05, 0.25, 0.5, 1.0):
        acc = tpriv.PrivacyAccountant(1.0, DELTA)
        acc.charge(q, rounds=50)
        eps.append(acc.epsilon())
    assert eps == sorted(eps) and eps[0] < eps[-1] * 0.5


def test_subsampled_rdp_limits_and_fractional_orders():
    assert tpriv.subsampled_gaussian_rdp(0.0, 1.0, 8.0) == 0.0
    assert tpriv.subsampled_gaussian_rdp(1.0, 1.0, 8.0) == \
        tpriv.gaussian_rdp(1.0, 8.0)
    q, z = 0.02, 1.1
    grid = [tpriv.subsampled_gaussian_rdp(q, z, a)
            for a in sorted(tpriv.DEFAULT_ORDERS)]
    assert all(b >= a - 1e-15 for a, b in zip(grid, grid[1:]))
    for alpha in (2.5, 3.25, 5.75, 10.5, 40.125):
        assert tpriv.subsampled_gaussian_rdp(q, z, alpha) < \
            tpriv._integer_subsampled_rdp(q, z, int(math.ceil(alpha)))
    r2 = tpriv._integer_subsampled_rdp(q, z, 2)
    for alpha in (1.125, 1.5, 1.875):
        assert abs(tpriv.subsampled_gaussian_rdp(q, z, alpha) - r2) \
            < 1e-12 * max(r2, 1.0)


def test_charge_round_dedups_and_preview_is_not_spend():
    acc = tpriv.PrivacyAccountant(1.0, DELTA)
    assert acc.epsilon() == 0.0
    assert acc.charge_round(0, 0.5)
    e1 = acc.epsilon()
    assert not acc.charge_round(0, 0.5) and acc.epsilon() == e1
    preview = acc.preview_epsilon(0.5)
    assert preview > e1 and acc.epsilon() == e1
    assert acc.charge_round(1, 0.5)
    assert abs(acc.epsilon() - preview) < 1e-12


def test_invalid_parameters_raise():
    with pytest.raises(ValueError):
        tpriv.PrivacyAccountant(0.0, DELTA)
    with pytest.raises(ValueError):
        tpriv.PrivacyAccountant(1.0, 0.0)
    with pytest.raises(ValueError):
        tpriv.PrivacyAccountant(1.0, DELTA).charge(1.5)
    with pytest.raises(ValueError):
        tpriv.calibrate_noise_multiplier(0.0, 10, 0.5, DELTA)
    with pytest.raises(ValueError):
        tpriv.rdp_to_epsilon((2.0,), (1.0,), 1.5)


# -- the DP stage, against the JAX functions ----------------------------------

def _payloads(seed, k=6):
    rng = np.random.RandomState(seed)
    w = rng.uniform(0.5, 2.0, k).astype(np.float32)
    w[1] = 0.0
    d = {"a": rng.randn(k, 7).astype(np.float32),
         "b": 0.2 * rng.randn(k, 2, 3).astype(np.float32)}
    d["a"][3] *= 10.0
    return {n: v * w.reshape((-1,) + (1,) * (v.ndim - 1))
            for n, v in d.items()}, w


@pytest.mark.parametrize("clip", [0.1, 1.0, 5.0])
def test_dp_clip_payloads_matches_the_jax_function(clip):
    p, w = _payloads(2)
    accept = np.array([1, 1, 0, 1, 1, 1], np.float32)
    jp, jf = jpriv.dp_clip_payloads({n: jnp.asarray(v) for n, v in p.items()},
                                    jnp.asarray(w), jnp.asarray(accept),
                                    clip)
    tp, tf = tpriv.dp_clip_payloads({n: _t(v) for n, v in p.items()},
                                    torch.from_numpy(w),
                                    torch.from_numpy(accept), clip)
    for n in p:
        np.testing.assert_allclose(tp[n].numpy(), np.asarray(jp[n]),
                                   rtol=1e-6, atol=1e-6 * np.abs(p[n]).max())
    assert float(tf) == float(jf)
    _, none = tpriv.dp_clip_payloads({n: _t(v) for n, v in p.items()},
                                     torch.from_numpy(w), None, clip)
    _, jnone = jpriv.dp_clip_payloads(
        {n: jnp.asarray(v) for n, v in p.items()}, jnp.asarray(w), None,
        clip)
    assert float(none) == float(jnone)


def test_dp_add_noise_matches_the_jax_function():
    p, w = _payloads(5)
    s = {n: v.sum(0) for n, v in p.items()}
    rng = jax.random.key(9)
    want = jpriv.dp_add_noise({n: jnp.asarray(v) for n, v in s.items()},
                              rng, jnp.asarray(w), 0.3,
                              jnp.asarray(1.0, jnp.float32))
    key = jax.random.fold_in(rng, jpriv.DP_SALT)
    noise = {n: _t(jax.random.normal(jax.random.fold_in(key, i),
                                     s[n].shape, jnp.float32))
             for i, n in enumerate(sorted(s))}
    got = tpriv.dp_add_noise({n: _t(v) for n, v in s.items()}, None,
                             torch.from_numpy(w), 0.3, torch.tensor(1.0),
                             noise=noise)
    for n in s:
        np.testing.assert_allclose(got[n].numpy(), np.asarray(want[n]),
                                   rtol=1e-6, atol=1e-6)
    off = tpriv.dp_add_noise({n: _t(v) for n, v in s.items()}, 3,
                             torch.from_numpy(w), 0.3, torch.tensor(0.0))
    for n in s:
        assert torch.equal(off[n], _t(s[n]))
    assert tpriv.dp_noise_stddev(1.0, 0.5, 4) == \
        jpriv.dp_noise_stddev(1.0, 0.5, 4) == 0.125


# -- the rounds ---------------------------------------------------------------

def _degrade(jtr, js, ttr, ts):
    return jtr.dp_set_noise_scale(js, 0.0), ttr.dp_set_noise_scale(ts, 0.0)


@pytest.mark.parametrize("case", ["dp", "dp_trimmed_mean", "dp_degraded"])
def test_round_matches_the_jax_round(case):
    fault = dict(DP)
    if case == "dp_trimmed_mean":
        fault.update(robust_agg="trimmed_mean", robust_trim_frac=0.2)
    between = _degrade if case == "dp_degraded" else None
    *_, jm, ttr, ts, tcl, tm = _run_rounds(
        fault, rounds=2 if between else 1, between=between)
    assert float(tm.dp_noise_sigma) == (
        0.0 if between else float(np.float32(1.0 * 0.5 / ttr.k_online)))
    assert set(ts.aux) == {"alg", "dp_noise_scale"}


# -- TestConfigRefusals, TestRadialClipFactoring, TestDPRound, on the port ----

def _cfg(fault, algorithm="fedavg", plane="device"):
    return tcfg.ExperimentConfig(
        data=tcfg.DataConfig(dataset="synthetic", synthetic_dim=20,
                             batch_size=16, synthetic_alpha=0.5,
                             synthetic_beta=0.5, data_plane=plane),
        federated=tcfg.FederatedConfig(
            federated=True, num_clients=8, num_comms=6,
            online_client_rate=0.5, algorithm=algorithm,
            sync_type="local_step"),
        model=tcfg.ModelConfig(arch="logistic_regression"),
        optim=tcfg.OptimConfig(lr=0.3, weight_decay=0.0),
        train=tcfg.TrainConfig(local_step=2),
        fault=fault).finalize()


def _trainer(fault, **kw):
    cfg = _cfg(fault, **kw)
    data = build_federated_data(cfg)
    return FederatedTrainer(cfg, tdefine(cfg, batch_size=16, device="cpu"),
                            tmake(cfg), data.train, device="cpu")


def _bytes(tree):
    return [v.numpy().tobytes() for v in tree.values()]


def test_config_refusals():
    with pytest.raises(ValueError, match="norm_bound"):
        _cfg(tcfg.FaultConfig(robust_agg="norm_bound", **DP))
    with pytest.raises(ValueError, match="scaffold"):
        _cfg(tcfg.FaultConfig(**DP), algorithm="scaffold")
    with pytest.raises(ValueError, match="dp_epsilon_budget"):
        _cfg(tcfg.FaultConfig(dp_epsilon_budget=4.0))
    with pytest.raises(ValueError, match="dp_noise_multiplier"):
        _cfg(tcfg.FaultConfig(dp_noise_multiplier=-1.0))
    with pytest.raises(ValueError, match="dp_clip_norm"):
        _cfg(tcfg.FaultConfig(dp_noise_multiplier=1.0, dp_clip_norm=0.0))
    with pytest.raises(ValueError, match="dp_delta"):
        _cfg(tcfg.FaultConfig(dp_noise_multiplier=1.0, dp_delta=2.0))
    with pytest.raises(ValueError, match="dp_budget_action"):
        _cfg(tcfg.FaultConfig(dp_budget_action="panic", **DP))
    for agg in ("trimmed_mean", "median", "krum"):
        _cfg(tcfg.FaultConfig(robust_agg=agg, **DP))


def _crafted(k=6, dim=7, seed=3):
    rng = np.random.RandomState(seed)
    w = rng.uniform(0.5, 2.0, size=k).astype(np.float32)
    w[1] = 0.0
    deltas = rng.randn(k, dim).astype(np.float32)
    return ({"w": torch.from_numpy(deltas * w[:, None])},
            torch.from_numpy(w),
            {"w": torch.from_numpy(rng.randn(dim).astype(np.float32))})


def test_radial_distances_match_the_inline_formula():
    payloads, w, m = _crafted()
    unit = _unit_updates(payloads, w)
    got = radial_distances(unit, m)
    want = torch.sqrt(torch.square(unit["w"] - m["w"][None]).sum(1))
    assert torch.equal(got, want)
    origin = radial_distances(unit)
    assert torch.equal(origin, torch.sqrt(torch.square(unit["w"]).sum(1)))
    assert float(origin[1]) == 0.0  # a zero-weight client measures zero


def test_radial_clip_matches_the_inline_formula():
    payloads, w, m = _crafted()
    scale = torch.linspace(0.2, 1.0, w.shape[0])
    got = radial_clip(payloads, w, scale, center=m)["w"]
    want = payloads["w"] * scale[:, None] \
        + (w * (1.0 - scale))[:, None] * m["w"][None]
    assert torch.equal(got, want)
    half = radial_clip(payloads, w, torch.full_like(w, 0.5))["w"]
    assert torch.equal(half, payloads["w"] * 0.5)


def test_dp_round_replays_bitwise_and_reports_sigma():
    def run():
        t = _trainer(tcfg.FaultConfig(**DP))
        s, c = t.init_state(0)
        fps = []
        for _ in range(3):
            s, c, m = t.run_round(s, c)
            fps.append(_bytes(s.params))
        return fps, t.round_host_scalars(c, m)
    (a, sc), (b, _) = run(), run()
    assert a == b
    # sigma = z * clip / k_online = 1.0 * 0.5 / 4
    assert sc["dp_noise_sigma"] == pytest.approx(0.125)
    assert 0.0 <= sc["dp_clipped_frac"] <= 1.0


def test_noise_actually_perturbs_the_estimate():
    on, off = _trainer(tcfg.FaultConfig(**DP)), _trainer(tcfg.FaultConfig())
    s_on, c_on = on.init_state(0)
    s_off, c_off = off.init_state(0)
    s_on, _, _ = on.run_round(s_on, c_on)
    s_off, _, _ = off.run_round(s_off, c_off)
    assert _bytes(s_on.params) != _bytes(s_off.params)


def test_off_is_leaf_free():
    """Disarmed DP knobs: no aux wrap, no DP gauges, the plain round."""
    plain = _trainer(tcfg.FaultConfig())
    disarmed = _trainer(tcfg.FaultConfig(
        dp_noise_multiplier=0.0, dp_clip_norm=9.0, dp_delta=0.5,
        dp_budget_action="degrade"))
    (s1, c1), (s2, c2) = plain.init_state(0), disarmed.init_state(0)
    assert not isinstance(s2.aux, dict)
    s1, _, m1 = plain.run_round(s1, c1)
    s2, _, m2 = disarmed.run_round(s2, c2)
    assert m2.dp_clipped_frac is None and m2.dp_noise_sigma is None
    assert _bytes(s1.params) == _bytes(s2.params)
    assert "dp_noise_sigma" not in plain.round_host_scalars(c1, m1)


def test_degrade_stops_the_noise_and_keeps_the_clip():
    t = _trainer(tcfg.FaultConfig(**DP))
    s, c = t.init_state(0)
    s, c, m = t.run_round(s, c)
    s = t.dp_set_noise_scale(s, 0.0)
    s, c, m = t.run_round(s, c)
    sc = t.round_host_scalars(c, m)
    assert sc["dp_noise_sigma"] == 0.0 and sc["dp_clipped_frac"] > 0.0

    def run(scale):
        tr = _trainer(tcfg.FaultConfig(**DP))
        sv, cl = tr.init_state(0)
        sv = tr.dp_set_noise_scale(sv, scale)
        sv, cl, _ = tr.run_round(sv, cl)
        return _bytes(sv.params)
    assert run(0.0) == run(0.0) != run(1.0)


def test_set_noise_scale_refuses_when_off():
    t = _trainer(tcfg.FaultConfig())
    s, _ = t.init_state(0)
    with pytest.raises(ValueError, match="without DP armed"):
        t.dp_set_noise_scale(s, 0.0)


def test_dp_composes_with_trimmed_mean_on_the_stream_plane():
    """DP x trimmed_mean, two rounds on each plane: bitwise each other,
    finite, noised."""
    flt = tcfg.FaultConfig(robust_agg="trimmed_mean", robust_trim_frac=0.25,
                           **DP)
    outs = []
    for plane in ("device", "stream"):
        t = _trainer(flt, plane=plane)
        t.stream_timeout_s = 20.0
        s, c = t.init_state(0)
        for _ in range(2):
            s, c, m = t.run_round(s, c)
        t.close()
        outs.append(_bytes(s.params))
        assert t.round_host_scalars(c, m)["dp_noise_sigma"] > 0.0
        assert all(bool(torch.isfinite(v).all()) for v in s.params.values())
    assert outs[0] == outs[1]
