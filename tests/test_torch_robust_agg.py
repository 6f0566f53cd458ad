"""The server's update guards and the robust aggregation rules in the
port against the JAX package, on the CPU.

* ``screen_payloads`` (reject and clip), ``renormalize_accepted``,
  ``all_rejected_scalars`` and the numpy-style ``nanmedian`` against the
  JAX functions on crafted payloads with NaN, inf and outliers;
* all five rules of ``robust_aggregate`` against the JAX function on
  crafted payload trees (outliers, random accept masks and weights, a
  NaN or an inf in a candidate), within 1e-5 (NaN where the JAX result
  is NaN), their reports exactly; each rule keeps the round's total
  weight;
* one MLP round per rule (and the guards in both modes) through
  ``FederatedTrainer`` against the JAX round from the same weights and
  plan (``test_torch_zoo.py``'s bar), norm_bound for two rounds;
* the guards on with nothing rejected give bitwise the round without
  them.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401 (two torch threads a worker)
from fedtorch_tpu import config as jcfg
from fedtorch_tpu.algorithms import make_algorithm as jmake
from fedtorch_tpu.data.batching import stack_partitions as jstack
from fedtorch_tpu.models import define_model as jdefine
from fedtorch_tpu.parallel import FederatedTrainer as JTrainer
from fedtorch_tpu.robustness import aggregators as jagg
from fedtorch_tpu.robustness import guards as jguards
from fedtorch_tpu_torch import config as tcfg
from fedtorch_tpu_torch.algorithms import make_algorithm as tmake
from fedtorch_tpu_torch.bridge import params_from_jax
from fedtorch_tpu_torch.data.batching import stack_partitions as tstack
from fedtorch_tpu_torch.models import define_model as tdefine
from fedtorch_tpu_torch.parallel import FederatedTrainer
from fedtorch_tpu_torch.robustness import aggregators as tagg
from fedtorch_tpu_torch.robustness import guards as tguards
from test_torch_zoo import _assert_state_close, _flat, _plans

RULES = ("mean", "median", "trimmed_mean", "krum", "multikrum",
         "norm_bound")


def _j(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def _t(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _payloads(seed, k, poison=None):
    """A tree of two leaves over ``k`` clients: an honest cluster, two
    clients scaled by -3 and 40, optionally a NaN or an inf in client
    1; random positive weights; the payloads client-weighted."""
    rng = np.random.RandomState(seed)
    center = {"a": rng.randn(6), "b": rng.randn(2, 3)}
    deltas = {n: np.stack([c + 0.1 * rng.randn(*c.shape) for _ in range(k)])
              .astype(np.float32) for n, c in center.items()}
    for n in deltas:
        deltas[n][0] *= -3.0
        deltas[n][k - 1] *= 40.0
    if poison is not None:
        deltas["a"][1, 2] = poison
    w = rng.uniform(0.2, 1.5, k).astype(np.float32)
    payloads = {n: d * w.reshape((-1,) + (1,) * (d.ndim - 1))
                for n, d in deltas.items()}
    return deltas, payloads, w


def _assert_tree_close(got, want, rtol=1e-5):
    for n in want:
        w, g = np.asarray(want[n]), _np(got[n])
        scale = max(float(np.nanmax(np.abs(w[np.isfinite(w)])))
                    if np.isfinite(w).any() else 0.0, 1e-30)
        np.testing.assert_allclose(g, w, rtol=rtol, atol=rtol * scale,
                                   equal_nan=True, err_msg=n)


# -- the numpy-style median -------------------------------------------------

@pytest.mark.parametrize("n, n_nan", [(1, 0), (4, 0), (5, 0), (6, 2),
                                      (7, 3), (3, 3)])
def test_nanmedian_is_jnp_nanmedian(n, n_nan):
    rng = np.random.RandomState(n + 10 * n_nan)
    x = rng.randn(n, 4).astype(np.float32)
    x[:n_nan, :2] = np.nan
    x[n - n_nan:, 2:] = np.nan
    want = np.asarray(jnp.nanmedian(jnp.asarray(x), axis=0))
    got = tguards.nanmedian(torch.from_numpy(x), dim=0).numpy()
    np.testing.assert_array_equal(got, want)


# -- the guards ---------------------------------------------------------------

@pytest.mark.parametrize("mode", ["reject", "clip"])
@pytest.mark.parametrize("poison", [None, np.nan, np.inf, -np.inf])
@pytest.mark.parametrize("survive", ["all", "one_crashed"])
def test_screen_payloads_matches(mode, poison, survive):
    k = 6
    deltas, payloads, _ = _payloads(1, k, poison)
    alive = np.ones(k, np.float32)
    if survive == "one_crashed":
        alive[k - 1] = 0.0  # the exploded client crashed
    flt = dict(guard_updates=True, guard_norm_multiplier=3.0,
               guard_mode=mode)
    jp, jr = jguards.screen_payloads(_j(deltas), _j(payloads),
                                     jnp.asarray(alive),
                                     jcfg.FaultConfig(**flt))
    tp, tr = tguards.screen_payloads(_t(deltas), _t(payloads),
                                     torch.from_numpy(alive),
                                     tcfg.FaultConfig(**flt))
    np.testing.assert_array_equal(tr.accept.numpy(), np.asarray(jr.accept))
    for f in ("rejected", "clipped"):
        assert float(getattr(tr, f)) == float(getattr(jr, f)), f
    np.testing.assert_allclose(tr.norms.numpy(), np.asarray(jr.norms),
                               rtol=1e-6, equal_nan=True)
    _assert_tree_close(tp, jp)
    for v in tp.values():  # rejected payloads zeroed by a select
        assert bool(torch.isfinite(v).all())


def test_renormalize_and_the_all_rejected_predicate_match():
    rng = np.random.RandomState(3)
    w = rng.uniform(0.1, 2.0, 5).astype(np.float32)
    tree = {"p": rng.randn(3).astype(np.float32)}
    for accept in ([1, 0, 1, 1, 0], [0, 0, 0, 0, 0], [1] * 5):
        a = np.asarray(accept, np.float32)
        want = jguards.renormalize_accepted(_j(tree), jnp.asarray(w),
                                            jnp.asarray(a))
        got = tguards.renormalize_accepted(_t(tree), torch.from_numpy(w),
                                           torch.from_numpy(a))
        np.testing.assert_array_equal(got["p"].numpy(),
                                      np.asarray(want["p"]))
    for sc in (dict(n_online=4.0, rejected=4.0, dropped=0.0),
               dict(n_online=4.0, rejected=1.0, dropped=0.0),
               dict(n_online=0.0, rejected=0.0, dropped=2.0),
               dict(n_online=0.0, rejected=0.0, dropped=0.0)):
        assert tguards.all_rejected_scalars(sc) == \
            jguards.all_rejected_scalars(sc)


# -- the rules ------------------------------------------------------------------

ACCEPTS = {
    "all": lambda k: np.ones(k, np.float32),
    "some": lambda k: np.asarray([1, 1, 0, 1, 1, 0, 1, 1][:k], np.float32),
    "one": lambda k: np.eye(k, dtype=np.float32)[2],
    "none": lambda k: np.zeros(k, np.float32),
}


@pytest.mark.parametrize("rule", RULES)
@pytest.mark.parametrize("accept", sorted(ACCEPTS))
@pytest.mark.parametrize("frac", [0.1, 0.3])
def test_robust_aggregate_matches(rule, accept, frac):
    k = 8
    _, payloads, w = _payloads(7, k)
    a = ACCEPTS[accept](k)
    rng = np.random.RandomState(2)
    momentum = {"a": rng.randn(6).astype(np.float32),
                "b": rng.randn(2, 3).astype(np.float32)}
    kw = dict(robust_trim_frac=frac, robust_norm_tau=1.5)
    js, jm, jr = jagg.robust_aggregate(
        rule, _j(payloads), jnp.asarray(w), jnp.asarray(a),
        jcfg.FaultConfig(**kw),
        momentum=_j(momentum) if rule == "norm_bound" else None)
    ts, tm, tr = tagg.robust_aggregate(
        rule, _t(payloads), torch.from_numpy(w), torch.from_numpy(a),
        tcfg.FaultConfig(**kw),
        momentum=_t(momentum) if rule == "norm_bound" else None)
    _assert_tree_close(ts, js)
    assert float(tr.selected) == float(jr.selected)
    assert float(tr.trimmed) == float(jr.trimmed)
    assert (tm is None) == (jm is None) == (rule != "norm_bound")
    if jm is not None:
        _assert_tree_close(tm, jm)


@pytest.mark.parametrize("rule", RULES)
@pytest.mark.parametrize("poison", [np.nan, np.inf])
def test_a_non_finite_candidate_is_treated_as_the_jax_package_does(rule,
                                                                   poison):
    """No guard in front: the rules' own handling of a NaN or inf in an
    accepted update (the median drops a NaN coordinate, the sorts put
    NaN last)."""
    k = 7
    _, payloads, w = _payloads(9, k, poison)
    a = np.ones(k, np.float32)
    mom = {"a": np.zeros(6, np.float32), "b": np.zeros((2, 3), np.float32)}
    js, _, jr = jagg.robust_aggregate(
        rule, _j(payloads), jnp.asarray(w), jnp.asarray(a),
        jcfg.FaultConfig(robust_trim_frac=0.2),
        momentum=_j(mom) if rule == "norm_bound" else None)
    ts, _, tr = tagg.robust_aggregate(
        rule, _t(payloads), torch.from_numpy(w), torch.from_numpy(a),
        tcfg.FaultConfig(robust_trim_frac=0.2),
        momentum=_t(mom) if rule == "norm_bound" else None)
    _assert_tree_close(ts, js)
    assert float(tr.selected) == float(jr.selected)


@pytest.mark.parametrize("rule", RULES)
@pytest.mark.parametrize("trial", [0, 1, 2])
def test_every_rule_keeps_the_round_weight(rule, trial):
    """Every client reporting the same unit update: the aggregate is
    ``sum(weights)`` times it, over random accept masks and weights
    (the JAX package's ``TestWeightConservation``)."""
    rng = np.random.RandomState(41 * trial + RULES.index(rule))
    k = int(rng.randint(4, 12))
    w = rng.uniform(0.2, 2.0, k).astype(np.float32)
    accept = np.zeros(k, np.float32)
    accept[rng.choice(k, size=rng.randint(1, k + 1), replace=False)] = 1.0
    u = rng.randn(4).astype(np.float32)
    out, _, rep = tagg.robust_aggregate(
        rule, {"p": torch.from_numpy(np.outer(w, u))}, torch.from_numpy(w),
        torch.from_numpy(accept), tcfg.FaultConfig(robust_trim_frac=0.25),
        momentum={"p": torch.zeros(4)} if rule == "norm_bound" else None)
    np.testing.assert_allclose(out["p"].numpy(), float(w.sum()) * u,
                               rtol=2e-4)
    assert float(rep.selected) >= 1.0


def test_krum_never_selects_the_outliers():
    _, payloads, w = _payloads(4, 8)
    sel, _ = tagg.krum_selection(
        tagg._unit_updates(_t(payloads), torch.from_numpy(w)),
        torch.ones(8), 0.25, multi=True)
    assert sel[0] == 0 and sel[7] == 0 and float(sel.sum()) >= 3


def test_unknown_rule_and_missing_momentum_raise():
    _, payloads, w = _payloads(0, 4)
    args = (_t(payloads), torch.from_numpy(w), torch.ones(4),
            tcfg.FaultConfig())
    with pytest.raises(ValueError, match="unknown robust_agg"):
        tagg.robust_aggregate("mode", *args)
    with pytest.raises(ValueError, match="momentum"):
        tagg.robust_aggregate("norm_bound", *args)


# -- rounds -------------------------------------------------------------------

C, N, B, K = 10, 16, 8, 2


def _trainers(fault):
    """Both packages' trainers on one MLP population (k = 5 of 10), the
    port's state on the JAX weights."""
    def cfg(mod):
        return mod.ExperimentConfig(
            data=mod.DataConfig(dataset="synthetic", batch_size=B),
            federated=mod.FederatedConfig(
                federated=True, num_clients=C, online_client_rate=0.5,
                sync_type="local_step"),
            model=mod.ModelConfig(arch="mlp", mlp_hidden_size=32),
            optim=mod.OptimConfig(lr=0.1),
            train=mod.TrainConfig(local_step=K),
            fault=mod.FaultConfig(**fault)).finalize()
    jc, tc = cfg(jcfg), cfg(tcfg)
    rng = np.random.RandomState(0)
    x = rng.randn(C * N, 60).astype(np.float32)
    x[:N] *= 30.0  # client 0's rows: an exploded update
    y = rng.randint(0, 10, C * N)
    parts = [np.arange(i * N, (i + 1) * N) for i in range(C)]
    jtr = JTrainer(jc, jdefine(jc, batch_size=B), jmake(jc),
                   jstack(x, y, parts))
    js, jcl = jtr.init_state(jax.random.key(0))
    ttr = FederatedTrainer(tc, tdefine(tc, batch_size=B, device="cpu"),
                           tmake(tc), tstack(x, y, parts), device="cpu")
    ts, tcl = ttr.init_state(0)
    params = params_from_jax(_flat(js.params), expect=ts.params,
                             module=ttr.model.module)
    for n, p in tcl.params.items():
        p[:] = params[n]
    return jtr, js, jcl, ttr, ts._replace(params=params), tcl


ROUND_CASES = {
    "guards_reject": dict(guard_updates=True, guard_norm_multiplier=1.0),
    "guards_clip": dict(guard_updates=True, guard_norm_multiplier=1.0,
                        guard_mode="clip"),
    "median": dict(robust_agg="median"),
    "trimmed_mean": dict(robust_agg="trimmed_mean", robust_trim_frac=0.2,
                         guard_updates=True),
    "krum": dict(robust_agg="krum", robust_trim_frac=0.2),
    "multikrum": dict(robust_agg="multikrum", guard_updates=True,
                      guard_mode="clip", guard_norm_multiplier=2.0),
    "norm_bound": dict(robust_agg="norm_bound", robust_norm_tau=1.0),
}


@pytest.mark.parametrize("case", sorted(ROUND_CASES))
def test_round_matches_the_jax_round(case):
    """The same plans through both rounds (two for norm_bound, whose
    momentum then clips the second): server params, the norm_bound
    momentum and the clients' states within ``test_torch_zoo.py``'s bar,
    the guard and rule counts exactly."""
    fault = ROUND_CASES[case]
    jtr, js, jcl, ttr, ts, tcl = _trainers(fault)
    rounds = 2 if case == "norm_bound" else 1
    for plan in _plans(jtr, js, rounds):
        js, jcl, jm = jtr.run_round(js, jcl)
        ts, tcl, tm = ttr.round_fn(ts, tcl, plan)
        for f in ("rejected_updates", "clipped_updates", "robust_selected",
                  "robust_trimmed"):
            assert float(getattr(tm, f)) == float(getattr(jm, f)), f
    if case.startswith("guards"):
        assert float(tm.rejected_updates) + float(tm.clipped_updates) >= 1
    assert _assert_state_close(js, jcl, ts, tcl, ttr.model.module) > 0
    if case == "norm_bound":
        assert set(ts.aux) == {"alg", "norm_bound_m"}


def test_guards_that_reject_nothing_give_bitwise_the_unguarded_round():
    """The renormalization of a round that accepts every client scales
    by exactly 1: the guarded round is bit for bit the plain one, and
    the plain round reports zero counts."""
    runs = []
    for fault in (dict(), dict(guard_updates=True,
                               guard_norm_multiplier=1e6)):
        _, js, _, ttr, ts, tcl = _trainers(fault)
        plan = ttr.draw_plan(ts)
        ts, tcl, tm = ttr.round_fn(ts, tcl, plan)
        runs.append((ts, tm))
    (a, ma), (b, mb) = runs
    for n in a.params:
        assert torch.equal(a.params[n], b.params[n]), n
    for f in ("rejected_updates", "clipped_updates", "robust_selected",
              "robust_trimmed"):
        assert float(getattr(ma, f)) == float(getattr(mb, f)) == 0.0
