"""The federation plane's cohort statistics in the port against the JAX
package, on the CPU (the twin of ``tests/test_cohort_stats.py``).

* ``robust_aggregate(per_client=True)``: every rule's ``sel_mask``
  exactly and its ``suspicion`` within 1e-4 relative (1e-5 absolute) of
  the JAX function's on the same crafted payloads (outliers, random
  accept masks and weights); the aggregate and the momentum bitwise
  what ``per_client=False`` returns;
* ``cohort_statistics``: the norm quantiles, the dispersion and the
  suspicion within the same bar of the JAX function's;
* the engine: cohort statistics on against off, bitwise (params,
  generator state, every metric but the cohort fields), on both data
  planes and on the async plane, sync and stream;
* one MLP round per rule (``mean``, ``median``, ``trimmed_mean``,
  ``krum``, ``norm_bound``, the guards in front of ``mean``) against the
  JAX round from the same weights and plan: the cohort's ids, online,
  accept and selection masks and staleness exactly, the suspicion, the
  norm quantiles and the dispersion within 1e-3 relative (the rounds'
  payloads agree to ``test_torch_zoo.py``'s 1e-5 of their scale, and the
  statistics divide by medians of them), ``trimmed_mean``'s suspicion (a
  share of coordinates, where near-tied values swap ranks) within 0.005
  absolute;
* the dispersion rides the round's one fetch, the vectors with it.
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
from fedtorch_tpu_torch import config as tcfg
from fedtorch_tpu_torch.algorithms import make_algorithm as tmake
from fedtorch_tpu_torch.async_plane import AsyncFederatedTrainer
from fedtorch_tpu_torch.bridge import params_from_jax
from fedtorch_tpu_torch.data.batching import stack_partitions as tstack
from fedtorch_tpu_torch.models import define_model as tdefine
from fedtorch_tpu_torch.parallel import FederatedTrainer
from fedtorch_tpu_torch.robustness import aggregators as tagg
from test_torch_robust_agg import ACCEPTS, RULES, _j, _payloads, _t
from test_torch_zoo import _flat, _plans

REL = 1e-4      # the functions on the same payloads
ROUND_REL = 1e-3  # the statistics of two rounds' payloads


def _close(got, want, rel=REL, what=""):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()) if want.size else 0.0, 1.0)
    np.testing.assert_allclose(got, want, rtol=rel, atol=1e-5 * scale,
                               err_msg=what)


def _rule_args(rule, seed, accept, k=8):
    _, payloads, w = _payloads(seed, k)
    a = ACCEPTS[accept](k)
    rng = np.random.RandomState(2)
    mom = {"a": rng.randn(6).astype(np.float32),
           "b": rng.randn(2, 3).astype(np.float32)} \
        if rule == "norm_bound" else None
    return payloads, w, a, mom


@pytest.mark.parametrize("rule", RULES)
@pytest.mark.parametrize("accept", ["all", "some", "one"])
def test_per_client_evidence_matches_the_jax_function(rule, accept):
    payloads, w, a, mom = _rule_args(rule, 7, accept)
    kw = dict(robust_trim_frac=0.25, robust_norm_tau=1.5)
    _, _, jr = jagg.robust_aggregate(
        rule, _j(payloads), jnp.asarray(w), jnp.asarray(a),
        jcfg.FaultConfig(**kw), momentum=None if mom is None else _j(mom),
        per_client=True)
    _, _, tr = tagg.robust_aggregate(
        rule, _t(payloads), torch.from_numpy(w), torch.from_numpy(a),
        tcfg.FaultConfig(**kw), momentum=None if mom is None else _t(mom),
        per_client=True)
    np.testing.assert_array_equal(tr.sel_mask.numpy(),
                                  np.asarray(jr.sel_mask))
    _close(tr.suspicion.numpy(), np.asarray(jr.suspicion), what=rule)
    assert float(tr.sel_mask.sum()) == float(tr.selected) \
        or rule in ("trimmed_mean",)


@pytest.mark.parametrize("rule", RULES)
def test_aggregate_bitwise_unchanged_by_per_client(rule):
    payloads, w, a, mom = _rule_args(rule, 3, "some")
    outs = []
    for per_client in (False, True):
        s, m, rep = tagg.robust_aggregate(
            rule, _t(payloads), torch.from_numpy(w), torch.from_numpy(a),
            tcfg.FaultConfig(robust_trim_frac=0.25),
            momentum=None if mom is None else _t(mom),
            per_client=per_client)
        outs.append((s, m, rep))
    for n in outs[0][0]:
        assert torch.equal(outs[0][0][n], outs[1][0][n]), n
    if outs[0][1] is not None:
        for n in outs[0][1]:
            assert torch.equal(outs[0][1][n], outs[1][1][n]), n
    assert outs[0][2].sel_mask is None and outs[0][2].suspicion is None
    assert outs[1][2].sel_mask is not None


@pytest.mark.parametrize("rule", RULES)
def test_the_outlier_ranks_most_suspect(rule):
    """The JAX package's planted sign-flipped client, on top for every
    rule."""
    rng = np.random.RandomState(0)
    base = rng.randn(8).astype(np.float32)
    u = base[None, :] + 0.05 * rng.randn(6, 8).astype(np.float32)
    u[3] = -5.0 * base
    mom = {"d": torch.zeros(8)} if rule == "norm_bound" else None
    _, _, rep = tagg.robust_aggregate(
        rule, {"d": torch.from_numpy(u)}, torch.ones(6), torch.ones(6),
        tcfg.FaultConfig(robust_agg=rule, robust_trim_frac=0.25,
                         robust_norm_tau=1.5),
        momentum=mom, per_client=True)
    assert int(rep.suspicion.argmax()) == 3, rep.suspicion


@pytest.mark.parametrize("accept", ["all", "some", "one", "none"])
def test_cohort_statistics_match_the_jax_function(accept):
    _, payloads, w = _payloads(11, 8)
    a = ACCEPTS[accept](8)
    js = jagg.cohort_statistics(_j(payloads), jnp.asarray(w),
                                jnp.asarray(a))
    ts = tagg.cohort_statistics(_t(payloads), torch.from_numpy(w),
                                torch.from_numpy(a))
    _close(ts.norm_q.numpy(), np.asarray(js.norm_q), what="norm_q")
    _close(float(ts.dispersion), float(js.dispersion), what="dispersion")
    _close(ts.suspicion.numpy(), np.asarray(js.suspicion), what="susp")


def test_cohort_statistics_gauges():
    """Identical updates: dispersion ~0 and the quantiles at the common
    norm; one flipped client moves the dispersion up."""
    u = np.tile(np.arange(1.0, 7.0, dtype=np.float32), (5, 1))
    cs = tagg.cohort_statistics({"d": torch.from_numpy(u)}, torch.ones(5),
                                torch.ones(5))
    np.testing.assert_allclose(cs.norm_q.numpy(), np.linalg.norm(u[0]),
                               rtol=1e-5)
    assert abs(float(cs.dispersion)) < 1e-5
    u[2] = -u[2]
    cs = tagg.cohort_statistics({"d": torch.from_numpy(u)}, torch.ones(5),
                                torch.ones(5))
    assert float(cs.dispersion) > 0.1


# -- the engine ------------------------------------------------------------

C, N, B, K = 10, 16, 8, 2


def _cfg(mod, cohort, fault=None, plane="device", sync_mode="sync"):
    return mod.ExperimentConfig(
        data=mod.DataConfig(dataset="synthetic", batch_size=B,
                            data_plane=plane),
        federated=mod.FederatedConfig(
            federated=True, num_clients=C, online_client_rate=0.5,
            sync_type="local_step", sync_mode=sync_mode),
        model=mod.ModelConfig(arch="mlp", mlp_hidden_size=32),
        optim=mod.OptimConfig(lr=0.1), train=mod.TrainConfig(local_step=K),
        fault=mod.FaultConfig(**(fault or {})),
        telemetry=mod.TelemetryConfig(cohort_stats=cohort)).finalize()


def _population():
    rng = np.random.RandomState(0)
    x = rng.randn(C * N, 60).astype(np.float32)
    x[:N] *= 30.0  # client 0's rows: an exploded update
    y = rng.randint(0, 10, C * N)
    return x, y, [np.arange(i * N, (i + 1) * N) for i in range(C)]


def _port(cohort, **kw):
    cfg = _cfg(tcfg, cohort, **kw)
    cls = AsyncFederatedTrainer if cfg.federated.sync_mode == "async" \
        else FederatedTrainer
    t = cls(cfg, tdefine(cfg, batch_size=B, device="cpu"), tmake(cfg),
            tstack(*_population()), device="cpu")
    t.stream_timeout_s = 20.0
    return t


COHORT_FIELDS = ("cohort_idx", "cohort_online", "cohort_accept",
                 "cohort_selected", "cohort_suspicion", "cohort_staleness",
                 "cohort_norm_q", "cohort_dispersion")


@pytest.mark.parametrize("plane, sync_mode", [
    ("device", "sync"), ("stream", "sync"), ("device", "async"),
    ("stream", "async")])
def test_stats_on_and_off_are_bitwise_the_same_run(plane, sync_mode):
    """Three rounds (commits) with the statistics on and off: params,
    generator state and every metric but the cohort fields bitwise; the
    cohort vectors [k] on, None off."""
    fault = dict(robust_agg="krum", robust_trim_frac=0.2) \
        if plane == "device" and sync_mode == "sync" else None
    runs = []
    for cohort in (False, True):
        t = _port(cohort, fault=fault, plane=plane, sync_mode=sync_mode)
        s, c = t.init_state(3)
        for _ in range(3):
            s, c, m = t.run_round(s, c)
        t.close()
        runs.append((s, c, m, t))
    (s0, c0, m0, t0), (s1, c1, m1, t1) = runs
    for n in s0.params:
        assert torch.equal(s0.params[n], s1.params[n]), n
        assert torch.equal(c0.params[n], c1.params[n]), n
    assert torch.equal(s0.rng.get_state(), s1.rng.get_state())
    for f in m0._fields:
        if f in COHORT_FIELDS:
            assert getattr(m0, f) is None, f
            continue
        a, b = getattr(m0, f), getattr(m1, f)
        assert (a is None and b is None) or torch.equal(a, b), f
    k = t1.buffer_size if sync_mode == "async" else t1.k_online
    assert m1.cohort_idx.shape == (k,)
    assert m1.cohort_norm_q.shape == (5,)
    if sync_mode == "async":
        # each job's commit staleness, whose mean is the metric
        assert float(m1.cohort_staleness.mean()) == \
            float(m1.staleness_mean)


def _pair(fault):
    """Both packages' trainers on one MLP population with the statistics
    on, the port's state on the JAX weights."""
    jc, tc = _cfg(jcfg, True, fault), _cfg(tcfg, True, fault)
    jtr = JTrainer(jc, jdefine(jc, batch_size=B), jmake(jc),
                   jstack(*_population()))
    js, jcl = jtr.init_state(jax.random.key(0))
    ttr = FederatedTrainer(tc, tdefine(tc, batch_size=B, device="cpu"),
                           tmake(tc), tstack(*_population()), device="cpu")
    ts, tcl = ttr.init_state(0)
    params = params_from_jax(_flat(js.params), expect=ts.params,
                             module=ttr.model.module)
    for n, p in tcl.params.items():
        p[:] = params[n]
    return jtr, js, jcl, ttr, ts._replace(params=params), tcl


ROUND_CASES = {
    "mean": dict(),
    "guards": dict(guard_updates=True, guard_norm_multiplier=1.0),
    "median": dict(robust_agg="median"),
    "trimmed_mean": dict(robust_agg="trimmed_mean", robust_trim_frac=0.2),
    "krum": dict(robust_agg="krum", robust_trim_frac=0.2),
    "norm_bound": dict(robust_agg="norm_bound", robust_norm_tau=1.0),
}


@pytest.mark.parametrize("case", sorted(ROUND_CASES))
def test_the_round_s_cohort_vectors_match_the_jax_round(case):
    jtr, js, jcl, ttr, ts, tcl = _pair(ROUND_CASES[case])
    for plan in _plans(jtr, js, 2):
        js, jcl, jm = jtr.run_round(js, jcl)
        ts, tcl, tm = ttr.round_fn(ts, tcl, plan)
        for f in ("cohort_idx", "cohort_online", "cohort_accept",
                  "cohort_selected", "cohort_staleness"):
            np.testing.assert_array_equal(
                getattr(tm, f).numpy(), np.asarray(getattr(jm, f)),
                err_msg=f)
        for f in ("cohort_suspicion", "cohort_norm_q",
                  "cohort_dispersion"):
            got, want = getattr(tm, f).numpy(), np.asarray(getattr(jm, f))
            if case == "trimmed_mean" and f == "cohort_suspicion":
                # a share of coordinates: two clients' values within the
                # payloads' 1e-5 swap ranks at the window's edge, so the
                # bar is 0.5% of the coordinates
                np.testing.assert_allclose(got, want, atol=5e-3)
                continue
            _close(got, want, rel=ROUND_REL, what=f)
    if case == "guards":
        assert float(tm.cohort_accept.sum()) < ttr.k_online


def test_the_cohort_rides_the_round_s_one_fetch():
    """``round_host_scalars`` carries the dispersion (absent with the
    statistics off) and, with ``ledger=True``, the vectors, equal to
    the metrics' own."""
    for cohort in (False, True):
        t = _port(cohort)
        s, c = t.init_state(0)
        s, c, m = t.run_round(s, c)
        sc = t.round_host_scalars(c, m)
        assert ("cohort_dispersion" in sc) == cohort
        sc2, led = t.round_host_scalars(c, m, ledger=True)
        assert sc2 == sc
        if not cohort:
            assert led is None
            continue
        assert sc["cohort_dispersion"] == float(m.cohort_dispersion)
        vecs = t.cohort_vectors(m)
        for name, v in vecs.items():
            np.testing.assert_array_equal(led[name], v.numpy(),
                                          err_msg=name)
        assert led["idx"].dtype == np.int64
