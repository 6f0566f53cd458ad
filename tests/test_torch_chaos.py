"""Chaos injection in the port against the JAX package, on the CPU.

* **Exact**: ``draw_chaos_plan``'s decisions fed the JAX package's own
  uniforms (replayed from its fold chain), ``byzantine_cohort_mask`` fed
  the JAX cohort's uniforms, ``poison_tree`` on float and int dtypes;
* **1e-6 relative**: ``apply_byzantine`` in all five modes, the gauss
  mode's normals injected;
* **rounds**: one MLP round per case (crash, straggler under
  ``local_step`` and ``epoch`` sync, nan poison with the guards, a
  byzantine sign flip with the guards, collusion under ``krum``)
  through ``FederatedTrainer`` against the JAX round from the same
  weights, the JAX plan and its fault uniforms (and cohort), held to
  ``test_torch_zoo.py``'s state bar, the clients' state and every
  counter equal;
* the sync-plane parts of the JAX package's ``test_fault_injection.py``
  (determinism, crash, stragglers, nan poison, ``poison_tree``) and of
  ``test_robust_agg.py``'s byzantine block, on the port alone;
* a disarmed ``FaultConfig()`` draws exactly the fault-free plans.

The round helpers (``_trainers``, ``_fault_plans``, ``_check_round``)
serve ``test_torch_availability.py`` and ``test_torch_privacy.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401 (two torch threads a worker)
from fedtorch_tpu import config as jcfg
from fedtorch_tpu.algorithms import make_algorithm as jmake
from fedtorch_tpu.data.batching import (
    round_row_plan as j_round_row_plan, stack_partitions as jstack,
)
from fedtorch_tpu.models import define_model as jdefine
from fedtorch_tpu.parallel import FederatedTrainer as JTrainer
from fedtorch_tpu.parallel.federated import participation_indices
from fedtorch_tpu.robustness import availability as javail
from fedtorch_tpu.robustness import chaos as jchaos
from fedtorch_tpu.robustness import privacy as jpriv
from fedtorch_tpu_torch import config as tcfg
from fedtorch_tpu_torch.algorithms import make_algorithm as tmake
from fedtorch_tpu_torch.bridge import params_from_jax
from fedtorch_tpu_torch.data import build_federated_data
from fedtorch_tpu_torch.data.batching import stack_partitions as tstack
from fedtorch_tpu_torch.models import define_model as tdefine
from fedtorch_tpu_torch.parallel import FederatedTrainer, RoundPlan
from fedtorch_tpu_torch.robustness import availability as tavail
from fedtorch_tpu_torch.robustness import chaos as tchaos
from test_torch_zoo import _assert_state_close, _flat

C, N, B, K = 10, 16, 8, 2
REL = 1e-6
COUNTERS = ("dropped_clients", "straggler_clients", "rejected_updates",
            "clipped_updates", "staleness_mean", "byzantine_clients",
            "robust_selected", "robust_trimmed", "avail_dropped",
            "deadline_missed", "quorum_degraded")


# -- the round harness --------------------------------------------------------

def _trainers(fault, sizes=(N,) * C, sync_type="local_step", rate=0.5,
              local_step=K, mode="perm"):
    """Both packages' trainers on one MLP population (k = rate x C), the
    port's server and clients on the JAX weights."""
    def cfg(mod):
        return mod.ExperimentConfig(
            data=mod.DataConfig(dataset="synthetic", batch_size=B),
            federated=mod.FederatedConfig(
                federated=True, num_clients=len(sizes),
                online_client_rate=rate, sync_type=sync_type,
                participation_mode=mode),
            model=mod.ModelConfig(arch="mlp", mlp_hidden_size=32),
            optim=mod.OptimConfig(lr=0.1),
            train=mod.TrainConfig(local_step=local_step),
            fault=mod.FaultConfig(**fault)).finalize()
    jc, tc = cfg(jcfg), cfg(tcfg)
    rng = np.random.RandomState(0)
    x = rng.randn(sum(sizes), 60).astype(np.float32)
    y = rng.randint(0, 10, sum(sizes))
    ends = np.cumsum(sizes)
    parts = [np.arange(e - s, e) for s, e in zip(sizes, ends)]
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


def _np(x):
    return np.asarray(x)


def _t(x):
    return torch.from_numpy(np.array(x))


def _port_stack(jtree, ttr, k):
    """A JAX params-shaped tree with a leading [k] axis, in the port's
    names and layouts."""
    rows = [params_from_jax(_flat(jax.tree.map(lambda v: v[i], jtree)),
                            module=ttr.model.module) for i in range(k)]
    return {n: torch.stack([r[n] for r in rows]) for n in rows[0]}


def _normals_tree(key, like, base=0):
    """The JAX package's per-leaf normals: ``normal(fold_in(key, base +
    i), shape)`` for the i-th leaf of ``like`` in its flatten order."""
    leaves, treedef = jax.tree.flatten(like)
    return jax.tree.unflatten(treedef, [
        jax.random.normal(jax.random.fold_in(key, base + i), x.shape,
                          jnp.float32) for i, x in enumerate(leaves)])


def _fault_plans(jtr, js, num_rounds, ttr=None):
    """The JAX round_fn's cohort (``k_dispatch`` clients) and rows, and
    its fault planes' uniforms (the chaos folds, the availability
    lifecycle's per-client folds) and normals (the gauss attack's and
    the DP noise's, in the port's names), replayed from the key chain
    into the port's ``RoundPlan``."""
    key = jax.random.wrap_key_data(jax.random.key_data(js.rng))
    flt, k = jtr.fault, jtr.k_dispatch
    n_max = jtr.data.x.shape[1]
    params = js.params
    plans = []
    for r in range(num_rounds):
        rng_round = jax.random.fold_in(key, r)
        rng_sample, rng_train = jax.random.split(rng_round)
        idx = participation_indices(rng_sample, jtr.num_clients, k,
                                    jnp.int32(r),
                                    mode=jtr.participation_mode)
        rngs = jax.random.split(rng_train, k)
        rows = jax.vmap(lambda rc, s: j_round_row_plan(
            rc, s, n_max, jtr.local_steps * jtr.batch_size))(
                rngs, jnp.take(jtr.data.sizes, idx))
        f = {}
        ckey = jax.random.fold_in(rng_round, flt.chaos_salt)
        for i, (name, rate) in enumerate((
                ("u_crash", flt.client_drop_rate),
                ("u_strag", flt.straggler_rate),
                ("u_nan", flt.nan_inject_rate))):
            if rate > 0.0:
                f[name] = _t(jax.random.uniform(
                    jax.random.fold_in(ckey, i), (k,)))
        if jtr.avail_sync:
            ukey = jax.random.fold_in(rng_round, javail.AVAIL_SYNC_SALT)
            f["u_avail"] = _t(jax.vmap(lambda c: jax.random.uniform(
                jax.random.fold_in(ukey, c), (2,)))(idx))
            if flt.avail_model == "trace" or flt.avail_dropout_rate > 0:
                dkey = jax.random.fold_in(rng_round, javail.AVAIL_DROP_SALT)
                f["u_drop"] = _t(jax.vmap(lambda c: jax.random.uniform(
                    jax.random.fold_in(dkey, c), ()))(idx))
        noise = {}
        if flt.byzantine_rate > 0 and flt.byzantine_mode == "gauss":
            brng = jax.random.fold_in(ckey, jchaos.BYZ_NOISE_FOLD)
            stacked = jax.tree.map(lambda v: jnp.zeros((k,) + v.shape),
                                   params)
            noise["deltas"] = _port_stack(_normals_tree(brng, stacked),
                                          ttr, k)
            noise["payloads"] = _port_stack(
                _normals_tree(brng, stacked, 0x1000), ttr, k)
        if flt.dp_noise_multiplier > 0:
            dkey = jax.random.fold_in(rng_round, jpriv.DP_SALT)
            noise["dp"] = params_from_jax(
                _flat(_normals_tree(dkey, params)),
                module=ttr.model.module)
        plans.append(RoundPlan(_t(idx).long(), _t(rows).long(), **f,
                               noise=noise or None))
    return plans


def _jax_cohort(monkeypatch, js, num_clients):
    """The port's byzantine cohort and trace classes on the JAX run's
    uniforms (``fold_in(server.rng, ...)``)."""
    key = jax.random.wrap_key_data(jax.random.key_data(js.rng))
    u = _t(jax.random.uniform(
        jax.random.fold_in(key, jchaos.BYZ_COHORT_FOLD), (num_clients,)))
    monkeypatch.setattr(tchaos, "cohort_uniforms", lambda _k, n: u[:n])
    ckey = jax.random.fold_in(key, javail.AVAIL_CLASS_SALT)

    def classes(_k, clients):
        ids = jnp.asarray(np.asarray(clients), jnp.int32)
        return _t(jax.vmap(lambda c: jax.random.uniform(
            jax.random.fold_in(ckey, c), (2,)))(ids))
    monkeypatch.setattr(tavail, "class_uniforms", classes)


def _strip(ts, js):
    """The port's server with the aux members the JAX package does not
    wrap (the fault key) taken out."""
    aux = ts.aux
    if isinstance(aux, dict) and "fault_key" in aux:
        aux = {n: v for n, v in aux.items() if n != "fault_key"}
        if set(aux) == {"alg"} and not isinstance(js.aux, dict):
            aux = aux["alg"]
    return ts._replace(aux=aux)


def _check_round(jm, tm, jcl, tcl, exact_frac=True):
    """Every counter equal, the per-client leaves and the clients'
    state."""
    for f in COUNTERS:
        assert float(getattr(tm, f)) == float(getattr(jm, f)), \
            (f, float(getattr(tm, f)), float(getattr(jm, f)))
    np.testing.assert_array_equal(tm.online_mask.numpy(),
                                  _np(jm.online_mask))
    np.testing.assert_allclose(tm.train_loss.numpy(), _np(jm.train_loss),
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(float(tm.comm_bytes), float(jm.comm_bytes),
                               rtol=1e-6)
    for f in ("dp_clipped_frac", "dp_noise_sigma"):
        jv, tv = getattr(jm, f), getattr(tm, f)
        assert (jv is None) == (tv is None), f
        if jv is not None:
            if f == "dp_clipped_frac" and exact_frac:
                assert float(tv) == float(jv), (f, float(tv), float(jv))
            else:
                np.testing.assert_allclose(float(tv), float(jv), rtol=1e-6)
    n = tcl.local_index.shape[0]
    np.testing.assert_array_equal(tcl.local_index.numpy(),
                                  _np(jcl.local_index)[:n])
    np.testing.assert_allclose(tcl.epoch.numpy(), _np(jcl.epoch)[:n],
                               rtol=1e-6)


def _client_params_close(jcl, tcl, ttr):
    """Each client's params (the server model for a client that kept its
    round, its old params for a rolled-back one) within the zoo bar."""
    n = tcl.local_index.shape[0]
    for c in range(n):
        want = params_from_jax(
            _flat(jax.tree.map(lambda v: v[c], jcl.params)),
            module=ttr.model.module)
        scale = max(float(v.abs().max()) for v in want.values())
        for name, w in want.items():
            err = float((tcl.params[name][c] - w).abs().max())
            assert err <= 1e-5 * scale, (c, name, err)


def _run_rounds(fault, rounds=1, monkeypatch=None, between=None, **build):
    jtr, js, jcl, ttr, ts, tcl = _trainers(fault, **build)
    if monkeypatch is not None:
        _jax_cohort(monkeypatch, js, jtr.num_clients)
    plans = _fault_plans(jtr, js, rounds, ttr)
    for r, plan in enumerate(plans):
        if between is not None and r > 0:
            js, ts = between(jtr, js, ttr, ts)
        js, jcl, jm = jtr.run_round(js, jcl)
        ts, tcl, tm = ttr.round_fn(ts, tcl, plan)
        _check_round(jm, tm, jcl, tcl)
    assert _assert_state_close(js, jcl, _strip(ts, js), tcl,
                               ttr.model.module) > 0
    _client_params_close(jcl, tcl, ttr)
    return jtr, js, jcl, jm, ttr, ts, tcl, tm


ROUND_CASES = {
    "crash": (dict(client_drop_rate=0.4), {}),
    "straggler_local_step": (dict(straggler_rate=0.5,
                                  straggler_step_frac=0.34),
                             dict(local_step=3)),
    "straggler_epoch": (dict(straggler_rate=0.5, straggler_step_frac=0.5),
                        dict(sync_type="epoch",
                             sizes=(16, 8, 24, 16, 8, 24, 16, 8, 24, 16))),
    "nan_guards": (dict(nan_inject_rate=0.4, guard_updates=True), {}),
    "byzantine_sign_flip": (dict(byzantine_rate=0.3, byzantine_scale=3.0,
                                 guard_updates=True), {}),
    "byzantine_collude_krum": (dict(byzantine_rate=0.3,
                                    byzantine_mode="collude",
                                    byzantine_scale=2.0, robust_agg="krum",
                                    robust_trim_frac=0.3),
                               dict(rate=0.8)),
}


@pytest.mark.parametrize("case", sorted(ROUND_CASES))
def test_round_matches_the_jax_round(case, monkeypatch):
    """The same weights, plan and fault draws through both rounds: the
    server and every client's state within ``test_torch_zoo.py``'s bar,
    every counter and the online mask equal."""
    fault, build = ROUND_CASES[case]
    *_, jm, ttr, ts, tcl, tm = _run_rounds(fault, monkeypatch=monkeypatch,
                                           **build)
    if case == "crash":
        assert 0 < float(tm.dropped_clients) < ttr.k_online
    if case.startswith("straggler"):
        assert float(tm.straggler_clients) > 0
    if case == "nan_guards":
        assert float(tm.rejected_updates) > 0
    if case.startswith("byzantine"):
        assert float(tm.byzantine_clients) > 0


# -- the functions, exact and at 1e-6 -----------------------------------------

@pytest.mark.parametrize("seed", range(4))
def test_draw_chaos_plan_decides_as_the_jax_package(seed):
    """Fed the JAX plan's own uniforms, the port's decisions equal."""
    flt = dict(client_drop_rate=0.3, straggler_rate=0.25,
               straggler_step_frac=0.34, nan_inject_rate=0.2)
    key = jax.random.key(seed)
    want = jchaos.draw_chaos_plan(key, 64, jcfg.FaultConfig(**flt))
    us = [_t(jax.random.uniform(jax.random.fold_in(key, i), (64,)))
          for i in range(3)]
    got = tchaos.draw_chaos_plan(64, tcfg.FaultConfig(**flt), *us)
    for name in ("survive", "budget_scale", "nan_inject", "byzantine"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      _np(getattr(want, name)), name)
    assert got.survive.dtype == got.budget_scale.dtype == torch.float32


@pytest.mark.parametrize("rate", [0.0, 0.05, 0.25, 0.5])
def test_byzantine_cohort_mask_on_the_jax_uniforms(rate):
    key = jax.random.key(11)
    want = jchaos.byzantine_cohort_mask(key, 40, rate)
    got = tchaos.byzantine_cohort_mask(
        _t(jax.random.uniform(key, (40,))), rate)
    np.testing.assert_array_equal(got.numpy(), _np(want))
    assert float(got.sum()) == int(rate * 40)


def test_poison_tree_on_float_and_int_dtypes():
    mask = [0.0, 1.0, 0.0]
    tree = {"f": np.ones((3, 2), np.float32),
            "h": np.ones((3, 2), np.float16),
            "i": np.ones((3, 2), np.int32), "b": np.ones((3, 2), np.int8)}
    want = jchaos.poison_tree({n: jnp.asarray(v) for n, v in tree.items()},
                              jnp.asarray(mask))
    got = tchaos.poison_tree({n: _t(v) for n, v in tree.items()},
                             torch.tensor(mask))
    for n in tree:
        assert got[n].dtype == _t(_np(want[n])).dtype, n
        np.testing.assert_array_equal(got[n].numpy(), _np(want[n]))
    assert int(got["i"][1, 0]) == np.iinfo(np.int32).max


def _byz_inputs(seed, k=6):
    rng = np.random.RandomState(seed)
    d = {"a": rng.randn(k, 5).astype(np.float32),
         "b": rng.randn(k, 2, 3).astype(np.float32),
         "q": rng.randint(-5, 5, (k, 4)).astype(np.int8)}
    w = rng.uniform(0.2, 1.5, k).astype(np.float32)
    p = {n: (v * w.reshape((-1,) + (1,) * (v.ndim - 1))).astype(v.dtype)
         for n, v in d.items()}
    byz = np.zeros(k, np.float32)
    byz[[1, 4]] = 1.0
    surv = np.ones(k, np.float32)
    surv[2] = 0.0
    return d, p, w, byz, surv


@pytest.mark.parametrize("mode", ["sign_flip", "scale", "zero", "gauss",
                                  "collude"])
def test_apply_byzantine_matches_the_jax_function(mode):
    """Every mode on a tree with an int leaf (passed through), a crashed
    honest client (out of collusion's mean) and two adversaries; the
    gauss mode's normals are the JAX function's, injected."""
    d, p, w, byz, surv = _byz_inputs(3)
    jf = jcfg.FaultConfig(byzantine_rate=0.3, byzantine_mode=mode,
                          byzantine_scale=2.5)
    tf = tcfg.FaultConfig(byzantine_rate=0.3, byzantine_mode=mode,
                          byzantine_scale=2.5)
    rng = jax.random.key(5)
    jplan = jchaos.no_chaos_plan(6)._replace(
        byzantine=jnp.asarray(byz), survive=jnp.asarray(surv))
    jd, jp = jchaos.apply_byzantine(
        jplan, {n: jnp.asarray(v) for n, v in d.items()},
        {n: jnp.asarray(v) for n, v in p.items()}, jnp.asarray(w), rng, jf)
    noise = None
    if mode == "gauss":
        # the JAX function's folds: its leaves in flatten order, the
        # payload tree's past 0x1000
        floats = [n for n in sorted(d) if d[n].dtype == np.float32]
        noise = {which: {n: _t(jax.random.normal(
            jax.random.fold_in(rng, base + sorted(d).index(n)),
            d[n].shape, jnp.float32)) for n in floats}
            for which, base in (("deltas", 0), ("payloads", 0x1000))}
    tplan = tchaos.no_chaos_plan(6)._replace(
        byzantine=torch.from_numpy(byz), survive=torch.from_numpy(surv))
    td, tp = tchaos.apply_byzantine(
        tplan, {n: _t(v) for n, v in d.items()},
        {n: _t(v) for n, v in p.items()}, torch.from_numpy(w), tf,
        noise=noise)
    for want, got in ((jd, td), (jp, tp)):
        for n in d:
            wv, gv = _np(want[n]), got[n].numpy()
            assert gv.dtype == wv.dtype, n
            np.testing.assert_allclose(gv, wv, rtol=REL,
                                       atol=REL * np.abs(wv).max())
    honest = [0, 3, 5]
    for n in ("a", "b"):
        np.testing.assert_array_equal(td[n][honest].numpy(), d[n][honest])
    np.testing.assert_array_equal(tp["q"].numpy(), p["q"])


def test_gauss_noise_is_drawn_per_leaf_from_the_seed():
    """Without injected normals the gauss mode draws each leaf from its
    own seed: one seed gives one attack, another seed another, and a
    leaf's draw does not depend on the delta tree being there."""
    d, p, w, byz, surv = _byz_inputs(1)
    f = tcfg.FaultConfig(byzantine_rate=0.3, byzantine_mode="gauss")
    plan = tchaos.no_chaos_plan(6)._replace(byzantine=torch.from_numpy(byz))
    args = ({n: _t(v) for n, v in d.items()},
            {n: _t(v) for n, v in p.items()}, torch.from_numpy(w), f)
    a = tchaos.apply_byzantine(plan, *args, seed=7)
    b = tchaos.apply_byzantine(plan, *args, seed=7)
    c = tchaos.apply_byzantine(plan, *args, seed=8)
    _, alone = tchaos.apply_byzantine(plan, None, *args[1:], seed=7)
    assert torch.equal(a[1]["a"], b[1]["a"])
    assert torch.equal(a[1]["a"], alone["a"])
    assert not torch.equal(a[1]["a"], c[1]["a"])


# -- the JAX package's test_fault_injection.py, sync parts, on the port -------

def _port_trainer(fault=None, algorithm="fedavg", num_clients=8, rate=1.0,
                  lr=0.1, local_step=3, plane="device", quantized=False):
    cfg = tcfg.ExperimentConfig(
        data=tcfg.DataConfig(dataset="synthetic", synthetic_dim=20,
                             batch_size=32, synthetic_alpha=0.5,
                             synthetic_beta=0.5, data_plane=plane),
        federated=tcfg.FederatedConfig(
            federated=True, num_clients=num_clients, num_comms=20,
            online_client_rate=rate, algorithm=algorithm,
            sync_type="local_step", quantized=quantized),
        model=tcfg.ModelConfig(arch="logistic_regression"),
        optim=tcfg.OptimConfig(lr=lr, weight_decay=0.0),
        train=tcfg.TrainConfig(local_step=local_step),
        fault=fault if fault is not None else tcfg.FaultConfig(),
    ).finalize()
    data = build_federated_data(cfg)
    model = tdefine(cfg, batch_size=cfg.data.batch_size, device="cpu")
    return FederatedTrainer(cfg, model, tmake(cfg), data.train,
                            device="cpu")


def _finite(tree) -> bool:
    from fedtorch_tpu_torch.core.state import tree_leaves
    return all(bool(torch.isfinite(x).all()) for x in tree_leaves(tree)
               if x.is_floating_point())


def _copy(tree):
    from fedtorch_tpu_torch.core.state import tree_map
    return tree_map(lambda x: x.clone() if isinstance(x, torch.Tensor)
                    else x, tree)


def test_round_replay_is_bit_exact():
    flt = tcfg.FaultConfig(client_drop_rate=0.3, straggler_rate=0.3,
                           nan_inject_rate=0.1, guard_updates=True)
    outs = []
    for _ in range(2):
        t = _port_trainer(fault=flt)
        s, c = t.init_state(5)
        for _ in range(3):
            s, c, m = t.run_round(s, c)
        outs.append((s.params, float(m.dropped_clients),
                     float(m.rejected_updates)))
    for n in outs[0][0]:
        assert torch.equal(outs[0][0][n], outs[1][0][n])
    assert outs[0][1:] == outs[1][1:]


def test_all_crash_round_is_a_noop():
    t = _port_trainer(fault=tcfg.FaultConfig(client_drop_rate=1.0))
    s, c = t.init_state(0)
    p0, c0 = _copy(s.params), _copy(c)
    s2, c2, m = t.run_round(s, c)
    for n in p0:
        assert torch.equal(p0[n], s2.params[n])
    # crashed clients keep their round-start state (fail-stop)
    from fedtorch_tpu_torch.core.state import tree_leaves
    for a, b in zip(tree_leaves(c0), tree_leaves(c2)):
        assert torch.equal(a, b)
    assert float(m.dropped_clients) == t.k_online
    assert float(m.online_mask.sum()) == 0.0
    assert float(m.comm_bytes) == 0.0


def test_partial_crash_training_continues():
    t = _port_trainer(fault=tcfg.FaultConfig(client_drop_rate=0.25), lr=0.5)
    s, c = t.init_state(1)
    dropped, losses = 0.0, []
    for _ in range(12):
        s, c, m = t.run_round(s, c)
        dropped += float(m.dropped_clients)
        n = max(float(m.online_mask.sum()), 1.0)
        losses.append(float(m.train_loss.sum()) / n)
    assert dropped > 0 and _finite(s.params)
    assert losses[-1] < losses[0]  # still converging through the chaos


def test_survivor_weights_renormalized():
    """One local step: the server update keeps the fault-free magnitude
    (renormalized over the survivors), not survivors/k of it."""
    t = _port_trainer(fault=tcfg.FaultConfig(client_drop_rate=0.45),
                      local_step=1)
    s, c = t.init_state(2)
    p0 = _copy(s.params)
    s2, _, m = t.run_round(s, c)
    assert 0 < float(m.online_mask.sum()) < t.k_online
    ref = _port_trainer(local_step=1)
    sr, cr = ref.init_state(2)
    pr0 = _copy(sr.params)
    sr2, _, _ = ref.run_round(sr, cr)
    upd = torch.cat([(s2.params[n] - p0[n]).flatten() for n in p0])
    upd_ref = torch.cat([(sr2.params[n] - pr0[n]).flatten() for n in pr0])
    assert 0.5 < float(upd.norm() / upd_ref.norm()) < 2.0


def test_straggler_step_budget_cut():
    flt = tcfg.FaultConfig(straggler_rate=0.5, straggler_step_frac=0.34)
    t = _port_trainer(fault=flt, local_step=3)
    # seed 0's first round draws no straggler (p = 1/256 at rate 0.5)
    s, c = t.init_state(1)
    s, c, m = t.run_round(s, c)
    li = c.local_index.tolist()
    # ceil(3 * 0.34) = 2 for stragglers, 3 for the rest
    assert set(li) <= {2, 3}
    assert li.count(2) == int(float(m.straggler_clients)) > 0


def test_straggler_partial_update_aggregates():
    flt = tcfg.FaultConfig(straggler_rate=1.0, straggler_step_frac=0.5)
    t = _port_trainer(fault=flt, local_step=4)
    s, c = t.init_state(3)
    p0 = _copy(s.params)
    s2, c2, m = t.run_round(s, c)
    assert float(m.straggler_clients) == t.k_online
    assert any(bool((p0[n] != s2.params[n]).any()) for n in p0)
    assert c2.local_index.tolist() == [2] * t.num_clients


def test_nan_delta_rejected_server_stays_finite():
    t = _port_trainer(fault=tcfg.FaultConfig(nan_inject_rate=0.4,
                                             guard_updates=True))
    s, c = t.init_state(0)
    rejected = 0.0
    for _ in range(5):
        s, c, m = t.run_round(s, c)
        rejected += float(m.rejected_updates)
        assert _finite(s.params) and _finite(s.opt)
    assert rejected > 0


def test_nan_inject_keeps_delta_stateful_aux_finite():
    """The wire poison does not reach client_post's persistent aux
    (FedGATE's tracking variate consumes the clean round delta)."""
    t = _port_trainer(fault=tcfg.FaultConfig(nan_inject_rate=0.5,
                                             guard_updates=True),
                      algorithm="fedgate")
    s, c = t.init_state(0)
    rejected = 0.0
    for _ in range(4):
        s, c, m = t.run_round(s, c)
        rejected += float(m.rejected_updates)
        assert _finite(s.params) and _finite(c.aux)
    assert rejected > 0


def test_nan_delta_without_guard_poisons_server():
    t = _port_trainer(fault=tcfg.FaultConfig(nan_inject_rate=1.0))
    s, c = t.init_state(0)
    s, c, _ = t.run_round(s, c)
    assert not _finite(s.params)


def test_nan_poison_reaches_the_guards_through_the_quantized_wire():
    """A quantized uplink: the poison lands after the wire format, so the
    quantizer never sees a NaN and the guards reject the poisoned
    clients."""
    t = _port_trainer(fault=tcfg.FaultConfig(nan_inject_rate=0.5,
                                             guard_updates=True),
                      quantized=True)
    seen = []
    real = t.algorithm.payload_batch_transform

    def spy(tree):
        seen.append(all(bool(torch.isfinite(v).all())
                        for v in tree.values()))
        return real(tree)
    t.algorithm.payload_batch_transform = spy
    s, c = t.init_state(0)
    rejected = 0.0
    for _ in range(3):
        s, c, m = t.run_round(s, c)
        rejected += float(m.rejected_updates)
    assert seen and all(seen) and rejected > 0 and _finite(s.params)


# -- the byzantine block of test_robust_agg.py, on the port ------------------

def test_cohort_is_fixed_and_seeded():
    a = tchaos.byzantine_cohort_mask(tchaos.cohort_uniforms(12, 16), 0.25)
    b = tchaos.byzantine_cohort_mask(tchaos.cohort_uniforms(12, 16), 0.25)
    c = tchaos.byzantine_cohort_mask(tchaos.cohort_uniforms(13, 16), 0.25)
    assert torch.equal(a, b) and float(a.sum()) == 4.0
    assert not torch.equal(a, c)


def test_zero_rate_means_no_cohort():
    u = tchaos.cohort_uniforms(0, 16)
    assert float(tchaos.byzantine_cohort_mask(u, 0.0).sum()) == 0.0
    assert float(tchaos.byzantine_cohort_mask(u, 0.05).sum()) == 0.0


def test_sign_flip_passes_guards_but_counts():
    """A sign flip at scale 1 has the honest norm: the guards reject
    nothing while the byzantine counter counts the attack."""
    t = _port_trainer(fault=tcfg.FaultConfig(
        byzantine_rate=0.25, byzantine_mode="sign_flip",
        byzantine_scale=1.0, guard_updates=True))
    s, c = t.init_state(0)
    byz = rej = 0.0
    for _ in range(3):
        s, c, m = t.run_round(s, c)
        byz += float(m.byzantine_clients)
        rej += float(m.rejected_updates)
    assert byz > 0 and rej == 0.0


def test_attack_changes_trajectory_and_median_defends():
    atk = dict(byzantine_rate=0.25, byzantine_mode="sign_flip",
               byzantine_scale=3.0)

    def loss_after(**fault):
        t = _port_trainer(fault=tcfg.FaultConfig(**fault), lr=0.5)
        s, c = t.init_state(0)
        for _ in range(6):
            s, c, m = t.run_round(s, c)
        return s.params, float(m.train_loss.sum()) \
            / max(float(m.online_mask.sum()), 1.0)

    clean, l_clean = loss_after()
    attacked, l_atk = loss_after(**atk)
    _, l_med = loss_after(robust_agg="median", **atk)
    assert any(not torch.equal(clean[n], attacked[n]) for n in clean)
    assert l_med < l_atk


def test_collude_submits_identical_uploads():
    rng = np.random.RandomState(0)
    d = {"w": _t(rng.randn(8, 5).astype(np.float32))}
    w = torch.full((8,), 0.125)
    p = {"w": d["w"] * 0.125}
    plan = tchaos.no_chaos_plan(8)._replace(
        byzantine=torch.tensor([1.0, 1, 0, 0, 0, 0, 0, 0]))
    f = tcfg.FaultConfig(byzantine_rate=0.25, byzantine_mode="collude",
                         byzantine_scale=2.0)
    wd, wp = tchaos.apply_byzantine(plan, d, p, w, f)
    assert torch.equal(wd["w"][0], wd["w"][1])
    assert torch.equal(wp["w"][0], wp["w"][1])
    honest = d["w"][2:].mean(0)
    torch.testing.assert_close(wd["w"][0], -2.0 * honest, rtol=1e-5,
                               atol=1e-6)
    assert torch.equal(wd["w"][2:], d["w"][2:])


def test_zero_and_gauss_modes():
    rng = np.random.RandomState(1)
    d = {"w": _t(rng.randn(6, 4).astype(np.float32))}
    w = torch.full((6,), 0.5)
    p = {"w": d["w"] * 0.5}
    plan = tchaos.no_chaos_plan(6)._replace(
        byzantine=torch.tensor([1.0, 0, 0, 0, 0, 0]))
    for mode in ("zero", "gauss"):
        f = tcfg.FaultConfig(byzantine_rate=0.2, byzantine_mode=mode,
                             byzantine_scale=2.0)
        wd, wp = tchaos.apply_byzantine(plan, d, p, w, f, seed=3)
        assert torch.equal(wd["w"][1:], d["w"][1:])
        if mode == "zero":
            assert float(wd["w"][0].abs().sum()) == 0.0
            assert float(wp["w"][0].abs().sum()) == 0.0
        else:
            assert bool(torch.isfinite(wd["w"][0]).all())
            assert not torch.equal(wd["w"][0], d["w"][0])


def test_byzantine_seeded_replay_is_bit_exact():
    flt = tcfg.FaultConfig(byzantine_rate=0.25, byzantine_mode="collude",
                           byzantine_scale=2.0, guard_updates=True,
                           robust_agg="trimmed_mean", robust_trim_frac=0.25)
    outs = []
    for _ in range(2):
        t = _port_trainer(fault=flt)
        s, c = t.init_state(4)
        for _ in range(3):
            s, c, m = t.run_round(s, c)
        outs.append((s.params, float(m.byzantine_clients),
                     float(m.robust_trimmed)))
    for n in outs[0][0]:
        assert torch.equal(outs[0][0][n], outs[1][0][n])
    assert outs[0][1:] == outs[1][1:]


# -- the draws ----------------------------------------------------------------

def test_disarmed_fault_config_draws_todays_plans():
    """Every knob at its default: the plans hold no fault field and the
    generator stands where the fault-free drawer leaves it."""
    t = _port_trainer(fault=tcfg.FaultConfig(), rate=0.5)
    s, _ = t.init_state(0)
    drawer = t.plan_drawer()
    plain = drawer.__class__(**{**vars(drawer), "fault": None})
    g1, g2 = torch.Generator(), torch.Generator()
    g1.set_state(s.rng.get_state())
    g2.set_state(s.rng.get_state())
    for r in range(3):
        a, b = drawer(g1, r), plain(g2, r)
        for f in a._fields:
            x, y = getattr(a, f), getattr(b, f)
            assert (x is None) == (y is None), f
            if isinstance(x, torch.Tensor):
                assert torch.equal(x, y), f
        assert all(getattr(a, f) is None for f in (
            "u_crash", "u_strag", "u_nan", "u_avail", "u_drop",
            "byz_seed", "dp_seed", "noise"))
    assert torch.equal(g1.get_state(), g2.get_state())
    assert not isinstance(s.aux, dict)


def test_armed_draws_come_after_the_fault_free_ones():
    """Armed, the plan's cohort and rows are the fault-free plan's (the
    fault draws follow every other draw), and each class's uniforms
    exist only when its rate is above 0."""
    flt = tcfg.FaultConfig(client_drop_rate=0.2, nan_inject_rate=0.1,
                           byzantine_rate=0.25, byzantine_mode="gauss",
                           dp_noise_multiplier=1.0)
    t = _port_trainer(fault=flt, rate=0.5)
    ref = _port_trainer(rate=0.5)
    drawer, plain = t.plan_drawer(), ref.plan_drawer()
    for r in range(2):
        a, b = drawer(torch.Generator().manual_seed(r), r), \
            plain(torch.Generator().manual_seed(r), r)
        assert torch.equal(a.idx, b.idx) and torch.equal(a.rows, b.rows)
        assert a.u_crash.shape == a.u_nan.shape == (t.k_dispatch,)
        assert a.u_strag is None and a.u_avail is None
        assert isinstance(a.byz_seed, int) and isinstance(a.dp_seed, int)
