"""The async commit plane in the port against the JAX package's (the
twin of ``tests/test_async_plane.py``), on the CPU.

* The staleness weights: shapes, mean 1, composition with the guards'
  renormalization, against the JAX functions within 1e-6 relative.
* The event schedule: the port's ``AsyncSchedule`` fed the JAX
  scheduler's own streams (its jitted per-dispatch columns and its
  selection draws, through ``columns_fn``/``select_fn``) gives the JAX
  ``HostCommitPlan`` sequence exactly for 60 commits: ids, versions,
  dispatch ids, straggler flags, arrival times, the clamp, straggler and
  dropout counts and the staleness histogram; under the default model,
  the default model with dropout, and the trace model; in 'perm' and
  'sparse' modes. Fast-forward equals stepping.
* The commit: FedAvg, FedProx, FedAdam and SCAFFOLD (which reads the
  stale server control) on an MLP, the JAX commit program and the port's
  on the JAX scheduler's jobs and the JAX row plan's rows, four commits
  from the same weights: server params and aux, every ring slot and the
  clients' states within ``test_torch_zoo.py``'s 1e-5 of each tree's
  scale, the staleness and straggler metrics exactly. Quantized FedAvg
  (int8 both ways), each commit started from the JAX state, at the int8
  round's bars (``test_torch_round.py``).
* The port alone: the device plane and the stream plane bitwise, a
  resumed run bitwise an uninterrupted one, the supervisor's rollback
  resyncing the schedule, a cross-plane resume refused by name, and the
  refusals the JAX package keeps.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401 (two torch threads a worker)
from fedtorch_tpu import config as jcfg
from fedtorch_tpu.algorithms import make_algorithm as jmake
from fedtorch_tpu.async_plane import AsyncFederatedTrainer as JAsync
from fedtorch_tpu.async_plane import scheduler as jsched_mod
from fedtorch_tpu.async_plane import staleness as jstale
from fedtorch_tpu.async_plane.commit import _AsyncRowPlan
from fedtorch_tpu.data.batching import stack_partitions as jstack
from fedtorch_tpu.models import define_model as jdefine
from fedtorch_tpu.parallel.round_program import CommitJobs as JJobs
from fedtorch_tpu.robustness.availability import (
    make_availability_model as jmodel,
)
from fedtorch_tpu_torch import config as tcfg
from fedtorch_tpu_torch.algorithms import make_algorithm as tmake
from fedtorch_tpu_torch.async_plane import (
    ASYNC_ALGORITHMS, AsyncFederatedTrainer, AsyncSchedule,
    normalized_staleness_weights, staleness_weight,
)
from fedtorch_tpu_torch.async_plane.scheduler import (
    simulate_sync_round_times,
)
from fedtorch_tpu_torch.bridge import params_from_jax, params_to_jax
from fedtorch_tpu_torch.data.batching import stack_partitions as tstack
from fedtorch_tpu_torch.models import define_model as tdefine
from fedtorch_tpu_torch.parallel import FederatedTrainer, RoundPlan
from fedtorch_tpu_torch.parallel.round_program import CommitJobs
from fedtorch_tpu_torch.robustness.availability import (
    make_availability_model as tmodel,
)
from fedtorch_tpu_torch.robustness.guards import renormalize_accepted
from fedtorch_tpu_torch.robustness.supervisor import RoundSupervisor
from fedtorch_tpu_torch.utils.checkpoint import (
    maybe_resume, save_checkpoint,
)
from test_torch_zoo import _flat

STRAGGLER_HEAVY = dict(straggler_rate=0.4, straggler_step_frac=0.1)
REL = 1e-5  # test_torch_zoo.py's bar


# -- staleness weights --------------------------------------------------

@pytest.mark.parametrize("mode", ["const", "poly", "inv"])
@pytest.mark.parametrize("exponent", [0.5, 1.3])
def test_staleness_weights_are_the_jax_functions(mode, exponent):
    tau = np.asarray([0.0, 1.0, 3.0, 7.0, 2.0], np.float32)
    for fn_t, fn_j in ((staleness_weight, jstale.staleness_weight),
                       (normalized_staleness_weights,
                        jstale.normalized_staleness_weights)):
        np.testing.assert_allclose(
            fn_t(torch.from_numpy(tau), mode, exponent).numpy(),
            np.asarray(fn_j(jnp.asarray(tau), mode, exponent)), rtol=1e-6)
    # s(0) == 1, and an all-fresh commit keeps the sync weighting
    np.testing.assert_array_equal(
        normalized_staleness_weights(torch.zeros(5), mode).numpy(),
        np.ones(5))
    w = normalized_staleness_weights(torch.from_numpy(tau), mode, exponent)
    assert float(w.mean()) == pytest.approx(1.0, rel=1e-6)


def test_staleness_shapes_hand_computed_and_unknown_mode():
    tau = torch.tensor([0.0, 1.0, 3.0])
    np.testing.assert_allclose(staleness_weight(tau, "poly", 0.5).numpy(),
                               [1.0, 2.0 ** -0.5, 0.5], rtol=1e-6)
    np.testing.assert_allclose(staleness_weight(tau, "inv").numpy(),
                               [1.0, 0.5, 0.25], rtol=1e-6)
    with pytest.raises(ValueError, match="staleness_weight"):
        staleness_weight(tau, "linear")


def test_staleness_composes_with_the_guards_renormalization():
    """A rejected stale update hands back exactly its damped weight."""
    base = torch.tensor([0.25, 0.25, 0.5])
    weights = base * normalized_staleness_weights(
        torch.tensor([0.0, 4.0, 1.0]), "inv")
    accept = torch.tensor([1.0, 0.0, 1.0])
    out = renormalize_accepted({"w": torch.tensor([2.0])}, weights, accept)
    want = 2.0 * float(weights.sum()) / float((weights * accept).sum())
    assert float(out["w"][0]) == pytest.approx(want, rel=1e-6)
    assert float(weights[1]) < float(base[1])


# -- the event schedule --------------------------------------------------

MODELS = {
    "default": dict(STRAGGLER_HEAVY),
    "default_dropout": dict(STRAGGLER_HEAVY, avail_dropout_rate=0.15),
    "trace": dict(avail_model="trace", avail_dropout_rate=0.2,
                  avail_diurnal_period=6),
}


def _jax_schedule(fault_kw, mode, **kw):
    key = jax.random.key(7)
    return jsched_mod.AsyncSchedule(
        np.asarray(jax.random.key_data(key)), jax.random.key_impl(key),
        model=jmodel(jcfg.FaultConfig(**fault_kw)), participation_mode=mode,
        straggler_rate=fault_kw.get("straggler_rate", 0.0),
        straggler_step_frac=fault_kw.get("straggler_step_frac", 0.5), **kw)


def _port_schedule(fault_kw, mode, jsched=None, **kw):
    """The port's schedule; fed the JAX schedule's streams when given."""
    streams = {}
    if jsched is not None:
        def columns(d, c, v):
            with jsched._scope():
                return np.asarray(jax.device_get(jsched._delays_jit(
                    jsched._key, np.asarray(d, np.int32),
                    np.asarray(c, np.int32), np.asarray(v, np.int32))))

        def select(i):
            with jsched._scope():
                out = jax.device_get(jsched._select_jit(jsched._key,
                                                        np.int32(i)))
            return int(out) if mode == "sparse" else np.asarray(out)
        streams = dict(columns_fn=columns, select_fn=select)
    return AsyncSchedule(
        12345, model=tmodel(tcfg.FaultConfig(**fault_kw)),
        participation_mode=mode,
        straggler_rate=fault_kw.get("straggler_rate", 0.0),
        straggler_step_frac=fault_kw.get("straggler_step_frac", 0.5),
        **streams, **kw)


SCHED_KW = dict(num_clients=24, concurrency=8, buffer_size=3, ring_size=4)


def _assert_same_plan(tp, jp):
    assert tp.commit == jp.commit
    for f in ("idx", "version", "dispatch", "straggler", "arrival_times"):
        np.testing.assert_array_equal(getattr(tp, f), getattr(jp, f), f)
    assert tp.commit_time == jp.commit_time


@pytest.mark.parametrize("mode", ["perm", "sparse"])
@pytest.mark.parametrize("model", sorted(MODELS))
def test_the_schedule_on_the_jax_streams_is_the_jax_schedule(model, mode):
    fault_kw = MODELS[model]
    js = _jax_schedule(fault_kw, mode, **SCHED_KW)
    ts = _port_schedule(fault_kw, mode, jsched=js, **SCHED_KW)
    for _ in range(60):
        _assert_same_plan(ts.next_commit(), js.next_commit())
    assert tuple(ts.stats) == tuple(js.stats)
    assert ts.staleness_hist == js.staleness_hist
    assert ts.commit_times == js.commit_times
    st = ts.stats
    assert st.dispatches >= 60 * 3 + 8
    if model != "default":
        assert st.dropouts > 0
    assert st.stragglers > 0


@pytest.mark.parametrize("mode", ["perm", "sparse"])
def test_fast_forward_equals_stepping(mode):
    a = _port_schedule(MODELS["default_dropout"], mode, **SCHED_KW)
    for _ in range(9):
        a.next_commit()
    b = _port_schedule(MODELS["default_dropout"], mode, start_commit=9,
                       **SCHED_KW)
    assert tuple(a.stats) == tuple(b.stats)
    assert a.staleness_hist == b.staleness_hist
    c = a.clone()
    for _ in range(5):
        pa, pb = a.next_commit(), b.next_commit()
        _assert_same_plan(pa, pb)
        _assert_same_plan(c.next_commit(), pa)


def test_schedule_invariants_and_guards():
    s = _port_schedule(MODELS["default"], "perm", **SCHED_KW)
    seen_clamp = False
    for c in range(30):
        p = s.next_commit()
        assert p.commit == c and len(set(p.idx.tolist())) == 3
        assert (p.version <= c).all()
        assert (p.version >= max(c - 3, 0)).all()  # the ring window
        seen_clamp |= s.stats.staleness_clamped > 0
    assert sum(s.staleness_hist.values()) == 90
    with pytest.raises(ValueError, match="num_clients >= concurrency"):
        _port_schedule(MODELS["default"], "perm", num_clients=10,
                       concurrency=8, buffer_size=3, ring_size=4)
    times = simulate_sync_round_times(5, rounds=4, k_online=6,
                                      **STRAGGLER_HEAVY)
    assert times.shape == (4,) and (times >= 1.0).all()


# -- the commit against the JAX commit program ---------------------------

C, N, B, K = 12, 16, 8, 2


def _cfgs(algorithm="fedavg", quantized=False, plane="device",
          sync_mode="async", fault=None, **fed):
    def cfg(mod):
        return mod.ExperimentConfig(
            data=mod.DataConfig(dataset="synthetic", batch_size=B,
                                data_plane=plane),
            federated=mod.FederatedConfig(
                federated=True, num_clients=C, online_client_rate=0.5,
                sync_type="local_step", algorithm=algorithm,
                sync_mode=sync_mode, quantized=quantized, **fed),
            model=mod.ModelConfig(arch="mlp", mlp_hidden_size=32),
            optim=mod.OptimConfig(lr=0.1, in_momentum=algorithm
                                  != "scaffold"),
            train=mod.TrainConfig(local_step=K),
            fault=mod.FaultConfig(**(STRAGGLER_HEAVY if fault is None
                                     else fault))).finalize()
    return cfg(jcfg), cfg(tcfg)


def _population():
    rng = np.random.RandomState(0)
    x = rng.randn(C * N, 60).astype(np.float32)
    y = rng.randint(0, 10, C * N)
    return x, y, [np.arange(i * N, (i + 1) * N) for i in range(C)]


def _pair(algorithm, quantized=False):
    jc, tc = _cfgs(algorithm, quantized)
    jtr = JAsync(jc, jdefine(jc, batch_size=B), jmake(jc),
                 jstack(*_population()))
    js, jcl = jtr.init_state(jax.random.key(0))
    ttr = AsyncFederatedTrainer(tc, tdefine(tc, batch_size=B, device="cpu"),
                                tmake(tc), tstack(*_population()),
                                device="cpu")
    ts, tcl = ttr.init_state(0)
    return jtr, js, jcl, ttr, _copy_in(js, jcl, ts, tcl, ttr), tcl


def _np_rows(tree):
    return {n: np.asarray(v) for n, v in _flat(tree).items()}


def _copy_in(js, jcl, ts, tcl, ttr):
    """The JAX state into the port's: server params, the ring's params,
    and every client's params, momentum buffer, epoch and local index
    (the server and ring aux of the four algorithms start at zeros in
    both packages)."""
    module = ttr.model.module

    def rows_into(jtree, dst, n_rows):
        flat = _np_rows(jtree)
        for r in range(n_rows):
            row = params_from_jax({k: v[r] for k, v in flat.items()},
                                  module=module)
            for n, v in row.items():
                dst[n][r] = v

    params = params_from_jax(_flat(js.params), expect=ts.params,
                             module=module)
    ring = ts.aux["ring"]["params"]
    rows_into(js.aux["ring"]["params"], ring, ttr.snapshot_ring)
    rows_into(jcl.params, tcl.params, C)
    if getattr(jcl.opt, "in_buf", None) is not None:
        rows_into(jcl.opt.in_buf, tcl.opt.in_buf, C)
    tcl.epoch[:] = torch.from_numpy(np.array(jcl.epoch)[:C])
    tcl.local_index[:] = torch.from_numpy(np.array(jcl.local_index)[:C])
    return ts._replace(params=params)


def _jax_commits(jtr, js, n):
    """The JAX trainer's first ``n`` commits' jobs and rows, from its own
    scheduler and row plan."""
    key_data, key_impl, commit0 = jtr._server_key_state(js)
    sched = jsched_mod.AsyncSchedule(key_data, key_impl,
                                     start_commit=commit0,
                                     **jtr._schedule_args())
    rows_fn = _AsyncRowPlan(key_data, key_impl, jtr.data.x.shape[1],
                            jtr.local_steps * jtr.batch_size,
                            np.asarray(jtr.data.sizes))
    out = []
    for _ in range(n):
        p = sched.next_commit()
        out.append((JJobs(idx=p.idx, version=p.version, dispatch=p.dispatch,
                          straggler=p.straggler),
                    rows_fn(p.dispatch, p.idx)))
    return out


def _port_plan(jobs, rows):
    m = len(jobs.idx)
    idx = torch.from_numpy(np.asarray(jobs.idx, np.int64))
    return RoundPlan(
        idx, torch.from_numpy(np.asarray(rows, np.int64)),
        # the straggler uniforms a commit draws: its step cut is
        # neutralized, so any values give the same commit
        u_strag=torch.zeros(m),
        jobs=CommitJobs(
            idx=idx, version=torch.from_numpy(np.asarray(jobs.version,
                                                         np.int64)),
            dispatch=torch.from_numpy(np.asarray(jobs.dispatch, np.int64)),
            straggler=torch.from_numpy(np.asarray(jobs.straggler))))


def _jax_names(module, ref):
    """Each port leaf's JAX path (one leaf at a time through the
    bridge)."""
    return {n: next(iter(params_to_jax({n: p}, module)))
            for n, p in ref.items()}


def _assert_params_tree(jtree, ttree, module, lead=None, rel=REL,
                        where="", ref=None):
    """A params-keyed tree (with a leading axis of ``lead`` rows, or
    none) within ``rel`` of its largest |value|; a tree of one scalar a
    leaf (FedAdam's v) by the leaves' JAX names."""
    flat = _np_rows(jtree)
    rows = range(lead) if lead else [None]
    for r in rows:
        want = flat if r is None else {k: v[r] for k, v in flat.items()}
        row = ttree if r is None else {n: v[r] for n, v in ttree.items()}
        if ref is not None and all(v.dim() == 0 for v in row.values()):
            names = _jax_names(module, ref)
            got = {names[n]: v.numpy() for n, v in row.items()}
        else:
            got = params_to_jax(row, module)
        scale = max(float(np.abs(w).max()) for w in want.values())
        for k, w in want.items():
            err = float(np.abs(got[k].astype(np.float64) - w).max())
            assert err <= rel * max(scale, 1e-30), (where, r, k, err,
                                                     scale)


def _assert_aux(jaux, taux, ref, module, lead=None, where="aux"):
    if isinstance(taux, dict) and set(taux) == set(ref):
        _assert_params_tree(jaux, taux, module, lead, where=where, ref=ref)
        return
    if isinstance(taux, dict):
        assert set(jaux) == set(taux), where
        for key in taux:
            _assert_aux(jaux[key], taux[key], ref, module, lead,
                        f"{where}/{key}")
        return
    assert taux == () and jaux in ((), None, {}), where


@pytest.mark.parametrize("algorithm", ASYNC_ALGORITHMS)
def test_commits_match_the_jax_commit_program(algorithm):
    jtr, js, jcl, ttr, ts, tcl = _pair(algorithm)
    module = ttr.model.module
    assert ttr.buffer_size == jtr.buffer_size == 3
    staleness = []
    for jobs, rows in _jax_commits(jtr, js, 4):
        js, jcl, jm = jtr._commit_jit(js, jcl, jobs, jtr.data)
        ts, tcl, tm = ttr.round_fn(ts, tcl, _port_plan(jobs, rows))
        assert float(tm.staleness_mean) == float(jm.staleness_mean)
        assert float(tm.straggler_clients) == float(jm.straggler_clients)
        np.testing.assert_array_equal(tm.online_mask.numpy(),
                                      np.asarray(jm.online_mask))
        np.testing.assert_allclose(tm.train_loss.numpy(),
                                   np.asarray(jm.train_loss), rtol=1e-4,
                                   atol=1e-6)
        staleness.append(float(tm.staleness_mean))
        _assert_params_tree(js.params, ts.params, module, where="params")
        _assert_params_tree(js.aux["ring"]["params"],
                            ts.aux["ring"]["params"], module,
                            lead=ttr.snapshot_ring, where="ring")
        _assert_aux(js.aux["alg"], ts.aux["alg"]["alg"], ts.params, module)
        _assert_aux(js.aux["ring"]["aux"], ts.aux["ring"]["aux"]["alg"],
                    ts.params, module, lead=ttr.snapshot_ring,
                    where="ring_aux")
        _assert_params_tree(jcl.params, tcl.params, module, lead=C,
                            where="clients")
        _assert_aux(jcl.aux, tcl.aux, ts.params, module, lead=C,
                    where="client_aux")
    assert ts.round == 4 and max(staleness) > 0  # stale jobs committed


def test_quantized_fedavg_commits_match_from_the_jax_state():
    """int8 both ways: each commit from the JAX state (a one-step flip
    of a quantized value moves the next commit's start), its update
    within 1e-3 relative L2 and two downlink steps element-wise."""
    jtr, js, jcl, ttr, ts, tcl = _pair("fedavg", quantized=True)
    module = ttr.model.module
    for jobs, rows in _jax_commits(jtr, js, 3):
        ts = _copy_in(js, jcl, ts, tcl, ttr)
        jp0 = _np_rows(js.params)
        js, jcl, jm = jtr._commit_jit(js, jcl, jobs, jtr.data)
        ts, tcl, tm = ttr.round_fn(ts, tcl, _port_plan(jobs, rows))
        jp, tp = _np_rows(js.params), params_to_jax(ts.params, module)
        ju = np.concatenate([(jp[k] - jp0[k]).ravel() for k in jp])
        tu = np.concatenate([(tp[k] - jp0[k]).ravel() for k in jp])
        assert np.linalg.norm(tu - ju) <= 1e-3 * np.linalg.norm(ju)
        for k in jp:
            u = jp[k] - jp0[k]
            step = (u.max() - u.min()) / 255.0
            assert np.abs((tp[k] - jp0[k]) - u).max() <= 2 * step + 1e-7, k
        assert float(tm.staleness_mean) == float(jm.staleness_mean)


# -- the port alone --------------------------------------------------------

def _trainer(algorithm="fedavg", plane="device", **kw):
    _, tc = _cfgs(algorithm, plane=plane, **kw)
    cls = AsyncFederatedTrainer if tc.federated.sync_mode == "async" \
        else FederatedTrainer
    t = cls(tc, tdefine(tc, batch_size=B, device="cpu"), tmake(tc),
            tstack(*_population()), device="cpu")
    t.stream_timeout_s = 20.0
    return t


def _commits(t, n, seed=0, server=None, clients=None):
    if server is None:
        server, clients = t.init_state(seed)
    for _ in range(n):
        server, clients, m = t.run_round(server, clients)
    return server, clients, m


def _assert_bitwise(a, b):
    (sa, ca), (sb, cb) = a, b
    assert sa.round == sb.round
    for n in sa.params:
        assert torch.equal(sa.params[n], sb.params[n]), n
        assert torch.equal(ca.params[n], cb.params[n]), n
        assert torch.equal(sa.aux["ring"]["params"][n],
                           sb.aux["ring"]["params"][n]), n
    assert torch.equal(sa.rng.get_state(), sb.rng.get_state())


@pytest.mark.parametrize("algorithm", ["fedavg", "scaffold"])
def test_device_and_stream_planes_are_bitwise(algorithm):
    runs = []
    for plane in ("device", "stream"):
        t = _trainer(algorithm, plane)
        s, c, m = _commits(t, 4)
        runs.append(((s, c), t.staleness_histogram(), m))
        t.close()
    _assert_bitwise(runs[0][0], runs[1][0])
    assert float(runs[0][2].staleness_mean) == \
        float(runs[1][2].staleness_mean)


@pytest.mark.parametrize("plane", ["device", "stream"])
def test_a_resumed_run_is_bitwise_the_uninterrupted_one(plane, tmp_path):
    ref = _trainer(plane=plane)
    want = _commits(ref, 5)[:2]
    ref.close()
    t = _trainer(plane=plane)
    s, c, _ = _commits(t, 2)
    save_checkpoint(str(tmp_path), s, c, t.cfg, 0.0, False)
    t.close()
    t2 = _trainer(plane=plane)
    s, c = t2.init_state(99)  # another seed: all of it comes from disk
    s, c, _, resumed = maybe_resume(str(tmp_path), s, c, t2.cfg)
    assert resumed and s.round == 2
    got = _commits(t2, 3, server=s, clients=c)[:2]
    t2.close()
    _assert_bitwise(want, got)


@pytest.mark.parametrize("plane", ["device", "stream"])
def test_the_supervisor_s_rollback_resyncs_the_schedule(plane):
    """A rollback (``invalidate_stream``) mid-run drops the schedule;
    the next commit rebuilds it from the restored commit and the run
    goes on bitwise. Under the supervisor, a commit that raised is
    rolled back and retried on the same jobs, bitwise."""
    ref = _trainer(plane=plane)
    want = _commits(ref, 4)[:2]
    ref.close()
    t = _trainer(plane=plane)
    s, c = t.init_state(0)
    for i in range(4):
        s, c, _ = t.run_round(s, c)
        if i == 1:
            t.invalidate_stream()
    t.close()
    _assert_bitwise(want, (s, c))

    # a commit that raises once: rolled back, retried on the same jobs
    # and draws (no reseed), and the run goes on bitwise
    t = _trainer(plane=plane, fault=dict(STRAGGLER_HEAVY, max_retries=1,
                                         reseed_on_retry=False))
    sup = RoundSupervisor(t, sleep_fn=lambda _: None)
    name = "round_fn" if plane == "device" else "round_stream_fn"
    real, calls = getattr(t, name), []

    def flaky(server, clients, *args):
        calls.append(server.round)
        if len(calls) == 2:
            raise RuntimeError("injected")
        return real(server, clients, *args)
    setattr(t, name, flaky)
    s, c = t.init_state(0)
    for _ in range(4):
        s, c, _ = sup.run_round(s, c)
    t.close()
    assert sup.stats.rollbacks == 1 and calls == [0, 1, 1, 2, 3]
    _assert_bitwise(want, (s, c))


def test_supervised_commits_are_bitwise_the_plain_ones():
    """The supervisor's snapshot learns each commit's clients from a
    clone of the schedule (``peek_plan``), never taking a commit from
    the live one."""
    ref = _trainer()
    want = _commits(ref, 4)[:2]
    t = _trainer(fault=dict(STRAGGLER_HEAVY))
    sup = RoundSupervisor(t, sleep_fn=lambda _: None)
    s, c = t.init_state(0)
    for _ in range(4):
        s, c, _ = sup.run_round(s, c)
    _assert_bitwise(want, (s, c))
    assert sup.stats.rollbacks == 0


def test_a_cross_plane_resume_is_refused_by_name(tmp_path):
    t = _trainer(sync_mode="sync", fault={})
    s, c = t.init_state(0)
    save_checkpoint(str(tmp_path), s, c, t.cfg, 0.0, False)
    t2 = _trainer(fault={})
    s2, c2 = t2.init_state(0)
    with pytest.raises(ValueError, match="sync_mode"):
        maybe_resume(str(tmp_path), s2, c2, t2.cfg)


@pytest.mark.parametrize("kw, match", [
    (dict(algorithm="qffl"), "unsupported for algorithm 'qffl'"),
    (dict(algorithm="fedgate"), "unsupported for algorithm 'fedgate'"),
    (dict(async_buffer_size=8, async_concurrency=4),
     "exceeds the in-flight concurrency"),
    (dict(async_concurrency=10), "must be >= concurrency"),
])
def test_the_remaining_refusals_name_themselves(kw, match):
    alg = kw.pop("algorithm", "fedavg")
    with pytest.raises(ValueError, match=match):
        _trainer(alg, **kw)


def test_run_rounds_and_the_base_trainer_refuse_the_commit_plane():
    t = _trainer()
    s, c = t.init_state(0)
    with pytest.raises(ValueError, match="no R-commit program"):
        t.run_rounds(s, c, 2)
    _, tc = _cfgs()
    with pytest.raises(ValueError, match="round-synchronous"):
        FederatedTrainer(tc, tdefine(tc, batch_size=B, device="cpu"),
                         tmake(tc), tstack(*_population()), device="cpu")
    assert ASYNC_ALGORITHMS == ("fedavg", "fedprox", "fedadam", "scaffold")


def test_gauges_histogram_and_sparse_width():
    t = _trainer(participation_mode="sparse")
    s, c, m = _commits(t, 3)
    assert m.train_loss.shape == (t.buffer_size,) == (3,)
    g = t.telemetry_gauges()
    assert g["async_buffer"] == 3.0 and g["async_dispatches"] >= 15
    hist = t.staleness_histogram()
    assert sum(hist.values()) == 9
    t.invalidate_stream()
    assert t.staleness_histogram() == hist  # kept across the teardown
    assert t.schedule_stats is None


def test_dp_under_the_ring_noises_at_the_commit_s_width_and_degrades():
    """DP-FedAvg on the commit plane: sigma at the buffer's width m (the
    JAX package's ``dp_k``), and the budget's 'degrade' reaches the noise
    scale through the ring's wrap."""
    from fedtorch_tpu_torch.robustness.privacy import dp_noise_stddev
    t = _trainer(fault=dict(STRAGGLER_HEAVY, dp_noise_multiplier=1.0,
                            dp_clip_norm=1.0))
    s, c, m = _commits(t, 1)
    want = float(dp_noise_stddev(1.0, 1.0, t.buffer_size))
    assert float(m.dp_noise_sigma) == pytest.approx(want, rel=1e-6)
    s = t.dp_set_noise_scale(s, 0.0)
    assert set(s.aux) == {"alg", "ring"}
    s, c, m = t.run_round(s, c)
    assert float(m.dp_noise_sigma) == 0.0 and s.round == 2
