"""Client sharding (``parallel/podscale.py``, ``parallel/mesh.py``): the
port against the JAX package, and the port's S-shard rounds against its
own S=1 twin, on the CPU.

* **Against the JAX package**, on numpy inputs from a seed:
  ``cohort_group_count`` and ``cohort_allreduce_bytes`` equal, the grouped
  sum at S=1 bitwise for k in {2, 4, 8, 10, 12, 128} (128 reaches the cap
  of 64 groups), the armed S=1 round of the JAX package's
  ``tests/test_podscale.py`` cell (synthetic 16 features,
  ``logistic_regression``, 8 clients at rate 0.5, batch 8, 2 local
  steps) within the port's round bars of the JAX armed twin on the JAX
  plans (``test_torch_zoo.py``'s ``REL`` of the largest |param|, losses
  rtol 1e-4 / atol 1e-6), also with the update guards and with the
  'gauss' attack (the JAX normals replayed through the plan's
  ``noise``), every client-shard refusal in the JAX text, and the owner
  rule of the client axis against ``padded_client_count`` and the
  placement of ``client_sharding``.
* **S-invariance**, the JAX package's own bars (its S > 1 tests fail
  under the installed JAX, its S=1 twin runs): two spawned gloo groups,
  world 2 and world 4 (``tests/torch_dist.py``: a ``FileStore`` under
  the test's temporary directory, ranks at one thread, a 60 s collective
  timeout). Each rank builds the trainer at S and at S=1 and runs both;
  the six cells {resident, feed} x {round, scan, commit} at S in {2, 4},
  the guards (reject, clip) and the 'gauss' attack at S in {2, 4}, a
  fault-and-DP cell and SCAFFOLD at S=2, replicas at world 4 and S=2,
  and a checkpoint taken at S=4 resumed at S=2 must come out bitwise
  their S=1 twin: server params and aux, client state, metrics and the
  generator. The client state is sharded over the ranks: each rank's
  trees hold its ``C_pad/W`` rows, and the ranks' rows together are
  bitwise the state of the same run in one process. Each sharded round
  issues exactly ``collective_budget`` seam collectives (one
  ``all_gather``), one exchange and, with the guards on, one norm
  gather. A checkpoint written at S=2 loads in one process.
"""
import functools

import jax
import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401 (two torch threads a worker)
from torch_dist import Group, pod_cfg, pod_trainer
from fedtorch_tpu import config as jcfg
from fedtorch_tpu.algorithms import make_algorithm as jmake
from fedtorch_tpu.data import build_federated_data as jbuild
from fedtorch_tpu.models import define_model as jdefine
from fedtorch_tpu.parallel import FederatedTrainer as JTrainer
from fedtorch_tpu.parallel import podscale as jpod
from fedtorch_tpu.parallel import round_program as jrp
from fedtorch_tpu.parallel.mesh import make_mesh as jmake_mesh
from fedtorch_tpu_torch import config as tcfg
from fedtorch_tpu_torch.algorithms import make_algorithm as tmake
from fedtorch_tpu_torch.bridge import params_from_jax
from fedtorch_tpu_torch.models import define_model as tdefine
from fedtorch_tpu_torch.parallel import podscale as tpod
from fedtorch_tpu_torch.parallel import round_program as trp
from test_torch_chaos import _fault_plans, _jax_cohort
from test_torch_zoo import REL, _flat, _plans

KS = (2, 4, 8, 10, 12, 128)
CELLS = [(s, d) for s in ("resident", "feed")
         for d in ("round", "scan", "commit")]
FAULTS = dict(client_drop_rate=0.3, nan_inject_rate=0.2, byzantine_rate=0.3,
              byzantine_mode="sign_flip", dp_noise_multiplier=0.5,
              dp_clip_norm=0.05)
# the update guards judging a 'gauss' attack, and the attack alone
GUARDED = dict(byzantine_rate=0.3, byzantine_mode="gauss",
               byzantine_scale=1.0, guard_updates=True)
FAULT_SETS = {
    "faults": FAULTS,
    "guards_reject": GUARDED,
    "guards_clip": dict(GUARDED, guard_mode="clip"),
    "gauss": dict(GUARDED, guard_updates=False),
}
GUARD_CELLS = [("resident", "round"), ("feed", "commit")]
KEYS = ("params", "aux", "clients", "metrics", "rng")


def _payloads(k, seed=0):
    rng = np.random.RandomState(seed)
    return {"w": (rng.randn(k, 5, 3)
                  * 10.0 ** rng.uniform(-3, 3, (k, 1, 1))).astype(np.float32),
            "b": rng.randn(k).astype(np.float32),
            "n": rng.randint(0, 9, (k,)).astype(np.int32)}


# -- against the JAX package ---------------------------------------------------
@pytest.mark.parametrize("k", KS + (1, 3, 64, 96, 256))
def test_group_count_and_gather_bytes_are_the_jax_package_s(k):
    assert tpod.cohort_group_count(k) == jpod.cohort_group_count(k)
    p = _payloads(k)
    assert tpod.cohort_allreduce_bytes(
        {n: torch.from_numpy(v) for n, v in p.items()}, k) \
        == jpod.cohort_allreduce_bytes(p, k)
    with pytest.raises(ValueError, match="cohort width must be positive"):
        tpod.cohort_group_count(0)


@pytest.mark.parametrize("k", KS)
def test_one_shard_sum_is_bitwise_the_jax_function(k):
    p = _payloads(k, seed=k)
    mesh = jmake_mesh(jcfg.MeshConfig(client_shards=1))
    want = jax.tree.map(np.asarray, jax.jit(
        lambda q: jpod.cohort_hierarchical_sum(q, mesh, 1))(p))
    got = tpod.cohort_hierarchical_sum(
        {n: torch.from_numpy(v) for n, v in p.items()})
    for n in p:
        assert got[n].dtype == torch.from_numpy(np.array(want[n])).dtype
        np.testing.assert_array_equal(got[n].numpy(), want[n])


def test_one_shard_sum_issues_no_collective():
    tpod.reset_collective_count()
    tpod.cohort_hierarchical_sum(
        {n: torch.from_numpy(v) for n, v in _payloads(8).items()})
    assert tpod.collective_count() == 0


def _jax_twin(fault=None, monkeypatch=None):
    """The JAX package's armed S=1 twin under the faults of
    ``FAULT_SETS[fault]`` (None: none): its weights, the plans replayed
    from its key chain (the fault planes' draws and the gauss attack's
    normals too), and two rounds' server params and metrics. With an
    armed byzantine rate ``monkeypatch`` gives the port the JAX run's
    byzantine cohort."""
    kw = FAULT_SETS[fault] if fault is not None else None
    jc = pod_cfg("resident", "round", 1, mod=jcfg, fault_kw=kw)
    jtr = JTrainer(jc, jdefine(jc, batch_size=8), jmake(jc), jbuild(jc).train)
    assert jtr.podscale_armed and jtr.client_shards == 1
    js, jcl = jtr.init_state(jax.random.key(3))
    weights = _flat(js.params)
    ttr = pod_trainer(pod_cfg("resident", "round", 1, fault_kw=kw))
    if monkeypatch is not None:
        _jax_cohort(monkeypatch, js, jtr.num_clients)
    plans = _plans(jtr, js, 2) if fault is None \
        else _fault_plans(jtr, js, 2, ttr)
    rounds = []
    for _ in range(2):
        js, jcl, jm = jtr.run_round(js, jcl)
        rounds.append((_flat(js.params), jax.tree.map(np.asarray, jm)))
    return ttr, weights, plans, rounds


def test_armed_one_shard_round_matches_the_jax_armed_twin():
    _check_armed_twin(None, None)


@pytest.mark.parametrize("fault", ["guards_reject", "gauss"],
                         ids=["guards", "gauss"])
def test_armed_one_shard_fault_round_matches_the_jax_armed_twin(
        fault, monkeypatch):
    """The update guards judging a 'gauss' attack, and the attack alone:
    the counters equal, the bars of the plain round."""
    _check_armed_twin(fault, monkeypatch)


def _check_armed_twin(fault, monkeypatch):
    ttr, weights, plans, rounds = _jax_twin(
        fault, monkeypatch if fault is not None else None)
    assert ttr.podscale_armed and ttr.client_shards == 1
    ts, tcl = ttr.init_state(3)
    ts = ts._replace(params=params_from_jax(weights, expect=ts.params,
                                            module=ttr.model.module))
    for n, p in tcl.params.items():
        p[:] = ts.params[n]
    counts = []
    for plan, (jparams, jm) in zip(plans, rounds):
        ts, tcl, tm = ttr.round_fn(ts, tcl, plan)
        for f in ("byzantine_clients", "rejected_updates",
                  "clipped_updates"):
            assert float(getattr(tm, f)) == float(getattr(jm, f)), f
        counts.append(float(tm.byzantine_clients)
                      + float(tm.rejected_updates))
        np.testing.assert_array_equal(tm.online_mask.numpy(),
                                      jm.online_mask)
        np.testing.assert_allclose(tm.train_loss.numpy(), jm.train_loss,
                                   rtol=1e-4, atol=1e-6)
        got = params_from_jax(jparams, expect=ts.params,
                              module=ttr.model.module)
        scale = max(float(v.abs().max()) for v in got.values())
        for n, v in ts.params.items():
            assert float((v - got[n]).abs().max()) <= REL * scale, n
    # the attack reached the round, and the guards judged it
    assert (sum(counts) > 0) == (fault is not None)
    assert ttr.telemetry_gauges()["cohort_allreduce_bytes"] == \
        jpod.cohort_allreduce_bytes(
            {n: np.zeros((4,) + tuple(v.shape), np.float32)
             for n, v in ts.params.items()}, 4)


# -- refusals ------------------------------------------------------------------
REFUSALS = {
    "fused": (dict(source="resident", dispatch="round", shards=2),
              dict(execution="fused"),
              "until a sharded grouped-conv lowering is measured"),
    "cohort_width": (dict(source="resident", dispatch="round", shards=4,
                          num_clients=12), {},
                     "does not divide the dispatch cohort width"),
    "robust_agg": (dict(source="resident", dispatch="round", shards=2,
                        fault_kw=dict(robust_agg="median")), {},
                   "robust_agg"),
    "cohort_stats": (dict(source="feed", dispatch="round", shards=2,
                          telemetry_kw=dict(cohort_stats=True)), {},
                     "cohort_stats"),
    "algorithm": (dict(source="resident", dispatch="round", shards=2,
                       algorithm="qffl"), {}, "not certified"),
    "personal": (dict(source="resident", dispatch="round", shards=2,
                      algorithm="fedavg"), dict(has_val=True),
                 "per-client validation splits"),
    "commit_buffer": (dict(source="resident", dispatch="commit", shards=2,
                           buffer_size=3), {}, "async commit buffer"),
}


def _reason(mod, make, define, facts, extra):
    cfg = pod_cfg(mod=mod, **facts)
    k = max(int(cfg.federated.online_client_rate
                * cfg.federated.num_clients), 1)
    kw = dict(cfg=cfg, algorithm=make(cfg),
              model=define(cfg, batch_size=8) if mod is jcfg
              else define(cfg, batch_size=8, device="cpu"),
              mesh_devices=extra.get("mesh_devices", 1), k_online=k,
              has_val=extra.get("has_val", False))
    return (jrp if mod is jcfg else trp).illegal_reason(
        facts["source"], facts["dispatch"], extra.get("execution", "vmap"),
        **kw)


@pytest.mark.parametrize("name", sorted(REFUSALS))
def test_client_shard_refusals_are_the_jax_text(name):
    facts, extra, words = REFUSALS[name]
    want = _reason(jcfg, jmake, jdefine, facts, extra)
    got = _reason(tcfg, tmake, tdefine, facts, extra)
    assert want is not None and words in want
    assert got == want


def test_a_refused_cohort_width_raises_at_construction():
    with pytest.raises(ValueError,
                       match="does not divide the dispatch cohort width"):
        pod_trainer(pod_cfg("resident", "round", 4, num_clients=12))


def _port_reason(shards, devices, **facts):
    cfg = pod_cfg("resident", "round", shards, **facts)
    return trp.illegal_reason(
        "resident", "round", "vmap", cfg=cfg, algorithm=tmake(cfg),
        model=tdefine(cfg, batch_size=8, device="cpu"),
        mesh_devices=devices, k_online=4)


@pytest.mark.parametrize("fault_kw", [
    dict(guard_updates=True), dict(guard_updates=True, guard_mode="clip"),
    dict(byzantine_rate=0.5, byzantine_mode="gauss")],
    ids=["guards", "guards_clip", "gauss"])
def test_guards_and_gauss_are_served_under_client_shards(fault_kw):
    for shards, devices in ((2, 2), (4, 4), (2, 4), (1, 2), (1, 1)):
        assert _port_reason(shards, devices, fault_kw=fault_kw) is None


def test_collude_under_client_shards_is_refused_by_name():
    """'collude' crafts the honest mean of the whole cohort before the
    wire; a rank holds k/S rows of it, so the port refuses it where the
    cohort is split (it ran on the rank's rows alone before)."""
    fault_kw = dict(byzantine_rate=0.5, byzantine_mode="collude")
    reason = _port_reason(2, 2, fault_kw=fault_kw)
    assert "byzantine_mode='collude'" in reason and "ROADMAP A10" in reason
    for shards, devices in ((1, 2), (1, 1)):
        assert _port_reason(shards, devices, fault_kw=fault_kw) is None


@pytest.mark.parametrize("facts", [dict(algorithm="qffl"),
                                   dict(algorithm="apfl")],
                         ids=["qffl", "apfl"])
def test_population_readers_at_one_shard_are_served_on_ranks(facts):
    """At S=1 on several ranks the population and the client state are
    sharded; the exchange brings the rows an algorithm reads of them
    (``tests/test_torch_flat_mesh.py`` runs them bitwise), so the
    validator serves them there as in one process."""
    assert _port_reason(1, 2, **facts) is None
    assert _port_reason(1, 1, **facts) is None


@pytest.mark.parametrize("world", [1, 2, 4, 8])
@pytest.mark.parametrize("clients", [8, 100, 101])
def test_the_owner_rule_is_the_jax_placement(clients, world):
    """``padded_client_count`` of a stub mesh of ``world`` devices, and
    the rows ``client_sharding`` puts on each device of the ``[S,
    W/S]`` mesh (row-major, the port's rank order) at every S."""
    from types import SimpleNamespace

    from fedtorch_tpu.parallel import mesh as jmesh
    from fedtorch_tpu_torch.parallel import mesh as tmesh
    stub = SimpleNamespace(devices=np.empty(world))
    pad = jmesh.padded_client_count(clients, stub)
    assert tmesh.padded_client_count(clients, world) == pad
    per = pad // world
    for rank in range(world):
        lo, hi = tmesh.owned_client_rows(clients, world, rank)
        assert (lo, hi) == (rank * per, (rank + 1) * per)
        for c in range(lo, min(hi, clients)):
            assert tmesh.client_owner(c, clients, world) == rank
    devices = np.asarray(jax.devices()[:world])
    for shards in [s for s in (1, 2, 4, 8) if world % s == 0]:
        m = jax.sharding.Mesh(devices.reshape(shards, world // shards),
                              ("clients", "clients_rep"))
        where = jmesh.client_sharding(m).devices_indices_map((pad,))
        for rank, d in enumerate(m.devices.reshape(-1)):
            sl = where[d][0]
            assert (sl.start or 0, sl.stop or pad) == \
                tmesh.owned_client_rows(clients, world, rank)


def test_several_ranks_without_client_shards_are_served():
    """The JAX package's 1-D mesh (``tests/test_torch_flat_mesh.py``
    runs it); the fused execution there keeps the JAX refusal."""
    cfg = pod_cfg("resident", "round", 0)
    kw = dict(cfg=cfg, algorithm=tmake(cfg),
              model=tdefine(cfg, batch_size=8, device="cpu"),
              mesh_devices=2, k_online=4)
    assert trp.illegal_reason("resident", "round", "vmap", **kw) is None
    assert "mesh has 2 devices" in trp.illegal_reason(
        "resident", "round", "fused", **kw)


@pytest.mark.parametrize("shards, devices, want", [
    (0, 1, 0), (1, 1, 0), (2, 2, 1), (4, 4, 1)])
def test_collective_budget_is_the_jax_package_s(shards, devices, want):
    for source, dispatch in CELLS:
        kw = dict(mesh_devices=devices, num_rounds=2, client_shards=shards)
        got = trp.collective_budget(source, dispatch, "vmap", **kw)
        assert got == jrp.collective_budget(source, dispatch, "vmap", **kw)
        assert got == want


@pytest.mark.parametrize("shards", [0, 1])
def test_unsharded_rounds_issue_no_collective(shards):
    from torch_dist import pod_run
    got = pod_run(pod_trainer(pod_cfg("resident", "round", shards)),
                  "round")
    assert got["collectives"] == [trp.collective_budget(
        "resident", "round", "vmap", mesh_devices=1,
        client_shards=shards)] * 2
    assert ("client_shards" in got["gauges"]) == (shards == 1)


# -- S-invariance over gloo ----------------------------------------------------
def _case_table(world):
    table = {"sum": ("podscale_sum", dict(shards=world, k=8, seed=world))}
    for source, dispatch in CELLS:
        table[f"{source}-{dispatch}"] = ("podscale_cell", dict(
            source=source, dispatch=dispatch, shards=world))
    for fault in ("guards_reject", "guards_clip", "gauss"):
        for source, dispatch in GUARD_CELLS:
            table[f"{fault}-{source}-{dispatch}"] = ("podscale_cell", dict(
                source=source, dispatch=dispatch, shards=world,
                fault_kw=FAULT_SETS[fault]))
    if world == 2:
        table["faults"] = ("podscale_cell", dict(
            source="resident", dispatch="round", shards=2,
            fault_kw=FAULTS))
        table["scaffold"] = ("podscale_cell", dict(
            source="feed", dispatch="round", shards=2,
            algorithm="scaffold"))
        table["torn"] = ("podscale_torn", {})
        table["save"] = ("podscale_save", {})
        table["supervisor"] = ("podscale_supervisor", {})
        # K*B = 800 plan rows a client, n_max 800: the exchange ships
        # each client's whole shard
        table["whole_shard"] = ("podscale_cell", dict(
            source="resident", dispatch="round", shards=2, local_step=100))
    else:
        table["replicas"] = ("podscale_cell", dict(
            source="resident", dispatch="round", shards=2))
        table["resume"] = ("podscale_resume", {})
    return table


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    started = {}
    for world in (2, 4):
        d = tmp_path_factory.mktemp(f"pod{world}")
        cases = []
        for name, (fn, kw) in _case_table(world).items():
            if fn in ("podscale_torn", "podscale_resume", "podscale_save"):
                kw = dict(kw, store_dir=str(d))
            cases.append((name, fn, kw))
        started[world] = Group(world, cases, d)
        started[world].store_dir = d
    yield started
    for g in started.values():
        if g.results is None:
            g.results = g._collect()


def _leaves(x, out=None):
    out = [] if out is None else out
    if isinstance(x, dict):
        for v in x.values():
            _leaves(v, out)
    elif isinstance(x, (list, tuple)):
        for v in x:
            _leaves(v, out)
    elif isinstance(x, np.ndarray):
        out.append(x)
    return out


def _assert_bitwise(got, want):
    a, b = _leaves(got), _leaves(want)
    assert len(a) == len(b) and a
    for x, y in zip(a, b):
        assert x.shape == y.shape
        np.testing.assert_array_equal(x, y)


def _assert_twin(run, twin, rounds=slice(None)):
    _assert_bitwise([run[k] for k in KEYS[:3]], [twin[k] for k in KEYS[:3]])
    _assert_bitwise(run["metrics"], twin["metrics"][rounds])
    _assert_bitwise(run["rng"], twin["rng"])


@functools.lru_cache(maxsize=None)
def _whole(source, dispatch, algorithm="fedavg", fault=None, rounds=2,
           seed=3, local_step=2):
    """The cell at S=1 in this one process: the whole [C] client state."""
    from torch_dist import _numpy, pod_run
    return _numpy(pod_run(pod_trainer(pod_cfg(
        source, dispatch, 1, algorithm=algorithm,
        fault_kw=FAULT_SETS[fault] if fault else None,
        local_step=local_step)), dispatch, rounds=rounds, seed=seed))


def _assert_cover(runs, whole, rounds=slice(None)):
    """The client trees sharded as the JAX package places them: rank r
    holds rows [r*C_pad/W, (r+1)*C_pad/W) of each, and the ranks' rows
    together are bitwise the one-process run's [C]; the rest (server,
    the replicated epoch and local index, metrics, generator) bitwise on
    every rank."""
    C = whole["clients"][3].shape[0]
    per = -(-C // len(runs))
    owned = []
    for rank, got in enumerate(runs):
        assert got["rows"] == [rank * per, (rank + 1) * per]
        mine = _leaves(got["clients"][:3])
        assert mine and all(x.shape[0] == per for x in mine)
        owned.append(mine)
        _assert_bitwise(got["clients"][3:], whole["clients"][3:])
        _assert_bitwise([got["params"], got["aux"]],
                        [whole["params"], whole["aux"]])
        _assert_bitwise(got["metrics"], whole["metrics"][rounds])
        _assert_bitwise(got["rng"], whole["rng"])
    _assert_bitwise([np.concatenate(xs)[:C] for xs in zip(*owned)],
                    _leaves(whole["clients"][:3]))


@pytest.mark.parametrize("world", [2, 4])
def test_the_sum_is_bitwise_its_one_shard_twin(world, groups):
    for rank, r in enumerate(groups[world].result("sum")):
        assert r["rows"] == [rank * 8 // world, (rank + 1) * 8 // world]
        _assert_bitwise(r["got"], r["twin"])
        # the riders come back whole, in cohort order, dtypes kept
        _assert_bitwise(r["ride"], r["riders"])
        # the gather brought the whole buffer: G = 8 partials of 15
        # floats, then 8 rows of the int32 leaf and of the float32 and
        # int64 riders, whatever the shard count
        assert r["gathered"] == 8 * 15 * 4 + 8 * (4 + 4 + 8)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("source, dispatch", CELLS)
def test_sharded_cell_is_bitwise_its_one_shard_twin(source, dispatch, world,
                                                    groups):
    runs = groups[world].result(f"{source}-{dispatch}")
    _assert_cover([r["got"] for r in runs], _whole(source, dispatch))
    for r in runs:
        _assert_twin(r["got"], r["twin"])
        n = len(r["got"]["metrics"])
        assert r["got"]["collectives"] == [1.0] * n
        assert r["twin"]["collectives"] == [0.0] * n
        # one exchange a round (the twin too: its state is sharded over
        # the same ranks), no norm gather with the guards off
        assert r["got"]["exchanges"] == r["twin"]["exchanges"] == [1.0] * n
        assert r["got"]["norm_gathers"] == [0.0] * n
        g = r["got"]["gauges"]
        assert g["client_shards"] == world
        assert g["cohort_allreduce_bytes"] == r["twin"]["gauges"][
            "cohort_allreduce_bytes"] > 0
        # the whole gather: the partials and the riders; none at S=1
        assert g["cohort_gather_bytes"] > g["cohort_allreduce_bytes"]
        assert r["twin"]["gauges"]["cohort_gather_bytes"] == 0.0
        if source == "feed":
            # each rank packs its own k/S rows of the cohort
            assert g["stream_shard_rows"] == 4 // world
            assert g["stream_shard_pack_s"] >= 0.0


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("source, dispatch", GUARD_CELLS)
@pytest.mark.parametrize("fault", ["guards_reject", "guards_clip", "gauss"])
def test_guards_and_gauss_shard_bitwise(fault, source, dispatch, world,
                                        groups):
    """The update guards (reject, clip) judging a 'gauss' attack, and
    the attack alone, at S in {2, 4}: bitwise the S=1 twin and the
    one-process run; the guards add one norm gather a round."""
    runs = groups[world].result(f"{fault}-{source}-{dispatch}")
    whole = _whole(source, dispatch, fault=fault)
    _assert_cover([r["got"] for r in runs], whole)
    guards = FAULT_SETS[fault]["guard_updates"]
    for r in runs:
        _assert_twin(r["got"], r["twin"])
        got = r["got"]
        assert got["collectives"] == got["exchanges"] == [1.0, 1.0]
        assert got["norm_gathers"] == [float(guards)] * 2
        assert ("guard_norm_gather_bytes" in got["gauges"]) == guards
    # the attack reached the cohort; the round cell's first cohort of 4
    # holds one attacker, whom the guards catch, while the commit's
    # second buffer holds two, whose norms raise the median past them
    byz, rejected, clipped = (sum(float(m[f]) for m in whole["metrics"])
                              for f in (9, 6, 7))
    assert byz > 0
    if dispatch == "round":
        assert rejected > 0 if fault == "guards_reject" else rejected == 0
        assert clipped > 0 if fault == "guards_clip" else clipped == 0


@pytest.mark.parametrize("name", ["faults", "scaffold"])
def test_faults_dp_and_scaffold_shard_bitwise(name, groups):
    """Crashes, nan poison, sign-flip byzantines and the DP clip and
    noise (their per-client flags ride the one gather), and SCAFFOLD's
    per-client control variates (client aux riding it, sharded with the
    rest of the client trees), at S=2."""
    runs = groups[2].result(name)
    whole = _whole("resident" if name == "faults" else "feed", "round",
                   algorithm="scaffold" if name == "scaffold" else "fedavg",
                   fault="faults" if name == "faults" else None)
    _assert_cover([r["got"] for r in runs], whole)
    for r in runs:
        _assert_twin(r["got"], r["twin"])
        assert r["got"]["collectives"] == [1.0, 1.0]
        if name == "scaffold":
            # the control variates: 4 of the 8 clients' rows a rank
            assert all(x.shape[0] == 4 for x in _leaves(r["got"]["clients"][2]))


def test_the_exchange_ships_whole_shards_bitwise(groups):
    """A plan of more rows than a client's shard (K*B = 800 = n_max):
    the exchange ships each client's shard, indexed by the plan on
    arrival."""
    runs = groups[2].result("whole_shard")
    _assert_cover([r["got"] for r in runs],
                  _whole("resident", "round", local_step=100))
    for r in runs:
        _assert_twin(r["got"], r["twin"])
        assert r["got"]["exchanges"] == [1.0, 1.0]


def test_replicas_of_a_shard_agree(groups):
    """World 4 at S=2: ranks (0, 1) run shard 0's rows, (2, 3) shard 1's;
    every rank ends with the twin's state."""
    runs = groups[4].result("replicas")
    _assert_cover([r["got"] for r in runs], _whole("resident", "round"))
    for r in runs:
        _assert_twin(r["got"], r["twin"])
        assert r["got"]["gauges"]["client_shards"] == 2


def test_degraded_resume_from_four_shards_to_two_is_bitwise(groups):
    runs = groups[4].result("resume")
    _assert_cover([r["got"] for r in runs],
                  _whole("resident", "round", rounds=4, seed=7),
                  rounds=slice(2, None))
    for rank, r in enumerate(runs):
        assert r["resumed"] and r["best"] == 0.25 and r["shards"] == 2
        _assert_twin(r["got"], r["ref"], rounds=slice(2, None))
        # only rank 0's checkpoint call wrote a file
        assert r["wrote"] == (rank == 0)


def test_torn_shard_names_its_owner_and_recovers_bitwise(groups):
    for rank, r in enumerate(groups[2].result("torn")):
        assert r["seam"] == "stream.producer"
        assert r["rows"] == [2 * rank, 2 * rank + 2]
        assert "client-store shard" in r["chain"]
        assert f"owning host: process {rank}" in r["chain"]
        assert "torn or truncated" in r["chain"]
        _assert_twin(r["got"], r["ref"])


def test_a_checkpoint_written_at_two_shards_loads_in_one_process(
        groups, tmp_path_factory):
    """Rank 0 wrote the whole [C] state the two ranks' gather brought it;
    one process resumes it bitwise the one-process run's state."""
    from fedtorch_tpu_torch.utils.checkpoint import maybe_resume
    from torch_dist import _numpy
    runs = groups[2].result("save")
    assert [r["rows"] for r in runs] == [[0, 4], [4, 8]]
    want = _whole("resident", "round", seed=7)
    keys = ("params", "aux", "clients", "rng")
    for name in ("ckpt_s2", "ckpt_s2_async"):
        t = pod_trainer(pod_cfg("resident", "round", 1))
        server, clients = t.init_state(0)
        server, clients, best, resumed = maybe_resume(
            str(groups[2].store_dir / name), server, clients, t.cfg)
        assert resumed and best == 0.5 and server.round == 2
        got = _numpy(dict(params=server.params, aux=server.aux,
                          clients=clients, rng=server.rng.get_state()))
        _assert_bitwise([got[k] for k in keys], [want[k] for k in keys])


def test_the_supervisor_rolls_back_a_rank_s_own_rows(groups):
    """At S=2 the supervisor's snapshot holds the rows of the clients
    the round writes that this rank holds (local rows), and its
    rollback puts this rank's state back bitwise."""
    for rank, r in enumerate(groups[2].result("supervisor")):
        assert r["rows"] == [4 * rank, 4 * rank + 4]
        assert all(((i >= 0) & (i < 4)).all() for i in r["saved"])
        _assert_bitwise(r["after"], r["before"])
        # the round wrote this rank's rows (the cohort's owned ones)
        if any(i.size for i in r["saved"]):
            assert any(not np.array_equal(a, b) for a, b in zip(
                _leaves(r["changed"][:3]), _leaves(r["before"][:3])))
