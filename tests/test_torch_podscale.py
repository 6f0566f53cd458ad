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
  rtol 1e-4 / atol 1e-6), and every client-shard refusal in the JAX
  text.
* **S-invariance**, the JAX package's own bars (its S > 1 tests fail
  under the installed JAX, its S=1 twin runs): two spawned gloo groups,
  world 2 and world 4 (``tests/torch_dist.py``: a ``FileStore`` under
  the test's temporary directory, ranks at one thread, a 60 s collective
  timeout). Each rank builds the trainer at S and at S=1 and runs both;
  the six cells {resident, feed} x {round, scan, commit} at S in {2, 4},
  a fault-and-DP cell and SCAFFOLD at S=2, replicas at world 4 and S=2,
  and a checkpoint taken at S=4 resumed at S=2 must come out bitwise
  their S=1 twin: server params and aux, client state, metrics and the
  generator. Each sharded round issues exactly ``collective_budget``
  collectives: one ``all_gather``.
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
from test_torch_zoo import REL, _flat, _plans

KS = (2, 4, 8, 10, 12, 128)
CELLS = [(s, d) for s in ("resident", "feed")
         for d in ("round", "scan", "commit")]
FAULTS = dict(client_drop_rate=0.3, nan_inject_rate=0.2, byzantine_rate=0.3,
              byzantine_mode="sign_flip", dp_noise_multiplier=0.5,
              dp_clip_norm=0.05)
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


@functools.lru_cache(maxsize=None)
def _jax_twin():
    """The JAX package's armed S=1 twin: its weights, the plans replayed
    from its key chain, and two rounds' server params and metrics."""
    jc = pod_cfg("resident", "round", 1, mod=jcfg)
    jtr = JTrainer(jc, jdefine(jc, batch_size=8), jmake(jc), jbuild(jc).train)
    assert jtr.podscale_armed and jtr.client_shards == 1
    js, jcl = jtr.init_state(jax.random.key(3))
    weights = _flat(js.params)
    plans = _plans(jtr, js, 2)
    rounds = []
    for _ in range(2):
        js, jcl, jm = jtr.run_round(js, jcl)
        rounds.append((_flat(js.params), jax.tree.map(np.asarray, jm)))
    return weights, plans, rounds


def test_armed_one_shard_round_matches_the_jax_armed_twin():
    weights, plans, rounds = _jax_twin()
    ttr = pod_trainer(pod_cfg("resident", "round", 1))
    assert ttr.podscale_armed and ttr.client_shards == 1
    ts, tcl = ttr.init_state(3)
    ts = ts._replace(params=params_from_jax(weights, expect=ts.params,
                                            module=ttr.model.module))
    for n, p in tcl.params.items():
        p[:] = ts.params[n]
    for plan, (jparams, jm) in zip(plans, rounds):
        ts, tcl, tm = ttr.round_fn(ts, tcl, plan)
        np.testing.assert_array_equal(tm.online_mask.numpy(),
                                      jm.online_mask)
        np.testing.assert_allclose(tm.train_loss.numpy(), jm.train_loss,
                                   rtol=1e-4, atol=1e-6)
        got = params_from_jax(jparams, expect=ts.params,
                              module=ttr.model.module)
        scale = max(float(v.abs().max()) for v in got.values())
        for n, v in ts.params.items():
            assert float((v - got[n]).abs().max()) <= REL * scale, n
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


@pytest.mark.parametrize("facts, words", [
    (dict(fault_kw=dict(guard_updates=True)), "fault.guard_updates"),
    (dict(fault_kw=dict(byzantine_rate=0.5, byzantine_mode="gauss")),
     "byzantine_mode='gauss'"),
], ids=["guards", "gauss"])
def test_the_port_s_own_client_shard_refusals_name_the_knob(facts, words):
    cfg = pod_cfg("resident", "round", 2, **facts)
    reason = trp.illegal_reason(
        "resident", "round", "vmap", cfg=cfg, algorithm=tmake(cfg),
        model=tdefine(cfg, batch_size=8, device="cpu"), mesh_devices=2,
        k_online=4)
    assert words in reason and "ROADMAP A10" in reason
    assert trp.illegal_reason(
        "resident", "round", "vmap", cfg=pod_cfg("resident", "round", 1,
                                                 **facts),
        algorithm=tmake(cfg), model=tdefine(cfg, batch_size=8,
                                            device="cpu"),
        mesh_devices=1, k_online=4) is None


def test_several_ranks_without_client_shards_are_refused():
    cfg = pod_cfg("resident", "round", 0)
    reason = trp.illegal_reason(
        "resident", "round", "vmap", cfg=cfg, algorithm=tmake(cfg),
        model=tdefine(cfg, batch_size=8, device="cpu"), mesh_devices=2,
        k_online=4)
    assert reason.startswith("mesh.client_shards=0 on 2 ranks")


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
    if world == 2:
        table["faults"] = ("podscale_cell", dict(
            source="resident", dispatch="round", shards=2,
            fault_kw=FAULTS))
        table["scaffold"] = ("podscale_cell", dict(
            source="feed", dispatch="round", shards=2,
            algorithm="scaffold"))
        table["torn"] = ("podscale_torn", {})
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
            if fn in ("podscale_torn", "podscale_resume"):
                kw = dict(kw, store_dir=str(d))
            cases.append((name, fn, kw))
        started[world] = Group(world, cases, d)
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
    for r in runs:
        _assert_twin(r["got"], r["twin"])
        assert r["got"]["collectives"] == [1.0] * len(r["got"]["metrics"])
        assert r["twin"]["collectives"] == [0.0] * len(r["twin"]["metrics"])
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


@pytest.mark.parametrize("name", ["faults", "scaffold"])
def test_faults_dp_and_scaffold_shard_bitwise(name, groups):
    """Crashes, nan poison, sign-flip byzantines and the DP clip and
    noise (their per-client flags ride the one gather), and SCAFFOLD's
    per-client control variates (client aux riding it), at S=2."""
    for r in groups[2].result(name):
        _assert_twin(r["got"], r["twin"])
        assert r["got"]["collectives"] == [1.0, 1.0]


def test_replicas_of_a_shard_agree(groups):
    """World 4 at S=2: ranks (0, 1) run shard 0's rows, (2, 3) shard 1's;
    every rank ends with the twin's state."""
    runs = groups[4].result("replicas")
    for r in runs:
        _assert_twin(r["got"], r["twin"])
        assert r["got"]["gauges"]["client_shards"] == 2


def test_degraded_resume_from_four_shards_to_two_is_bitwise(groups):
    for rank, r in enumerate(groups[4].result("resume")):
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
