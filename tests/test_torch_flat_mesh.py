"""Several ranks at ``client_shards`` 0 (the JAX package's 1-D mesh,
``parallel/mesh.py`` ``cohort_block``, ``parallel/podscale.py``
``gather_cohort``) on the CPU.

Each rank runs its ``ceil(k/W)`` rows of the cohort (k = 6 on 4 ranks:
2, 2, 2 and an empty block); one gather after the local loops brings
every rank every client's rows of what the rest of the round reads, and
every rank runs that rest on the whole cohort. In the port each client's
loop is independent of the others (the draws are in the plan), so the
round on W ranks is held **bitwise** to the port's own one-rank round at
``client_shards`` 0, run in this process: server params and aux, the
generator, the metrics, the replicated epochs and local indices, and the
client trees, which each rank holds as its ``C_pad/W`` rows (the ranks'
rows together are the one-rank run's ``[C]``). Two spawned gloo groups,
world 2 and world 4 (``tests/torch_dist.py``), run

* the six cells {resident, feed} x {round, scan, commit} (W = 4 at 12
  clients, k = 6: uneven blocks and an empty one);
* at W = 2, each robust rule, ``cohort_stats``, the guards judging a
  'gauss' attack, 'collude', crashes, nan poison and DP, and every
  algorithm (the population readers DRFA, qFFL and APFL with adaptive
  alpha also at W = 4), as one parametrised test;
* DRFA, qFFL and APFL at ``client_shards`` 1 on 2 ranks (the exchange
  brings their population rows), bitwise the one-rank round;
* the JAX package's round on a 1-D mesh of W of the conftest's 8 CPU
  devices (``MeshConfig(num_devices=W, client_shards=0)``), its plans
  and weights replayed into the port, for 2 rounds within atol = rtol =
  1e-5, the bar of ``tests/test_sharding.py``;
* a checkpoint written at S = 0 on 2 ranks, loaded in one process and
  resumed at S = 2 on the same ranks.

Every round issues no seam collective, one exchange and one cohort
gather (the JAX package's ``collective_budget`` at S = 0 on several
devices: one a round); a rank with an empty block learns the rows'
layout once, from rank 0. The validator serves every algorithm, rule and
byzantine mode at S = 0 on 2 and 4 ranks and still refuses, by name, the
fused execution on several ranks (the JAX text), 'collude' at S > 1 and
the personal evaluation on several ranks. Two CLI processes at
``--client_shards 0`` log the one-process run's metric lines.
"""
import dataclasses
import functools
import os
import subprocess

import jax
import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401 (two torch threads a worker)
from torch_dist import (
    Group, _numpy, flat_replay, pod_cfg, pod_run, pod_trainer,
)
from fedtorch_tpu import config as jcfg
from fedtorch_tpu.algorithms import make_algorithm as jmake
from fedtorch_tpu.data import build_federated_data as jbuild
from fedtorch_tpu.models import define_model as jdefine
from fedtorch_tpu.parallel import FederatedTrainer as JTrainer
from fedtorch_tpu.parallel import round_program as jrp
from fedtorch_tpu_torch import config as tcfg
from fedtorch_tpu_torch.algorithms import make_algorithm as tmake
from fedtorch_tpu_torch.bridge import params_to_jax
from fedtorch_tpu_torch.cli import refused_flags
from fedtorch_tpu_torch.core.state import RoundMetrics
from fedtorch_tpu_torch.models import define_model as tdefine
from fedtorch_tpu_torch.parallel import mesh as tmesh
from fedtorch_tpu_torch.parallel import round_program as trp
from test_torch_mesh import REPO, _cli, _train_lines
from test_torch_podscale import (
    FAULT_SETS, _assert_bitwise, _leaves, _reason,
)
from test_torch_zoo import _flat, _plans

CELLS = [(s, d) for s in ("resident", "feed")
         for d in ("round", "scan", "commit")]
# k = 6 on 4 ranks: blocks of 2, 2, 2 and 0; the commit's m = 3: 1, 1, 1, 0
WIDE = dict(num_clients=12, buffer_size=3)
# the rules and the algorithms of the round at W = 2, each bitwise the
# one-rank round
CASES = {
    **{rule: dict(fault_kw=dict(robust_agg=rule)) for rule in (
        "median", "trimmed_mean", "krum", "multikrum", "norm_bound")},
    "cohort_stats": dict(telemetry_kw=dict(cohort_stats=True)),
    "guards_gauss": dict(fault_kw=FAULT_SETS["guards_reject"]),
    "collude": dict(fault_kw=dict(byzantine_rate=0.3,
                                  byzantine_mode="collude")),
    "faults_dp": dict(fault_kw=FAULT_SETS["faults"]),
    "fedprox": dict(algorithm="fedprox"),
    "fedadam": dict(algorithm="fedadam"),
    "scaffold": dict(algorithm="scaffold"),
    "fedgate": dict(algorithm="fedgate"),
    "qsparse": dict(algorithm="qsparse",
                    fed_kw=dict(compressed=True, compressed_ratio=0.5)),
    "qffl": dict(algorithm="qffl", fed_kw=dict(qffl_q=1.0)),
    "afl": dict(algorithm="afl"),
    "drfa": dict(fed_kw=dict(drfa=True)),
    "apfl": dict(algorithm="apfl", fed_kw=dict(adaptive_alpha=True)),
    "perfedme": dict(algorithm="perfedme",
                     fed_kw=dict(perfedme_lambda=2.0)),
    "perfedavg": dict(algorithm="perfedavg"),
}
READERS = ("drfa", "qffl", "apfl")
KEYS = ("params", "aux", "metrics", "rng")


def _kw(name):
    """A case's :func:`pod_cfg` keywords, hashable by its name."""
    if name.startswith("cell4-"):
        return dict(WIDE)
    if name.startswith("case4-"):
        return dict(CASES[name[6:]], num_clients=12)
    if name.startswith("case-") or name.startswith("s1-"):
        return dict(CASES[name.split("-", 1)[1]])
    return {}


@functools.lru_cache(maxsize=None)
def _one_rank(name, source, dispatch, shards=0):
    """The case in this one process: the whole [C] client state."""
    return _numpy(pod_run(pod_trainer(pod_cfg(
        source, dispatch, shards, **_kw(name))), dispatch))


@functools.lru_cache(maxsize=None)
def _jax_flat(world, num_clients):
    """The JAX package's round on a 1-D mesh of ``world`` CPU devices
    (``client_shards`` 0): its weights, its 2 rounds' plans replayed
    from its key chain, and each round's server params and train loss."""
    jc = pod_cfg("resident", "round", 0, mod=jcfg, num_clients=num_clients)
    jc = dataclasses.replace(jc, mesh=dataclasses.replace(
        jc.mesh, num_devices=world))
    jtr = JTrainer(jc, jdefine(jc, batch_size=8), jmake(jc), jbuild(jc).train)
    assert jtr.mesh.devices.size == world and not jtr.podscale_armed
    js, jcl = jtr.init_state(jax.random.key(3))
    weights, plans, rounds = _flat(js.params), _plans(jtr, js, 2), []
    for _ in range(2):
        js, jcl, jm = jtr.run_round(js, jcl)
        rounds.append((_flat(js.params), np.asarray(jm.train_loss)))
    return weights, plans, rounds


def _case_table(world):
    table = {}
    if world == 2:
        for source, dispatch in CELLS:
            table[f"cell-{source}-{dispatch}"] = (
                "flat_cell", dict(source=source, dispatch=dispatch))
        for name, kw in CASES.items():
            table[f"case-{name}"] = ("flat_cell", dict(
                source="resident", dispatch="round", **kw))
        for name in READERS:
            table[f"s1-{name}"] = ("flat_cell_s1", dict(
                source="resident", dispatch="round", **CASES[name]))
        table["save"] = ("flat_save", {})
        table["resume"] = ("flat_resume", {})
        table["personal"] = ("flat_refusal", dict(algorithm="apfl"))
        clients = 8
    else:
        for source, dispatch in CELLS:
            table[f"cell4-{source}-{dispatch}"] = (
                "flat_cell", dict(source=source, dispatch=dispatch, **WIDE))
        table["cell-resident-round"] = ("flat_cell", dict(
            source="resident", dispatch="round"))
        for name in READERS:
            table[f"case4-{name}"] = ("flat_cell", dict(
                source="resident", dispatch="round", num_clients=12,
                **CASES[name]))
        clients = 12
    weights, plans, _ = _jax_flat(world, clients)
    table["jax"] = ("flat_replay", dict(weights=weights, plans=plans,
                                        num_clients=clients))
    return table


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    started = {}
    for world in (2, 4):
        d = tmp_path_factory.mktemp(f"flat{world}")
        cases = []
        for name, (fn, kw) in _case_table(world).items():
            if fn in ("flat_save", "flat_resume"):
                kw = dict(kw, store_dir=str(d))
            cases.append((name, fn, kw))
        started[world] = Group(world, cases, d)
        started[world].store_dir = d
    yield started
    for g in started.values():
        if g.results is None:
            g.results = g._collect()


def _blocks(k, world):
    per = -(-k // world)
    return [[min(r * per, k), min((r + 1) * per, k)] for r in range(world)]


def _assert_one_rank(runs, whole):
    """Every rank bitwise the one-rank run; the client trees sharded as
    the JAX package places them, the ranks' rows together its [C]."""
    C = whole["clients"][3].shape[0]
    per = -(-C // len(runs))
    owned = []
    for rank, got in enumerate(runs):
        assert got["rows"] == [rank * per, (rank + 1) * per]
        _assert_bitwise([got[k] for k in KEYS], [whole[k] for k in KEYS])
        _assert_bitwise(got["clients"][3:], whole["clients"][3:])
        owned.append(_leaves(got["clients"][:3]))
    _assert_bitwise([np.concatenate(xs)[:C] for xs in zip(*owned)],
                    _leaves(whole["clients"][:3]))


def _assert_collectives(runs, source, dispatch, k, empty):
    """No seam collective, one exchange and one cohort gather a round
    (over 2 rounds, the JAX ``collective_budget`` at S = 0 on several
    devices); the layout once, where a block is empty; each rank's
    ceil(k/W) block; the gather's gauge."""
    world, scan = len(runs), dispatch == "scan"
    budget = trp.collective_budget(source, dispatch, "vmap",
                                   mesh_devices=world, num_rounds=2,
                                   client_shards=0)
    for rank, got in enumerate(runs):
        n = len(got["metrics"])
        assert n == (1 if scan else 2)
        total = 2 if scan else 1  # rounds a count was taken over
        assert got["collectives"] == [0.0] * n
        assert got["cohort_gathers"] == got["exchanges"] == [1.0] * n
        assert sum(c * total for c in got["cohort_gathers"]) == (
            budget if scan else 2 * budget)
        assert got["norm_gathers"] == [0.0] * n
        assert sum(c * total for c in got["layouts"]) == float(empty)
        assert got["block"] == _blocks(k, world)[rank]
        g = got["gauges"]
        assert "client_shards" not in g and "cohort_gather_bytes" not in g
        assert g["flat_cohort_gather_bytes"] > 0
        assert g["client_exchange_bytes"] >= 0


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("source, dispatch", CELLS)
def test_a_cell_on_ranks_is_bitwise_the_one_rank_round(source, dispatch,
                                                       world, groups):
    name = f"cell-{source}-{dispatch}" if world == 2 \
        else f"cell4-{source}-{dispatch}"
    runs = groups[world].result(name)
    _assert_one_rank(runs, _one_rank(name, source, dispatch))
    # at W = 4 the cohort is k = 6 (the commit's buffer m = 3)
    k = 4 if world == 2 else (3 if dispatch == "commit" else 6)
    _assert_collectives(runs, source, dispatch, k, empty=world == 4)
    if source == "feed":
        # each rank's producer packs its own block's rows
        for rank, r in enumerate(runs):
            lo, hi = _blocks(k, world)[rank]
            assert r["gauges"]["stream_shard_rows"] == hi - lo


def test_even_blocks_on_four_ranks(groups):
    """k = 4 on 4 ranks: a client a rank, no layout broadcast."""
    runs = groups[4].result("cell-resident-round")
    _assert_one_rank(runs, _one_rank("cell-resident-round", "resident",
                                     "round"))
    _assert_collectives(runs, "resident", "round", 4, empty=False)


def _field(metrics, name):
    return sum(float(np.sum(m[RoundMetrics._fields.index(name)]))
               for m in metrics)


@pytest.mark.parametrize("name", sorted(CASES))
def test_every_rule_and_algorithm_is_bitwise_on_two_ranks(name, groups):
    """Each robust rule, the cohort statistics, the guards under a
    'gauss' attack, 'collude' (its honest mean over the whole cohort:
    the gather comes before the byzantine step), crashes, nan poison and
    DP, and every algorithm at W = 2: bitwise the one-rank round."""
    runs = groups[2].result(f"case-{name}")
    whole = _one_rank(f"case-{name}", "resident", "round")
    _assert_one_rank(runs, whole)
    _assert_collectives(runs, "resident", "round", 4, empty=False)
    metrics = whole["metrics"]
    if name in ("guards_gauss", "collude", "faults_dp"):
        assert _field(metrics, "byzantine_clients") > 0
    if name == "guards_gauss":
        assert _field(metrics, "rejected_updates") > 0
    if name == "faults_dp":
        assert _field(metrics, "dropped_clients") > 0
        assert metrics[0][RoundMetrics._fields.index("dp_noise_sigma")] > 0
    if name == "cohort_stats":
        assert metrics[0][RoundMetrics._fields.index("cohort_idx")] \
            is not None


@pytest.mark.parametrize("name", READERS)
def test_population_readers_on_four_ranks(name, groups):
    """DRFA (pre_round, its probe batches), qFFL (whole shards) and APFL
    with adaptive alpha (pre_round on every dispatched client) at k = 6
    on 4 ranks, one of them running no client."""
    runs = groups[4].result(f"case4-{name}")
    _assert_one_rank(runs, _one_rank(f"case4-{name}", "resident", "round"))
    _assert_collectives(runs, "resident", "round", 6, empty=True)


@pytest.mark.parametrize("name", READERS)
def test_population_readers_at_one_shard_on_two_ranks(name, groups):
    """At S = 1 on 2 ranks (every rank runs the whole cohort, the state
    sharded): the exchange brings DRFA's, qFFL's and APFL's population
    rows; bitwise the one-rank round, no collective but the exchange."""
    runs = groups[2].result(f"s1-{name}")
    _assert_one_rank(runs, _one_rank(f"case-{name}", "resident", "round",
                                     1))
    for got in runs:
        assert got["collectives"] == [0.0, 0.0]
        assert got["exchanges"] == [1.0, 1.0]
        assert got["cohort_gathers"] == [0.0, 0.0]
        assert got["block"] == [0, 4]


@pytest.mark.parametrize("world", [2, 4])
def test_the_jax_one_d_mesh_round_on_its_plans(world, groups):
    """The JAX package on W of the 8 CPU devices at ``client_shards`` 0,
    its plans and weights replayed: the port's rounds on W ranks within
    atol = rtol = 1e-5 of it (``tests/test_sharding.py``'s bar) over 2
    rounds, and bitwise the port's one-rank replay."""
    clients = 8 if world == 2 else 12
    weights, plans, rounds = _jax_flat(world, clients)
    one = _numpy(flat_replay(None, weights, plans, num_clients=clients))
    module = pod_trainer(pod_cfg("resident", "round", 0)).model.module
    for got in groups[world].result("jax"):
        _assert_bitwise(got["rounds"], one["rounds"])
        for r, (jparams, jloss) in zip(got["rounds"], rounds):
            flat = params_to_jax({n: torch.from_numpy(v) for n, v in
                                  r["params"].items()}, module)
            for n, v in jparams.items():
                np.testing.assert_allclose(flat[n], v, atol=1e-5, rtol=1e-5,
                                           err_msg=n)
            loss = r["metrics"][RoundMetrics._fields.index("train_loss")]
            np.testing.assert_allclose(loss, jloss[:clients], atol=1e-5,
                                       rtol=1e-5)


def test_a_checkpoint_at_no_shards_loads_in_one_process_and_resumes_at_two(
        groups):
    """Written at S = 0 on 2 ranks (rank 0 writes the whole [C] state
    the gather brought it): one process loads it bitwise the one-rank
    run's state, and the same 2 ranks resume it at S = 2 bitwise the
    one-process S = 1 twin resumed from it."""
    from fedtorch_tpu_torch.utils.checkpoint import maybe_resume
    save = groups[2].result("save")
    assert [r["rows"] for r in save] == [[0, 4], [4, 8]]
    path = str(groups[2].store_dir / "ckpt_s0")
    t = pod_trainer(pod_cfg("resident", "round", 0))
    server, clients = t.init_state(0)
    server, clients, best, resumed = maybe_resume(path, server, clients,
                                                  t.cfg)
    assert resumed and best == 0.5 and server.round == 2
    want = _numpy(pod_run(pod_trainer(pod_cfg("resident", "round", 0)),
                          "round", seed=7))
    got = _numpy(dict(params=server.params, aux=server.aux,
                      clients=clients, rng=server.rng.get_state()))
    keys = ("params", "aux", "clients", "rng")
    _assert_bitwise([got[k] for k in keys], [want[k] for k in keys])
    twin = pod_trainer(pod_cfg("resident", "round", 1))
    s1, c1 = twin.init_state(1)
    s1, c1, _, _ = maybe_resume(path, s1, c1, twin.cfg, None)
    ref = _numpy(pod_run(twin, "round", rounds=2, state=(s1, c1)))
    for rank, r in enumerate(groups[2].result("resume")):
        assert r["resumed"] and r["best"] == 0.5
        got = r["got"]
        assert got["collectives"] == [1.0, 1.0]
        _assert_bitwise([got[k] for k in KEYS], [ref[k] for k in KEYS])
        C, (lo, hi) = 8, got["rows"]
        _assert_bitwise(_leaves(got["clients"][:3]),
                        [x[lo:min(hi, C)] for x in _leaves(
                            ref["clients"][:3])])


# -- the validator ---------------------------------------------------------------
SERVED = [dict(algorithm=a) for a in (
    "fedavg", "fedprox", "fedadam", "scaffold", "fedgate", "qsparse",
    "qffl", "afl", "apfl", "perfedme", "perfedavg")] + [
    dict(fed_kw=dict(drfa=True))] + [
    dict(fault_kw=dict(robust_agg=r)) for r in (
        "median", "trimmed_mean", "krum", "multikrum", "norm_bound")] + [
    dict(telemetry_kw=dict(cohort_stats=True))] + [
    dict(fault_kw=dict(byzantine_rate=0.3, byzantine_mode=m))
    for m in ("sign_flip", "gauss", "collude", "zero")]


@pytest.mark.parametrize("facts", SERVED, ids=lambda f: str(sorted(
    (f.get("fed_kw") or f.get("fault_kw") or f.get("telemetry_kw")
     or f).items())))
def test_every_algorithm_rule_and_attack_is_served_on_ranks(facts):
    """``client_shards`` 0 on 2 and 4 ranks (vmap): every cell the
    one-rank port serves, the JAX validator serves too."""
    for world in (2, 4):
        for source, dispatch in CELLS:
            cfg = pod_cfg(source, dispatch, 0, **facts)
            kw = dict(cfg=cfg, algorithm=tmake(cfg),
                      model=tdefine(cfg, batch_size=8, device="cpu"),
                      k_online=4, has_val=cfg.federated.personal)
            one = trp.illegal_reason(source, dispatch, "vmap",
                                     mesh_devices=1, **kw)
            assert trp.illegal_reason(source, dispatch, "vmap",
                                      mesh_devices=world, **kw) == one
            if dispatch == "round" and source == "resident":
                assert one is None


def test_fused_on_ranks_without_client_shards_is_the_jax_refusal():
    """The fused execution on 2 ranks at S = 0: refused in the JAX
    text."""
    facts = dict(source="resident", dispatch="round", shards=0)
    extra = dict(execution="fused", mesh_devices=2)
    want = _reason(jcfg, jmake, jdefine, facts, extra)
    got = _reason(tcfg, tmake, tdefine, facts, extra)
    assert want is not None and "mesh has 2 devices" in want
    assert got == want


def test_the_personal_evaluation_on_ranks_is_refused_by_name(groups):
    """A personalized algorithm's round runs on several ranks; its
    personal evaluation (every client's models) is refused by name,
    there and by the CLI at construction."""
    for rank, said in enumerate(groups[2].result("personal")):
        assert said.startswith("evaluate_personal on 2 ranks is not yet "
                               "ported") and "ROADMAP A10" in said
    for alg in ("apfl", "perfedme", "perfedavg"):
        cfg = pod_cfg("resident", "round", 0, algorithm=alg)
        assert refused_flags(cfg) == []
        cfg = dataclasses.replace(cfg, mesh=dataclasses.replace(
            cfg.mesh, num_processes=2))
        said = refused_flags(cfg)
        assert len(said) == 1 and "evaluate_personal" in said[0] \
            and "ROADMAP A10" in said[0]
    cfg = pod_cfg("resident", "round", 0)
    assert refused_flags(dataclasses.replace(cfg, mesh=dataclasses.replace(
        cfg.mesh, num_processes=2))) == []


class _Mesh1:
    """A 1-D mesh of ``n`` ranks, this rank at ``coord``."""
    ndim = 1

    def __init__(self, n, coord):
        self.n, self.coord = n, coord

    def size(self):
        return self.n

    def get_local_rank(self, dim):
        assert dim == 0
        return self.coord


@pytest.mark.parametrize("k, world", [(10, 4), (6, 4), (4, 2), (1, 2),
                                      (100, 8), (3, 4)])
def test_the_blocks_of_a_one_d_mesh(k, world):
    """ceil(k/W) rows a rank, the last ones shorter or empty, covering
    the cohort once in rank order (k = 10 on 4 ranks: 3, 3, 3, 1)."""
    got = [list(tmesh.cohort_sharding(_Mesh1(world, r), k))
           for r in range(world)]
    assert got == _blocks(k, world)
    assert got[0][0] == 0 and got[-1][1] == k
    assert all(a[1] == b[0] for a, b in zip(got, got[1:]))
    if (k, world) == (10, 4):
        assert [b - a for a, b in got] == [3, 3, 3, 1]
    for r in range(world):
        assert list(tmesh.cohort_block(k, world, 0, r)) == got[r]


# -- the CLI on two ranks --------------------------------------------------------
def test_two_cli_ranks_without_client_shards_log_the_one_process_lines(
        tmp_path):
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="1")
    run, one = tmp_path / "run", tmp_path / "one"
    procs = [subprocess.Popen(
        _cli(run, 2, ["--client_shards", "0", "--num_processes", "2",
                      "--process_id", str(rank), "--coordinator_address",
                      f"file://{tmp_path / 'store'}"]),
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for rank in (0, 1)]
    single = subprocess.Popen(_cli(one, 2, []), cwd=REPO, env=env,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
    try:
        outs = [(p.communicate(timeout=240), p.returncode)
                for p in procs + [single]]
    finally:
        for p in procs + [single]:
            if p.poll() is None:
                p.kill()
                p.wait()
    for (out, err), rc in outs:
        assert rc == 0, err[-3000:]
    lines = [_train_lines(run / f"record{r}") for r in (0, 1)]
    assert len(lines[0]) == 4 and lines[0] == lines[1]
    assert _train_lines(one / "record0") == lines[0]
    rows = [line for line in open(run / "metrics.jsonl")
            if '"round"' in line]
    assert len(rows) == 2 and '"flat_cohort_gather_bytes"' in rows[0] \
        and '"client_shards"' not in rows[0]
