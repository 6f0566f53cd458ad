"""The rank mesh and the run's process group (``parallel/mesh.py``) and
the CLI on several ranks, on the CPU.

``init_multihost`` is held to the JAX package's contract as its own
tests state it (``tests/test_fault_injection.py``
``TestInitMultihostRetry``): a transient connect error retries with
delays 0.25, 0.5; a coordinator that never answers raises a timeout
naming it; a malformed argument and a second initialization fail after
one call; no address is a no-op. ``make_mesh`` refuses a shard count
that does not divide the ranks in the JAX text, and the placement
helpers say which rows a rank holds. The backend is decided per host:
NCCL for two processes on two hosts with one card each, gloo for two
processes on one host's one card. Two CLI processes at
``--client_shards 2`` over gloo (joined through a ``file://`` store in
the test's directory, no TCP port) log the same metric lines as each
other and as one process at ``--client_shards 1``; only rank 0 writes
the checkpoints and the telemetry files, and both ranks resume from
them.
"""
import glob
import os
import re
import subprocess
import sys

import pytest
import torch

import torch_threads  # noqa: F401 (two torch threads a worker)
from fedtorch_tpu import config as jcfg
from fedtorch_tpu.parallel import mesh as jmesh
from fedtorch_tpu_torch import config as tcfg
from fedtorch_tpu_torch.parallel import mesh
from torch_dist import pod_cfg, pod_trainer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cfg(**kw):
    return tcfg.MeshConfig(coordinator_address="10.0.0.1:1234",
                           num_processes=2, process_id=0, **kw)


@pytest.fixture
def fake_init(monkeypatch):
    """``torch.distributed.rendezvous`` and ``init_process_group``
    replaced: the rendezvous calls the function a test sets (where a
    coordinator that is not up fails) and hands back a ``HashStore``;
    both calls are recorded."""
    import torch.distributed as dist
    calls, inits = [], []
    holder = {"fn": lambda: None, "store": dist.HashStore()}

    def rendezvous(url, rank, world_size, timeout):
        calls.append(dict(init_method=url, rank=rank,
                          world_size=world_size))
        holder["fn"]()
        yield holder["store"], rank, world_size

    def init(backend, **kw):
        inits.append((backend, kw))
    monkeypatch.setattr(dist, "rendezvous", rendezvous)
    monkeypatch.setattr(dist, "init_process_group", init)
    monkeypatch.setattr(dist, "get_rank", lambda *a: 0)
    monkeypatch.setattr(dist, "get_world_size", lambda *a: 2)
    holder["inits"] = inits
    return holder, calls


def test_transient_failure_retries_then_succeeds(fake_init):
    holder, calls = fake_init

    def flaky():
        if len(calls) < 3:
            raise ConnectionError("coordinator not up yet")
    holder["fn"] = flaky
    delays = []
    backend = mesh.init_multihost(_cfg(init_backoff_s=0.25, backend="cpu"),
                                  _sleep=delays.append)
    assert len(calls) == 3 and delays == [0.25, 0.5]
    assert backend == "gloo"
    assert calls[0] == dict(init_method="tcp://10.0.0.1:1234", rank=0,
                            world_size=2)
    assert [b for b, _ in holder["inits"]] == ["gloo"]
    kw = holder["inits"][0][1]
    assert (kw["world_size"], kw["rank"]) == (2, 0)


def test_timeout_raises_a_clear_error(fake_init):
    holder, _ = fake_init

    def down():
        raise ConnectionError("nope")
    holder["fn"] = down
    with pytest.raises(RuntimeError, match="10.0.0.1:1234") as ei:
        mesh.init_multihost(_cfg(init_timeout_s=0.5, init_backoff_s=0.3),
                            _sleep=lambda d: None)
    assert "process_id=0, num_processes=2" in str(ei.value)


@pytest.mark.parametrize("error", [
    ValueError("bad coordinator address"),
    RuntimeError("trying to initialize the default process group twice!"),
], ids=["malformed", "twice"])
def test_permanent_errors_fail_after_one_call(fake_init, error):
    holder, calls = fake_init

    def bad():
        raise error
    holder["fn"] = bad
    with pytest.raises(type(error), match=re.escape(str(error)[:12])):
        mesh.init_multihost(_cfg(backend="cpu"), _sleep=lambda d: None)
    assert len(calls) == 1


def test_an_initialized_group_is_not_initialized_again(fake_init,
                                                       monkeypatch):
    import torch.distributed as dist
    holder, calls = fake_init
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    with pytest.raises(RuntimeError, match="already initialized"):
        mesh.init_multihost(_cfg(), _sleep=lambda d: None)
    assert calls == [] and holder["inits"] == []


def test_no_coordinator_is_a_no_op(fake_init):
    holder, calls = fake_init
    assert mesh.init_multihost(tcfg.MeshConfig()) is None
    assert calls == [] and holder["inits"] == []


def test_an_address_with_a_scheme_is_used_as_it_is(fake_init):
    _, calls = fake_init
    cfg = tcfg.MeshConfig(coordinator_address="file:///tmp/store",
                          num_processes=2, process_id=1, backend="cpu")
    mesh.init_multihost(cfg)
    assert calls[0]["init_method"] == "file:///tmp/store"


@pytest.mark.parametrize("device, local, cards, want", [
    ("cpu", 2, 0, "gloo"),
    ("cuda", 2, 1, "gloo"),   # two ranks on one card
    ("cuda", 1, 1, "nccl"),
    ("cuda", 4, 4, "nccl"),
    ("cuda", 2, 4, "nccl"),   # fewer ranks than cards on the host
    ("cuda", 8, 4, "gloo"),
])
def test_the_backend_rule(monkeypatch, device, local, cards, want):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    assert mesh.choose_backend(device, local) == want


@pytest.mark.parametrize("hosts, rank, want", [
    (("a", "b"), 0, 1), (("a", "b"), 1, 1), (("a", "a"), 1, 2),
    (("a", "b", "a", "b"), 2, 2), (("a", "a", "a", "b"), 3, 1),
])
def test_ranks_on_host_counts_this_host_s_ranks(hosts, rank, want):
    import torch.distributed as dist
    store = dist.HashStore()
    for r, h in enumerate(hosts):
        if r != rank:
            store.set(f"init_multihost/host/{r}", h)
    assert mesh.ranks_on_host(store, rank, len(hosts), hosts[rank]) == want


@pytest.mark.parametrize("other_host, local, want", [
    ("host-b", None, "nccl"),  # two hosts, one card and one rank each
    ("host-a", None, "gloo"),  # one host, two ranks on its one card
    ("host-a", "1", "nccl"),   # a launcher's LOCAL_WORLD_SIZE comes first
])
def test_init_multihost_decides_the_backend_per_host(
        fake_init, monkeypatch, other_host, local, want):
    """Two processes, each with one card: NCCL when they run on two
    hosts (the store holds the other rank's host name), gloo when they
    share this host's card."""
    holder, _ = fake_init
    holder["store"].set("init_multihost/host/1", other_host)
    monkeypatch.setattr(mesh.socket, "gethostname", lambda: "host-a")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "set_device", lambda d: None)
    if local is None:
        monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    else:
        monkeypatch.setenv("LOCAL_WORLD_SIZE", local)
    assert mesh.init_multihost(_cfg()) == want
    assert [b for b, _ in holder["inits"]] == [want]


@pytest.mark.parametrize("shards", [0, 1])
def test_one_process_needs_no_group(shards):
    m = mesh.make_mesh(tcfg.MeshConfig(client_shards=shards))
    assert m is None
    assert mesh.mesh_client_shards(m) == 1
    assert mesh.local_cohort_rows(m, 10, shards) == (0, 10)


@pytest.mark.parametrize("shards", [2, 4])
def test_shards_past_the_ranks_are_refused_in_the_jax_text(shards):
    with pytest.raises(ValueError) as want:
        jmesh.make_mesh(jcfg.MeshConfig(client_shards=shards,
                                        num_devices=1))
    with pytest.raises(ValueError) as got:
        mesh.make_mesh(tcfg.MeshConfig(client_shards=shards))
    assert str(got.value) == str(want.value)
    # and a trainer asked for them raises it too
    with pytest.raises(ValueError, match=re.escape(str(want.value))):
        pod_trainer(pod_cfg("resident", "round", shards))


def test_num_devices_must_be_the_rank_count():
    with pytest.raises(ValueError, match="mesh.num_devices=2"):
        mesh.make_mesh(tcfg.MeshConfig(num_devices=2))
    assert mesh.make_mesh(tcfg.MeshConfig(num_devices=1)) is None


class _Mesh:
    """A 2-D mesh's shape and this rank's coordinate on dimension 0."""
    ndim = 2

    def __init__(self, shape, coord):
        self.shape, self._coord = shape, coord

    def get_local_rank(self, dim):
        assert dim == 0
        return self._coord


@pytest.mark.parametrize("shape, coord, k, want", [
    ((2, 1), 0, 10, (0, 5)), ((2, 1), 1, 10, (5, 10)),
    ((4, 1), 3, 8, (6, 8)), ((2, 2), 1, 4, (2, 4)),
    ((1, 4), 0, 10, (0, 10)), ((4, 1), 2, 6, (0, 6)),  # 4 does not divide 6
])
def test_the_rows_a_rank_holds(shape, coord, k, want):
    m = _Mesh(shape, coord)
    S = mesh.mesh_client_shards(m)
    assert S == shape[0]
    assert mesh.local_cohort_rows(m, k, S) == want
    assert mesh.cohort_sharding(m, k) == want


# -- the CLI on two ranks --------------------------------------------------------
_LINE = re.compile(r"Round: (\d+)\. ((?:Epoch|Mode).*?)$", re.M)


def _cli(run_dir, rounds, extra, resume=False):
    argv = [sys.executable, "-m", "fedtorch_tpu_torch.cli", "--backend",
            "cpu", "-f", "true", "-d", "synthetic", "-a",
            "logistic_regression", "--num_workers", "8",
            "--online_client_rate", "0.5", "--local_step", "2", "-b", "8",
            "--eval_freq", "1", "--debug", "false", "--num_comms",
            str(rounds), "--run_dir", str(run_dir)] + list(extra)
    if resume:
        argv += ["--resume", str(run_dir)]
    return argv


def _train_lines(path):
    """Each round's train and test lines without their clock fields."""
    text = open(path).read()
    return [re.sub(r"Load: .*?Global: [\d.]+s \| ", "", m.group(2))
            for m in _LINE.finditer(text)]


def _two_ranks(tmp_path, run_dir, rounds, resume=False):
    store = tmp_path / f"store_{rounds}_{int(resume)}"
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        _cli(run_dir, rounds, [
            "--client_shards", "2", "--num_processes", "2",
            "--process_id", str(rank), "--coordinator_address",
            f"file://{store}"], resume),
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for rank in (0, 1)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=240)
            outs.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rc, out, err in outs:
        assert rc == 0, err[-3000:]
    return outs


def test_two_cli_ranks_log_the_same_lines_and_rank_0_writes(tmp_path):
    run = tmp_path / "run"
    outs = _two_ranks(tmp_path, run, 2)
    assert all("init_multihost: backend gloo" in out for _, out, _ in outs)
    lines = [_train_lines(run / f"record{r}") for r in (0, 1)]
    assert len(lines[0]) == 4 and lines[0] == lines[1]
    # rank 0 alone writes the telemetry rows and the checkpoints
    rows = [line for line in open(run / "metrics.jsonl")
            if '"round"' in line]
    assert len(rows) == 2 and '"client_shards": 2.0' in rows[0]
    assert os.path.exists(run / "health.p1.json")
    assert sorted(os.path.basename(p) for p in glob.glob(
        str(run / "*.ckpt"))) == ["checkpoint.ckpt", "checkpoint_r1.ckpt",
                                  "model_best.ckpt"]
    # one process at client_shards 1 logs the same lines
    one = tmp_path / "one"
    subprocess.run(_cli(one, 2, ["--client_shards", "1"]), cwd=REPO,
                   env=dict(os.environ, PYTHONPATH=REPO + os.pathsep
                            + os.environ.get("PYTHONPATH", "")),
                   check=True, capture_output=True, timeout=240)
    assert _train_lines(one / "record0") == lines[0]
    # both ranks resume from rank 0's files and go on in step
    _two_ranks(tmp_path, run, 3, resume=True)
    after = [_train_lines(run / f"record{r}") for r in (0, 1)]
    assert after[0] == after[1] and len(after[0]) == 6
    assert after[0][:4] == lines[0]
    for r in (0, 1):
        assert "resumed from round 2" in open(run / f"record{r}").read()
