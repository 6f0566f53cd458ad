"""The stream data plane of the port (``native/host_pipeline.py``,
``data/streaming.py``, the trainer's stream plumbing), on the CPU.

* The host pipeline: the gather bitwise to numpy indexing (from RAM and
  from a read-only-safe memory map), the cyclic padding to the JAX
  package's, the prefetcher's overlap, errors, timeout and close.
* The stores against the JAX package's: ``pack``, ``pack_shards``,
  ``pack_probe`` and ``pack_window`` bitwise for the same numpy ids and
  rows (the ``pre_round`` clamp included), store directories byte for
  byte from the two writers, each package reading the other's store,
  and the manifest refusals.
* The stream plane against the port's own resident plane from one seed:
  3 rounds of FedAvg, quantized FedAvg (the plain quantizer twin),
  SCAFFOLD, qFFL (the shard layout), AFL and DRFA (the probe in the
  feed), through ``run_round`` and ``run_rounds`` with windows of 1 and
  2, bitwise: server, clients, metrics and the generator's state; and
  switching between them mid-run.
* The stream plane against the JAX package's ``round_stream_fn`` on the
  JAX ``RoundSchedule``'s own cohorts and rows (perm and sparse), fed
  through ``plan_fn``: an MLP within 1e-5 of each tree's largest value
  (``test_torch_zoo.py``'s bar), and one ResNet-8 (batch-statistics
  norm) case at the same bar.
* The producer's lifetime, residency, and the sparse draw's law.

Every producer is closed (the ``closing`` fixture), and each wait for a
feed is bounded by seconds.
"""
import gc
import json
import os
import threading
import time

import jax
import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401 (two torch threads a worker)
from fedtorch_tpu import config as jcfg
from fedtorch_tpu.algorithms import make_algorithm as jmake
from fedtorch_tpu.data import streaming as jst
from fedtorch_tpu.data.batching import (
    ClientData as JClientData, stack_partitions as jstack,
)
from fedtorch_tpu.models import define_model as jdefine
from fedtorch_tpu.native.host_pipeline import (
    cyclic_pad_indices as j_cyclic_pad,
)
from fedtorch_tpu.parallel import FederatedTrainer as JTrainer
from fedtorch_tpu_torch import config as tcfg
from fedtorch_tpu_torch.algorithms import make_algorithm as tmake
from fedtorch_tpu_torch.bridge import params_from_jax
from fedtorch_tpu_torch.data import streaming as tst
from fedtorch_tpu_torch.data.batching import (
    ClientData, stack_partitions as tstack,
)
from fedtorch_tpu_torch.models import define_model as tdefine
from fedtorch_tpu_torch.native import (
    HostPrefetcher, cyclic_pad_indices, gather_rows,
)
from fedtorch_tpu_torch.parallel import FederatedTrainer, RoundPlan
from fedtorch_tpu_torch.parallel.federated import participation_indices
from test_torch_zoo import _assert_state_close, _flat

PRODUCER = "stream-feed-producer"
TIMEOUT_S = 20.0


@pytest.fixture
def closing():
    """Closes every trainer or producer a test registers."""
    owned = []
    yield owned.append
    for thing in owned:
        thing.close()


def _live_producers():
    return [t for t in threading.enumerate()
            if t.name == PRODUCER and t.is_alive()]


# -- the host pipeline --------------------------------------------------------
@pytest.mark.parametrize("dtype", [np.float32, np.int64, np.uint8])
def test_gather_rows_matches_numpy(dtype):
    rng = np.random.RandomState(0)
    src = rng.randint(0, 100, (500, 7, 3)).astype(dtype)
    idx = rng.randint(0, 500, 1234)
    np.testing.assert_array_equal(
        gather_rows(torch.from_numpy(src), idx).numpy(), src[idx])
    out = torch.empty((1234, 7, 3), dtype=torch.from_numpy(src).dtype)
    assert gather_rows(torch.from_numpy(src), idx.astype(np.int32),
                       out=out) is out
    np.testing.assert_array_equal(out.numpy(), src[idx])


def test_gather_rows_from_a_memory_map_leaves_the_file(tmp_path):
    rng = np.random.RandomState(1)
    src = rng.randn(300, 5).astype(np.float32)
    path = tmp_path / "rows.bin"
    src.tofile(path)
    mm = np.memmap(path, dtype=np.float32, mode="c", shape=src.shape)
    idx = rng.randint(0, 300, 777)
    np.testing.assert_array_equal(gather_rows(torch.from_numpy(mm),
                                              idx).numpy(), src[idx])
    assert path.read_bytes() == src.tobytes()


def test_cyclic_pad_is_the_jax_package_s():
    for idx, n in (([3, 1, 4], 8), ([7], 5), ([2, 9, 0, 4], 4)):
        idx = np.asarray(idx, np.int32)
        np.testing.assert_array_equal(cyclic_pad_indices(idx, n),
                                      j_cyclic_pad(idx, n))


def test_prefetcher_overlaps():
    def produce(step):
        if step >= 5:
            raise StopIteration
        time.sleep(0.01)
        return step * 2

    pf = HostPrefetcher(produce, depth=2)
    got = []
    while True:
        item = pf.next(timeout=5.0)
        if item is None:
            break
        got.append(item)
    assert got == [0, 2, 4, 6, 8]
    assert pf.close() and not pf.alive()


class GatherBroke(RuntimeError):
    pass


def test_prefetcher_raises_the_producer_s_own_error_every_time():
    def produce(step):
        if step == 1:
            raise GatherBroke("disk gone")
        return step

    pf = HostPrefetcher(produce, depth=2)
    assert pf.next(timeout=5.0) == 0
    for _ in range(2):
        with pytest.raises(GatherBroke, match="disk gone"):
            pf.next(timeout=5.0)
    assert pf.close()


def test_prefetcher_times_out_on_a_wedged_producer_and_closes():
    release = threading.Event()

    def produce(step):
        release.wait(10.0)
        return step

    pf = HostPrefetcher(produce, depth=1, name="wedged")
    with pytest.raises(TimeoutError, match="wedged"):
        pf.next(timeout=0.3)
    release.set()
    assert pf.close(join_timeout=5.0) and not pf.alive()


def test_close_ends_a_worker_parked_on_a_full_queue():
    pf = HostPrefetcher(lambda step: step, depth=1)
    deadline = time.monotonic() + 5.0
    while pf.depth() < 1 and time.monotonic() < deadline:
        time.sleep(0.01)
    assert pf.depth() == 1 and pf.alive()
    assert pf.close(join_timeout=5.0) and not pf.alive()


# -- the stores against the JAX package's -------------------------------------
def _toy_arrays():
    rng = np.random.RandomState(0)
    C, n_max, F = 5, 12, 3
    x = rng.randn(C, n_max, F).astype(np.float32)
    y = rng.randint(0, 10, (C, n_max)).astype(np.int32)
    # a short (wrapping) client and an empty one
    sizes = np.asarray([12, 5, 1, 0, 7], np.int32)
    return x, y, sizes


def _stores():
    x, y, sizes = _toy_arrays()
    return (tst.HostClientStore(ClientData(*(torch.from_numpy(a)
                                             for a in (x, y, sizes)))),
            jst.HostClientStore(JClientData(x=x, y=y, sizes=sizes)))


def _assert_feed_is_jax(got, want):
    for name, w in zip(want._fields, want):
        g = getattr(got, name)
        if w is None:
            assert g is None, name
        else:
            assert g.numpy().dtype == np.asarray(w).dtype, name
            np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                          err_msg=name)


@pytest.mark.parametrize("order", ["fwd", "rev"])
def test_pack_is_bitwise_the_jax_package_s(order):
    tstore, jstore = _stores()
    idx = np.asarray([3, 1, 0, 2], np.int64)
    if order == "rev":
        idx = idx[::-1].copy()
    rows = np.random.RandomState(1).randint(0, 12, (4, 7)).astype(np.int64)
    rows[np.where(idx == 3)[0][0]] = 0  # the empty client's plan: row 0
    _assert_feed_is_jax(tstore.pack(idx, rows, 2),
                        jstore.pack(idx, rows, 2))


def test_pre_rows_clamp_when_batch_exceeds_shard():
    tstore, jstore = _stores()  # n_max = 12
    idx, rows = np.asarray([1, 4]), np.zeros((2, 3), np.int64)
    _assert_feed_is_jax(tstore.pack(idx, rows, 15),
                        jstore.pack(idx, rows, 15))


def test_pack_shards_probe_and_window_are_bitwise_the_jax_package_s():
    tstore, jstore = _stores()
    rng = np.random.RandomState(2)
    idx = np.asarray([4, 0, 2])
    _assert_feed_is_jax(tstore.pack_shards(idx, 3),
                        jstore.pack_shards(idx, 3))
    rows2 = rng.randint(0, 12, (3, 4))
    for g, w in zip(tstore.pack_probe(idx, rows2),
                    jstore.pack_probe(idx, rows2)):
        np.testing.assert_array_equal(g.numpy(), w)
    idxs = np.asarray([[0, 1], [4, 2], [3, 1]])
    rowss = rng.randint(0, 12, (3, 2, 5))
    _assert_feed_is_jax(tstore.pack_window(idxs, rowss, 2),
                        jstore.pack_window(idxs, rowss, 2))


def test_feed_nbytes_counts_every_tensor():
    tstore, _ = _stores()
    feed = tstore.pack(np.asarray([0, 1]), np.zeros((2, 4), np.int64), 2)
    assert tst.feed_nbytes(feed) == sum(
        t.numel() * t.element_size() for t in feed if t is not None)
    assert tst.feed_nbytes(feed._replace(rows=torch.zeros(2, 4).long())) \
        == tst.feed_nbytes(feed) + 64


def test_host_store_uses_the_population_in_place():
    x, y, sizes = _toy_arrays()
    data = ClientData(*(torch.from_numpy(a) for a in (x, y, sizes)))
    store = tst.HostClientStore(data)
    assert store.x.data_ptr() == data.x.data_ptr()
    assert store.resident_nbytes == x.nbytes + y.nbytes
    assert store.mapped_nbytes == 0


def _write_both(tmp_path, cps=2):
    x, y, sizes = _toy_arrays()
    jst.save_client_store(str(tmp_path / "jax"), JClientData(
        x=x, y=y, sizes=sizes), clients_per_shard=cps)
    tst.save_client_store(str(tmp_path / "port"), ClientData(
        *(torch.from_numpy(a) for a in (x, y, sizes))), clients_per_shard=cps)
    return tmp_path / "jax", tmp_path / "port"


def test_store_directories_are_byte_identical_across_the_writers(tmp_path):
    jdir, tdir = _write_both(tmp_path)
    names = sorted(os.listdir(jdir))
    assert names == sorted(os.listdir(tdir))
    assert "manifest.json" in names and "x.00002.bin" in names
    for name in names:
        assert (jdir / name).read_bytes() == (tdir / name).read_bytes(), name


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_each_package_reads_the_other_s_store(writer, tmp_path):
    dirs = dict(zip(("jax", "port"), _write_both(tmp_path, cps=2)))
    tstore, jstore = _stores()
    idx = np.asarray([4, 1, 3, 0])
    rows = np.random.RandomState(3).randint(0, 12, (4, 6))
    want = jstore.pack(idx, rows, 4)
    tmm = tst.MmapClientStore(str(dirs[writer]))
    jmm = jst.MmapClientStore(str(dirs[writer]))
    _assert_feed_is_jax(tmm.pack(idx, rows, 4), want)
    _assert_feed_is_jax(tstore.pack(idx, rows, 4), jmm.pack(idx, rows, 4))
    assert tmm.resident_nbytes == 4 * 5
    assert tmm.mapped_nbytes == jmm.mapped_nbytes
    view = tmm.as_client_data()
    assert view.x.shape == (5, 12, 3) and view.x.stride()[0] == 0


def _damage(case, store_dir):
    mpath = store_dir / "manifest.json"
    man = json.loads(mpath.read_text())
    if case == "missing":
        mpath.unlink()
        return
    if case == "torn":
        shard = store_dir / man["tensors"]["x"]["shards"][1]
        shard.write_bytes(shard.read_bytes()[:-8])
        return
    if case == "format":
        man["format"] = "other"
    elif case == "version":
        man["version"] = 2
    elif case == "overflow":
        man["clients_per_shard"] = 2 ** 30
    elif case == "sizes":
        man["num_clients"] = 4
    elif case == "shards":
        man["tensors"]["y"]["shards"] = man["tensors"]["y"]["shards"][:1]
    mpath.write_text(json.dumps(man))


@pytest.mark.parametrize("case", ["missing", "format", "version",
                                  "overflow", "sizes", "shards", "torn"])
def test_manifest_refusals_are_the_jax_package_s(case, tmp_path):
    _, tdir = _write_both(tmp_path)
    _damage(case, tdir)

    def refusal(mod):
        with pytest.raises(ValueError) as err:
            store = mod.MmapClientStore(str(tdir))
            store.pack(np.asarray([2, 3]), np.zeros((2, 2), np.int64), 2)
        return str(err.value)

    got, want = refusal(tst), refusal(jst)
    if case == "missing":
        assert got.split(" — ")[0] == want.split(" — ")[0]
    elif case == "torn":
        assert "shard 1 of tensor 'x'" in got and "torn or truncated" in got
    else:
        assert got == want


# -- the stream plane against the resident plane ------------------------------
C, B, K = 8, 4, 2
SIZES = [6, 8, 5, 8, 7, 8, 3, 8]


def _data():
    rng = np.random.RandomState(0)
    ends = np.cumsum(SIZES)
    return tstack(rng.randn(sum(SIZES), 32, 32, 3).astype(np.float32),
                  rng.randint(0, 10, sum(SIZES)),
                  [np.arange(e - s, e) for s, e in zip(SIZES, ends)])


def _trainer(plane="device", store="ram", store_dir="", **fed):
    cfg = tcfg.ExperimentConfig(
        data=tcfg.DataConfig(dataset="cifar10", batch_size=B, augment=True,
                             data_plane=plane, store=store,
                             store_dir=str(store_dir)),
        federated=tcfg.FederatedConfig(
            federated=True, num_clients=C, online_client_rate=0.25,
            sync_type="local_step", **fed),
        model=tcfg.ModelConfig(arch="mlp", mlp_hidden_size=16),
        optim=tcfg.OptimConfig(lr=0.1),
        train=tcfg.TrainConfig(local_step=K)).finalize()
    t = FederatedTrainer(cfg, tdefine(cfg, device="cpu"), tmake(cfg),
                         _data(), device="cpu")
    t.stream_timeout_s = TIMEOUT_S
    return t


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [v for k in sorted(tree) for v in _leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [v for t in tree for v in _leaves(t)]
    return []


def _assert_same(a, b):
    (sa, ca, ma), (sb, cb, mb) = a, b
    assert sa.round == sb.round
    assert torch.equal(sa.rng.get_state(), sb.rng.get_state())
    for x, y in zip(*(_leaves((s.params, s.opt, s.aux, c, m))
                      for s, c, m in (a, b))):
        assert torch.equal(x, y)
    assert len(_leaves((sa.params, sa.opt, sa.aux, ca, ma))) > 10


ALGORITHMS = {
    "fedavg": dict(algorithm="fedavg"),
    "fedavg_q": dict(algorithm="fedavg", quantized=True),
    "scaffold": dict(algorithm="scaffold"),
    "qffl": dict(algorithm="qffl", qffl_q=1.0),
    "afl": dict(algorithm="afl"),
    "drfa": dict(algorithm="fedavg", drfa=True),
}
DISPATCH = {"round": [1, 1, 1], "window1": [1, 1, 1], "window2": [1, 2]}


def _run(t, dispatch, rounds):
    server, clients = t.init_state(5)
    metrics = None
    for n in rounds:
        if dispatch == "round":
            server, clients, metrics = t.run_round(server, clients)
        else:
            server, clients, ms = t.run_rounds(server, clients, n)
            metrics = type(ms)(*(None if f is None else f[-1] for f in ms))
    return server, clients, metrics


@pytest.mark.parametrize("dispatch", sorted(DISPATCH))
@pytest.mark.parametrize("name", sorted(ALGORITHMS))
def test_stream_plane_is_bitwise_the_resident_plane(name, dispatch,
                                                    tmp_path, closing):
    """Three rounds from one seed: the same plans (the stream producer
    draws them ahead on a clone of the server's generator), so the same
    server, clients, last metrics and generator state, bit for bit. The
    round dispatch reads the RAM store, the windows the on-disk one."""
    fed = ALGORITHMS[name]
    want = _run(_trainer(**fed), "round", [1, 1, 1])
    store = "ram"
    if dispatch != "round":
        tst.save_client_store(str(tmp_path), _data(), clients_per_shard=3)
        store = "mmap"
    t = _trainer("stream", store, tmp_path, **fed)
    closing(t)
    got = _run(t, dispatch, DISPATCH[dispatch])
    assert t.stream_stats()["rounds_produced"] >= 2
    _assert_same(got, want)


def test_switching_dispatch_mid_run_keeps_the_trajectory(closing):
    """run_round, then windows of 2 and 1, an invalidate, run_round: each
    switch restarts the producer from the live state."""
    ref = _trainer()
    t = _trainer("stream")
    closing(t)
    rs, rc = ref.init_state(9)
    s, c = t.init_state(9)
    for step in ("round", 2, "invalidate", 1, "round"):
        if step == "invalidate":
            t.invalidate_stream()
            continue
        n = 1 if step == "round" else step
        for _ in range(n):
            rs, rc, rm = ref.run_round(rs, rc)
        if step == "round":
            s, c, m = t.run_round(s, c)
        else:
            s, c, ms = t.run_rounds(s, c, step)
            m = type(ms)(*(None if f is None else f[-1] for f in ms))
    _assert_same((s, c, m), (rs, rc, rm))
    assert s.round == 5


def test_replaying_a_round_without_invalidate_is_refused(closing):
    t = _trainer("stream")
    closing(t)
    server, clients = t.init_state(4)
    saved = server.rng.get_state()
    server, clients, _ = t.run_round(server, clients)
    gen = torch.Generator()
    gen.set_state(saved)
    old = server._replace(round=0, rng=gen)
    with pytest.raises(RuntimeError, match="invalidate_stream"):
        t.run_round(old, clients)
    assert t.stream_stats() is None  # the refused producer is gone
    t.run_round(old, clients)  # restarted from the replayed state


# -- the stream plane against the JAX package's -------------------------------
def _jax_pair(arch, mode, n_clients=8, n=16, b=8, k=2):
    sections = dict(
        data=("DataConfig", dict(dataset="cifar10", batch_size=b,
                                 augment=False, data_plane="stream")),
        federated=("FederatedConfig", dict(
            federated=True, num_clients=n_clients, online_client_rate=0.25,
            algorithm="fedavg", sync_type="local_step",
            participation_mode=mode)),
        model=("ModelConfig", dict(arch=arch, mlp_hidden_size=32)),
        optim=("OptimConfig", dict(lr=0.1, in_momentum=arch != "mlp")),
        train=("TrainConfig", dict(local_step=k)))

    def cfg(mod):
        return mod.ExperimentConfig(**{
            name: getattr(mod, cls)(**kw)
            for name, (cls, kw) in sections.items()}).finalize()

    jc, tc = cfg(jcfg), cfg(tcfg)
    rng = np.random.RandomState(0)
    feats = rng.randn(n_clients * n, 32, 32, 3).astype(np.float32)
    labels = rng.randint(0, 10, n_clients * n)
    parts = [np.arange(i * n, (i + 1) * n) for i in range(n_clients)]
    jtr = JTrainer(jc, jdefine(jc, batch_size=b), jmake(jc),
                   jstack(feats, labels, parts))
    js, jcl = jtr.init_state(jax.random.key(0))
    ttr = FederatedTrainer(tc, tdefine(tc, batch_size=b, device="cpu"),
                           tmake(tc), tstack(feats, labels, parts),
                           device="cpu")
    ts, tcl = ttr.init_state(0)
    bridged = params_from_jax(_flat(js.params), expect=ts.params,
                              module=ttr.model.module)
    ts = ts._replace(params=bridged)
    for name, p in tcl.params.items():
        p[:] = bridged[name]
    return jtr, js, jcl, ttr, ts, tcl


@pytest.mark.parametrize("arch, mode", [("mlp", "perm"), ("mlp", "sparse"),
                                        ("resnet8", "perm")])
def test_stream_plane_matches_the_jax_stream_plane(arch, mode, closing):
    """The JAX ``RoundSchedule``'s cohorts and rows, injected into the
    port's producer through ``plan_fn``: three rounds of the port's
    ``round_stream_fn`` against the JAX trainer's streamed rounds."""
    jtr, js, jcl, ttr, ts, tcl = _jax_pair(arch, mode)
    sched = jst.RoundSchedule(
        np.asarray(jax.random.key_data(js.rng)),
        jax.random.key_impl(js.rng), ttr.num_clients, ttr.k_online,
        ttr.local_steps * ttr.batch_size, ttr.host_store.n_max,
        ttr.host_store.sizes, participation_mode=mode)

    cohorts = []

    def plan_fn(step):
        idx, rows = sched(step)
        cohorts.append(sorted(np.asarray(idx).tolist()))
        return step, RoundPlan(torch.from_numpy(np.array(idx)).long(),
                               torch.from_numpy(np.array(rows)).long())

    producer = tst.StreamFeedProducer(ttr.host_store, batch_size=8,
                                      plan_fn=plan_fn, timeout_s=TIMEOUT_S)
    closing(producer)
    try:
        for r in range(3):
            js, jcl, jm = jtr.run_round(js, jcl)
            ts, tcl, tm = ttr.round_stream_fn(ts, tcl,
                                              producer.next_feed().feed)
            # [C] in 'perm' mode, the cohort-aligned [k] in 'sparse'
            np.testing.assert_array_equal(tm.online_mask.numpy(),
                                          np.asarray(jm.online_mask))
            if mode == "perm":
                assert np.flatnonzero(tm.online_mask.numpy()).tolist() \
                    == cohorts[r]
    finally:
        jtr.invalidate_stream()
    assert _assert_state_close(js, jcl, ts, tcl, ttr.model.module) > 0


# -- the producer's lifetime and the plane's residency ------------------------
def test_producer_prefetches_ahead_and_drains():
    t = _trainer("stream")
    server, clients = t.init_state(0)
    server, clients, _ = t.run_round(server, clients)
    deadline = time.monotonic() + TIMEOUT_S
    while t.stream_stats()["rounds_produced"] < 4 \
            and time.monotonic() < deadline:
        time.sleep(0.01)
    # 1 consumed, 2 queued (the depth), 1 waiting for queue space
    assert t.stream_stats()["rounds_produced"] == 4
    assert t.stream_stats()["depth"] == 2 and _live_producers()
    t.invalidate_stream()
    assert not _live_producers() and t.stream_stats() is None


def test_a_dropped_trainer_leaves_no_live_producer():
    t = _trainer("stream")
    server, clients = t.init_state(0)
    t.run_round(server, clients)
    assert _live_producers()
    del t, server, clients
    gc.collect()
    deadline = time.monotonic() + 10.0
    while _live_producers() and time.monotonic() < deadline:
        time.sleep(0.05)
    assert not _live_producers()


def test_a_gather_error_reaches_the_round_as_itself(closing):
    t = _trainer("stream")
    closing(t)

    def broken(tensor, flat_rows, out):
        raise GatherBroke(f"cannot read {tensor}")

    t.host_store._gather_flat = broken
    server, clients = t.init_state(0)
    for _ in range(2):
        with pytest.raises(GatherBroke, match="cannot read x"):
            t.run_round(server, clients)
        t.invalidate_stream()


def test_stats_counters_rise(closing):
    t = _trainer("stream")
    closing(t)
    server, clients = t.init_state(0)
    server, clients, _ = t.run_round(server, clients)
    first = dict(t.stream_stats())
    server, clients, _ = t.run_rounds(server, clients, 2)
    server, clients, _ = t.run_rounds(server, clients, 2)
    stats = t.stream_stats()
    assert stats["rounds_produced"] >= 4 and stats["gather_s"] > 0.0
    assert stats["h2d_s"] >= 0.0 and stats["wait_s"] >= 0.0
    assert first["gather_s"] > 0.0 and first["rounds_produced"] >= 1
    assert stats["store_resident_mb"] == t.host_store.resident_nbytes / 1e6


@pytest.mark.parametrize("store", ["ram", "mmap"])
def test_stream_trainer_holds_no_population_tensor(store, tmp_path, closing):
    resident = _trainer()
    assert tuple(resident.data.x.shape) == (C, 8, 32, 32, 3)
    tst.save_client_store(str(tmp_path), _data(), clients_per_shard=3)
    t = _trainer("stream", store, tmp_path)
    closing(t)
    server, clients = t.init_state(0)
    t.run_round(server, clients)
    assert t.data is None and t.val_data is None
    held = [v for k, v in vars(t).items()
            if k != "host_store" and isinstance(v, torch.Tensor)
            and v.dim() >= 2 and tuple(v.shape[:2]) == (C, 8)]
    assert held == []
    if store == "mmap":
        assert t.host_store.resident_nbytes == 4 * C


def test_mmap_store_of_another_shape_is_refused(tmp_path):
    data = _data()
    tst.save_client_store(str(tmp_path), ClientData(
        data.x[:7], data.y[:7], data.sizes[:7]))
    with pytest.raises(ValueError, match=r"holds \[7, 8\] clients x rows "
                                         r"but the run's data is \[8, 8\]"):
        _trainer("stream", "mmap", tmp_path)


# -- sparse participation -----------------------------------------------------
def test_sparse_participation_draws_uniformly_without_replacement():
    """2,000 draws of 5 of 20 from one seed: distinct ids in range, and
    each id's inclusion count within chi-square's 0.1% tail (19 degrees
    of freedom: 43.82) of the uniform 500."""
    gen = torch.Generator().manual_seed(0)
    counts = np.zeros(20)
    for _ in range(2000):
        idx = participation_indices(gen, 20, 5, 1, mode="sparse").numpy()
        assert len(set(idx.tolist())) == 5
        assert idx.min() >= 0 and idx.max() < 20
        counts[idx] += 1
    chi2 = float(((counts - 500.0) ** 2 / 500.0).sum())
    assert chi2 < 43.82, (chi2, counts)


def test_sparse_participation_puts_client_0_online_in_round_0():
    for seed in range(40):
        gen = torch.Generator().manual_seed(seed)
        idx = participation_indices(gen, 50, 3, 0, mode="sparse")
        assert 0 in idx.tolist() and len(set(idx.tolist())) == 3
