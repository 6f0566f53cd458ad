"""The round-program builder (``fedtorch_tpu_torch/parallel/round_program.py``)
against the JAX package's, on the CPU.

Over every (source x dispatch x execution) cell and six setups (five
algorithms on an MLP, FedAvg on the ``cnn``, which has a fused module),
the port refuses a cell where the JAX ``illegal_reason`` does, with the
JAX package's words, the fused execution's too. Then the builder as a
trainer uses it: refusals at construction (the base trainer refuses the
async plane, whose commits ``AsyncFederatedTrainer`` serves), the scan
cell at call time, ``run_rounds`` against ``run_round``, and the fused
execution in the four cells it serves (resident/feed x round/scan).
"""
import re

import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401 (two torch threads a worker)
from fedtorch_tpu import config as jcfg
from fedtorch_tpu.algorithms import make_algorithm as jmake
from fedtorch_tpu.models import define_model as jdefine
from fedtorch_tpu.parallel import round_program as jrp
from fedtorch_tpu_torch import config as tcfg
from fedtorch_tpu_torch.algorithms import make_algorithm as tmake
from fedtorch_tpu_torch.data.batching import stack_partitions
from fedtorch_tpu_torch.models import define_model as tdefine
from fedtorch_tpu_torch.parallel import FederatedTrainer
from fedtorch_tpu_torch.parallel import round_program as trp

SETUPS = {
    "fedavg": dict(algorithm="fedavg"),
    "fedavg_cnn": dict(algorithm="fedavg", arch="cnn"),
    "qffl": dict(algorithm="qffl", qffl_q=1.0),
    "drfa": dict(algorithm="fedavg", drfa=True),
    "drfa_lambda": dict(algorithm="fedavg", drfa=True,
                        drfa_lambda_sampling=True),
    "apfl": dict(algorithm="apfl"),
}


def _cfg(mod, *, plane="device", sync_mode="sync", fusion="auto",
         arch="mlp", **fed):
    return mod.ExperimentConfig(
        data=mod.DataConfig(dataset="cifar10", batch_size=4, augment=False,
                            data_plane=plane),
        federated=mod.FederatedConfig(
            federated=True, num_clients=8, online_client_rate=0.25,
            sync_type="local_step", sync_mode=sync_mode, **fed),
        model=mod.ModelConfig(arch=arch, mlp_hidden_size=16),
        optim=mod.OptimConfig(lr=0.1), train=mod.TrainConfig(local_step=2),
        mesh=mod.MeshConfig(client_fusion=fusion)).finalize()


def test_axes_and_cell_names_are_the_jax_package_s():
    assert (trp.SOURCES, trp.DISPATCHES, trp.EXECUTIONS) == (
        jrp.SOURCES, jrp.DISPATCHES, jrp.EXECUTIONS)
    assert list(trp.iter_cells()) == list(jrp.iter_cells())
    for cell in trp.iter_cells():
        assert trp.cell_name(*cell) == jrp.cell_name(*cell)
        assert trp.cell_build_facts(*cell, client_shards=2) == \
            jrp.cell_build_facts(*cell, client_shards=2)
    assert trp.ASYNC_ALGORITHMS == jrp.ASYNC_ALGORITHMS
    with pytest.raises(ValueError, match="unknown round-program cell"):
        trp.illegal_reason("disk", "round", "vmap", cfg=None, algorithm=None,
                           model=None, mesh_devices=1, k_online=2)


@pytest.mark.parametrize("setup", sorted(SETUPS))
@pytest.mark.parametrize("source, dispatch, execution",
                         list(jrp.iter_cells()))
def test_port_refuses_where_the_jax_package_refuses(source, dispatch,
                                                    execution, setup):
    facts = trp.cell_build_facts(source, dispatch, execution)
    kw = dict(plane=facts["data_plane"], sync_mode=facts["sync_mode"],
              fusion=execution, **SETUPS[setup])
    has_val = setup == "apfl"
    jc, tc = _cfg(jcfg, **kw), _cfg(tcfg, **kw)
    want = jrp.illegal_reason(
        source, dispatch, execution, cfg=jc, algorithm=jmake(jc),
        model=jdefine(jc, batch_size=4), mesh_devices=1, k_online=2,
        has_val=has_val)
    got = trp.illegal_reason(source, dispatch, execution, cfg=tc,
                             algorithm=tmake(tc),
                             model=tdefine(tc, batch_size=4, device="cpu"),
                             mesh_devices=1, k_online=2, has_val=has_val)
    assert got == want


@pytest.mark.parametrize("shards, devices", [(2, 1), (0, 4)],
                         ids=["client_shards", "mesh_devices"])
def test_fused_multi_device_refusals_are_the_jax_text(shards, devices):
    """The fused execution on more than one device group: client shards
    (the JAX package's fused x multi-shard rule, word for word) and a
    mesh of several devices."""
    def cfg(mod):
        c = _cfg(mod, fusion="fused", arch="cnn")
        return mod.ExperimentConfig(**dict(
            {f: getattr(c, f) for f in c.__dataclass_fields__},
            mesh=mod.MeshConfig(client_fusion="fused",
                                client_shards=shards))).finalize()
    jc, tc = cfg(jcfg), cfg(tcfg)
    for source, dispatch in (("resident", "round"), ("feed", "scan")):
        want = jrp.illegal_reason(
            source, dispatch, "fused", cfg=jc, algorithm=jmake(jc),
            model=jdefine(jc, batch_size=4), mesh_devices=devices,
            k_online=2)
        got = trp.illegal_reason(
            source, dispatch, "fused", cfg=tc, algorithm=tmake(tc),
            model=tdefine(tc, batch_size=4, device="cpu"),
            mesh_devices=devices, k_online=2)
        assert want is not None and got == want


def test_feed_layout_is_the_jax_stream_plane_s_gather_mode():
    for setup, fed in SETUPS.items():
        jc, tc = _cfg(jcfg, **fed), _cfg(tcfg, **fed)
        want = jrp.resolve_gather_mode(
            "auto", algorithm=jmake(jc), data_plane="stream",
            local_steps=2, batch_size=4, n_max=4)
        assert trp.feed_layout(tmake(tc)) == want, setup


def _data():
    rng = np.random.RandomState(0)
    sizes = [6, 8, 5, 8, 7, 8, 3, 8]
    ends = np.cumsum(sizes)
    feats = rng.randn(sum(sizes), 32, 32, 3).astype(np.float32)
    return stack_partitions(feats, rng.randint(0, 10, sum(sizes)),
                            [np.arange(e - s, e) for s, e in zip(sizes, ends)])


def _trainer(**kw):
    cfg = _cfg(tcfg, **kw)
    t = FederatedTrainer(cfg, tdefine(cfg, device="cpu"), tmake(cfg),
                         _data(), device="cpu")
    t.stream_timeout_s = 20.0
    return t


@pytest.mark.parametrize("kw", [
    dict(sync_mode="async"),
    dict(plane="stream", sync_mode="async"),
])
def test_the_base_trainer_refuses_the_commit_dispatch(kw):
    """The commit dispatch runs on ``AsyncFederatedTrainer``; the
    round-synchronous base trainer refuses it by name as the JAX
    package's does."""
    with pytest.raises(ValueError) as err:
        _trainer(**kw)
    assert "base FederatedTrainer is round-synchronous" in str(err.value)


@pytest.mark.parametrize("plane", ["device", "stream"])
def test_the_fused_execution_serves_the_round_and_scan_cells(plane):
    """``client_fusion='fused'`` on the ``cnn``: ``run_round`` and
    ``run_rounds(2)`` (the round and scan cells) on either source, the
    scan bitwise the rounds."""
    a, b = (_trainer(plane=plane, fusion="fused", arch="cnn")
            for _ in range(2))
    assert a.client_fusion == "fused" and a.programs.execution == "fused"
    sa, ca = a.init_state(3)
    sb, cb = b.init_state(3)
    for _ in range(2):
        sa, ca, m = a.run_round(sa, ca)
    sb, cb, ms = b.run_rounds(sb, cb, 2)
    a.close()
    b.close()
    assert torch.equal(ms.train_loss[-1], m.train_loss)
    for n, p in sa.params.items():
        assert torch.equal(p, sb.params[n]), n


@pytest.mark.parametrize("fed, match", [
    (dict(drfa=True, drfa_lambda_sampling=True), "participation"),
])
def test_feed_source_preconditions_refuse_at_construction(fed, match):
    with pytest.raises(ValueError, match=re.escape(
            trp.cell_name("feed", "round", "vmap")) + ".*" + match):
        _trainer(plane="stream", **fed)
    _trainer(**fed)  # the resident source serves it


def test_validation_splits_are_refused_on_the_feed_source():
    cfg = _cfg(tcfg, plane="stream", algorithm="apfl")
    with pytest.raises(ValueError, match="validation splits"):
        FederatedTrainer(cfg, tdefine(cfg, device="cpu"), tmake(cfg),
                         _data(), val_data=_data(), device="cpu")


def test_run_rounds_refuses_zero_rounds_before_consuming_feeds():
    t = _trainer(plane="stream")
    server, clients = t.init_state(1)
    with pytest.raises(ValueError, match="num_rounds >= 1"):
        t.run_rounds(server, clients, 0)
    assert t.stream_stats() is None  # no producer was started
    server, clients, _ = t.run_round(server, clients)
    t.close()
    ref = _trainer()
    rs, rc = ref.init_state(1)
    rs, rc, _ = ref.run_round(rs, rc)
    for n, p in rs.params.items():
        assert torch.equal(p, server.params[n]), n


def test_scan_cell_stacks_the_per_round_metrics():
    """``run_rounds(R)`` is R rounds of ``run_round``: the same state and
    each round's metrics on a leading [R] axis."""
    a, b = _trainer(), _trainer()
    sa, ca = a.init_state(2)
    sb, cb = b.init_state(2)
    rows = []
    for _ in range(3):
        sa, ca, m = a.run_round(sa, ca)
        rows.append(m)
    sb, cb, ms = b.run_rounds(sb, cb, 3)
    assert ms.train_loss.shape == (3, 8)
    for f, got in zip(rows[0]._fields, ms):
        want = [getattr(m, f) for m in rows]
        if got is None:  # the DP gauges, DP off
            assert all(w is None for w in want), f
            continue
        assert torch.equal(got, torch.stack(want)), f
    for n, p in sa.params.items():
        assert torch.equal(p, sb.params[n]), n
    assert torch.equal(sa.rng.get_state(), sb.rng.get_state())
