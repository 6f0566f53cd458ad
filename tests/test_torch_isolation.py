"""The port stands alone: it imports no JAX, no flax and nothing of the
JAX package, runs on CUDA unless asked otherwise, and refuses what it
has not ported by name."""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401 (two torch threads a worker)
import fedtorch_tpu_torch
from fedtorch_tpu_torch import config as tcfg
from fedtorch_tpu_torch.algorithms import make_algorithm
from fedtorch_tpu_torch.data.batching import stack_partitions
from fedtorch_tpu_torch.models import define_model
from fedtorch_tpu_torch.parallel import FederatedTrainer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_ISOLATED_IMPORT = r"""
import importlib, importlib.abc, pkgutil, sys

sys.modules["jax"] = None
sys.modules["flax"] = None


class RefuseJaxPackage(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        # fedtorch_tpu and fedtorch_tpu.*, but not fedtorch_tpu_torch
        if name == "fedtorch_tpu" or name.startswith("fedtorch_tpu."):
            raise ImportError(f"the port imported {name}")
        return None


sys.meta_path.insert(0, RefuseJaxPackage())
import fedtorch_tpu_torch

names = [m.name for m in pkgutil.walk_packages(
    fedtorch_tpu_torch.__path__, "fedtorch_tpu_torch.")]
for name in names:
    importlib.import_module(name)
# the model-parallel forwards, the client-shard seam and the MoE
# transformer are among them
assert {"fedtorch_tpu_torch.parallel." + m for m in (
    "sequence", "expert", "tensor", "pipeline", "mesh", "podscale")
    } <= set(names), names
from fedtorch_tpu_torch.models.transformer import (  # noqa: F401
    MoEMLP, long_context_apply, routing_fractions)
from fedtorch_tpu_torch.parallel import (  # noqa: F401
    ep_moe_apply, pipeline_apply, ring_attention, tp_apply,
    ulysses_attention)
from fedtorch_tpu_torch.parallel.mesh import (  # noqa: F401
    init_multihost, local_cohort_rows, make_mesh)
from fedtorch_tpu_torch.parallel.podscale import (  # noqa: F401
    cohort_allreduce_bytes, cohort_group_count, cohort_hierarchical_sum)
bad = sorted(m for m in sys.modules
             if m in ("jax", "flax") or m == "fedtorch_tpu"
             or m.startswith(("jax.", "flax.", "fedtorch_tpu.")))
assert not [m for m in bad if sys.modules[m] is not None], bad
print(len(names), "modules")
"""


def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    r = subprocess.run([sys.executable, "-c", _ISOLATED_IMPORT], cwd=REPO,
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    n = int(r.stdout.split()[0])
    assert n >= 20, r.stdout  # every module of the port was walked


def _cfg(**over):
    sections = dict(
        data=dict(dataset="cifar10", batch_size=4, augment=False),
        federated=dict(federated=True, num_clients=4,
                       online_client_rate=0.5, algorithm="fedavg",
                       sync_type="local_step"),
        model=dict(arch="resnet8"), fault={}, mesh={}, telemetry={},
        optim={}, train=dict(local_step=1))
    for key, value in over.items():
        section, field = key.split("__")
        sections[section][field] = value
    names = dict(data="DataConfig", federated="FederatedConfig",
                 model="ModelConfig", fault="FaultConfig", mesh="MeshConfig",
                 telemetry="TelemetryConfig", optim="OptimConfig",
                 train="TrainConfig")
    return tcfg.ExperimentConfig(**{
        s: getattr(tcfg, names[s])(**kw) for s, kw in sections.items()
    }).finalize()


def _data():
    rng = np.random.RandomState(0)
    return stack_partitions(rng.randn(16, 32, 32, 3).astype(np.float32),
                            rng.randint(0, 10, 16),
                            [np.arange(4 * i, 4 * i + 4) for i in range(4)])


def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = _cfg()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        define_model(cfg)
    model = define_model(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        FederatedTrainer(cfg, model, make_algorithm(cfg), _data())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        define_model(cfg, device="cuda")
    # asked for the CPU, it runs there
    FederatedTrainer(cfg, model, make_algorithm(cfg), _data(),
                     device="cpu")


@pytest.mark.parametrize("override", [
    dict(data__data_plane="stream"),
    dict(federated__participation_mode="sparse"),
], ids=["stream", "participation_mode"])
def test_stream_plane_and_sparse_participation_run_a_round(override):
    """Once refused by name, now ported: a finite round through
    ``run_round``, with no population on the stream plane's device
    side."""
    cfg = _cfg(**override)
    trainer = FederatedTrainer(cfg, define_model(cfg, device="cpu"),
                               make_algorithm(cfg), _data(), device="cpu")
    server, clients = trainer.init_state(0)
    server, clients, metrics = trainer.run_round(server, clients)
    trainer.close()
    assert server.round == 1 and int(metrics.online_mask.sum()) == 2
    assert bool(torch.isfinite(metrics.train_loss).all())
    assert (trainer.data is None) == (cfg.data.data_plane == "stream")


@pytest.mark.parametrize("override", [
    dict(telemetry__cohort_stats=True),
    dict(federated__sync_mode="async"),
    dict(federated__sync_mode="async", data__data_plane="stream"),
], ids=["cohort_stats", "async", "async_stream"])
def test_cohort_stats_and_the_async_plane_run_a_round(override):
    """Once refused by name, now ported: a finite round (a commit, on
    the async trainer) through ``run_round``, with the cohort vectors
    [k] when the statistics are on."""
    from fedtorch_tpu_torch.async_plane import AsyncFederatedTrainer
    cfg = _cfg(**dict(override, federated__num_clients=4))
    cls = AsyncFederatedTrainer \
        if cfg.federated.sync_mode == "async" else FederatedTrainer
    trainer = cls(cfg, define_model(cfg, device="cpu"),
                  make_algorithm(cfg), _data(), device="cpu")
    server, clients = trainer.init_state(0)
    server, clients, metrics = trainer.run_round(server, clients)
    trainer.close()
    assert server.round == 1
    assert bool(torch.isfinite(metrics.train_loss).all())
    if cfg.telemetry.cohort_stats:
        assert metrics.cohort_idx.shape == (2,)
        assert bool(torch.isfinite(metrics.cohort_suspicion).all())


def test_client_fusion_runs_a_round():
    """Once refused by name, now ported: the fused execution's finite
    round through ``run_round``."""
    cfg = _cfg(mesh__client_fusion="fused")
    trainer = FederatedTrainer(cfg, define_model(cfg, device="cpu"),
                               make_algorithm(cfg), _data(), device="cpu")
    assert trainer.client_fusion == "fused"
    server, clients = trainer.init_state(0)
    server, clients, metrics = trainer.run_round(server, clients)
    assert server.round == 1 and int(metrics.online_mask.sum()) == 2
    assert bool(torch.isfinite(metrics.train_loss).all())


@pytest.mark.parametrize("override, name", [
    (dict(data__dataset="mnist"), "mnist"),
])
def test_unported_models_raise_by_name(override, name):
    with pytest.raises(ValueError, match=f"{name}.*not yet ported"):
        define_model(_cfg(**override), device="cpu")


@pytest.mark.parametrize("override", [
    dict(mesh__remat=True),
    dict(model__arch="transformer", mesh__remat=True),
], ids=["resnet8", "transformer"])
def test_remat_builds_and_trains(override):
    """Once refused by name, now ported: ``remat`` builds, and its
    training forward and backward give finite gradients."""
    cfg = _cfg(**override)
    model = define_model(cfg, device="cpu")
    assert model.module.remat
    params = {n: v.detach().requires_grad_(True) for n, v in
              model.init(torch.Generator().manual_seed(0)).items()}
    x = torch.randn(2, 32, 32, 3) if cfg.model.arch == "resnet8" \
        else torch.randint(0, 86, (2, 16))
    out = model.apply(params, x, train=True)
    grads = torch.autograd.grad(out.float().square().mean(),
                                list(params.values()))
    assert all(bool(torch.isfinite(g).all()) for g in grads)


@pytest.mark.parametrize("algorithm", ["perfedme", "apfl", "perfedavg"])
def test_personalized_algorithms_run_a_round_on_the_cpu(algorithm):
    """Through ``make_algorithm`` and ``FederatedTrainer`` with the
    clients' validation rows: a finite round, and ``evaluate_personal``'s
    finite [C] losses."""
    from fedtorch_tpu_torch.parallel import evaluate_personal
    cfg = _cfg(federated__algorithm=algorithm)
    rng = np.random.RandomState(1)
    val = stack_partitions(rng.randn(8, 32, 32, 3).astype(np.float32),
                           rng.randint(0, 10, 8),
                           [np.arange(2 * i, 2 * i + 2) for i in range(4)])
    trainer = FederatedTrainer(cfg, define_model(cfg, device="cpu"),
                               make_algorithm(cfg), _data(), val_data=val,
                               device="cpu")
    server, clients = trainer.init_state(0)
    server, clients, metrics = trainer.run_rounds(server, clients, 1)
    assert bool(torch.isfinite(metrics.train_loss).all())
    losses, _, _ = evaluate_personal(trainer.model, clients.aux,
                                     clients.params, trainer.val_data,
                                     algorithm)
    assert losses.shape == (4,) and bool(torch.isfinite(losses).all())


def test_config_is_a_copy_not_an_import():
    import fedtorch_tpu.config as jcfg
    assert tcfg.ExperimentConfig is not jcfg.ExperimentConfig
    assert [f.name for f in dataclasses.fields(tcfg.ExperimentConfig)] == \
        [f.name for f in dataclasses.fields(jcfg.ExperimentConfig)]
    assert "fedtorch_tpu." not in fedtorch_tpu_torch.__doc__.replace(
        "fedtorch_tpu_torch", "")
