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


@pytest.mark.parametrize("override, name", [
    (dict(fault__client_drop_rate=0.1), "chaos"),
    (dict(fault__guard_updates=True), "guards"),
    (dict(fault__robust_agg="median"), "robust_agg"),
    (dict(fault__dp_noise_multiplier=1.0), "DP"),
    (dict(fault__avail_dropout_rate=0.1), "availability"),
    (dict(mesh__client_shards=2), "client_shards"),
    (dict(telemetry__cohort_stats=True), "cohort stats"),
    (dict(federated__sync_mode="async"), "async"),
    (dict(data__data_plane="stream"), "stream"),
    (dict(mesh__client_fusion="fused"), "fused"),
    (dict(federated__compressed=True), "compressed"),
    (dict(federated__algorithm="scaffold"), "scaffold"),
    (dict(federated__participation_mode="sparse"), "participation_mode"),
])
def test_unported_trainer_features_raise_by_name(override, name):
    cfg = _cfg(**override)
    model = define_model(_cfg(), device="cpu")
    with pytest.raises(ValueError, match=f"{name}.*not yet ported"):
        FederatedTrainer(cfg, model, make_algorithm(_cfg()), _data(),
                         device="cpu")


@pytest.mark.parametrize("override, name", [
    (dict(model__arch="cnn"), "cnn"),
    (dict(model__arch="wideresnet16"), "wideresnet16"),
    (dict(model__norm="gn"), "gn"),
    (dict(model__conv_impl="matmul"), "matmul"),
    (dict(mesh__remat=True), "remat"),
    (dict(data__dataset="mnist"), "mnist"),
])
def test_unported_models_raise_by_name(override, name):
    with pytest.raises(ValueError, match=f"{name}.*not yet ported"):
        define_model(_cfg(**override), device="cpu")


@pytest.mark.parametrize("algorithm", ["scaffold", "apfl", "qffl"])
def test_unported_algorithms_raise_by_name(algorithm):
    with pytest.raises(ValueError, match=f"{algorithm}.*not yet ported"):
        make_algorithm(_cfg(federated__algorithm=algorithm))


def test_config_is_a_copy_not_an_import():
    import fedtorch_tpu.config as jcfg
    assert tcfg.ExperimentConfig is not jcfg.ExperimentConfig
    assert [f.name for f in dataclasses.fields(tcfg.ExperimentConfig)] == \
        [f.name for f in dataclasses.fields(jcfg.ExperimentConfig)]
    assert "fedtorch_tpu." not in fedtorch_tpu_torch.__doc__.replace(
        "fedtorch_tpu_torch", "")
