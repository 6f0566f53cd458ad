"""The module map (``fedtorch_tpu_torch/port_map.py``) against the
tree: every module of the JAX package has a row, no row names a module
that is gone, every ported row names a port module that exists, and
every other row gives its ROADMAP item or its reason."""
import glob
import os

import torch_threads  # noqa: F401 (two torch threads a worker)
from fedtorch_tpu_torch.port_map import MODULE_MAP

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_modules():
    return sorted(os.path.relpath(p, REPO) for p in glob.glob(
        os.path.join(REPO, "fedtorch_tpu", "**", "*.py"), recursive=True))


def test_every_jax_module_has_exactly_one_row():
    modules = _jax_modules()
    assert len(modules) >= 113
    assert sorted(MODULE_MAP) == modules


def test_ported_rows_name_port_modules_that_exist():
    ported = {k: v for k, (s, v) in MODULE_MAP.items() if s == "ported"}
    assert len(ported) >= 50
    for jax_module, port_module in ported.items():
        assert port_module.startswith("fedtorch_tpu_torch/"), jax_module
        assert os.path.isfile(os.path.join(REPO, port_module)), jax_module


def test_every_other_row_says_why():
    roadmap = open(os.path.join(REPO, "ROADMAP.md")).read()
    for module, (status, detail) in MODULE_MAP.items():
        assert status in ("ported", "queued", "no port"), module
        if status == "queued":
            item = detail.split(":")[0].split()[-1]  # "ROADMAP A5: ..."
            assert detail.startswith("ROADMAP A"), module
            assert f"\n{item[1:]}. " in roadmap or f" {item[1:]}. " in \
                roadmap, (module, item)
        elif status == "no port":
            assert len(detail) > 30, module
