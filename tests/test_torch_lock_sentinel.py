"""The port's lock-order sentinel (``fedtorch_tpu_torch/utils/
lock_sentinel.py``) against the JAX package's, on the CPU.

* Every case of ``tests/test_lock_sentinel.py`` runs twice: once as it
  is, once with its module's ``tel_faults``, ``LockOrderSentinel`` and
  ``active_sentinel`` bound to the port's. Both runs pass, and every
  sentinel the case made gives the same order edges and the same
  violations (a violation compared up to its trailing " — " remark,
  which names the JAX package's history; the one check of that remark
  reads the port's wording instead).
* A CPU CLI run under a strict sentinel, with telemetry, the async
  checkpoint writer, the watchdog, the stream prefetcher and host chaos
  armed, exits clean, and the port's named locks are among those the
  sentinel saw.
"""
import importlib.util
import os
import re

import pytest

import torch_threads  # noqa: F401 (two torch threads a worker)
from fedtorch_tpu.telemetry import faults as jfaults
from fedtorch_tpu.utils import lock_sentinel as jsent
from fedtorch_tpu_torch import cli as tcli
from fedtorch_tpu_torch.telemetry import faults as tfaults
from fedtorch_tpu_torch.utils import lock_sentinel as tsent
from torch_lifecycle import REPO, cli_argv

CASES_FILE = os.path.join(REPO, "tests", "test_lock_sentinel.py")


def _case_names():
    import ast
    tree = ast.parse(open(CASES_FILE).read())
    return [n.name for n in tree.body
            if isinstance(n, ast.FunctionDef) and n.name.startswith("test_")]


def _run_case(name, faults_mod, sent_mod):
    """Run one JAX case with its names bound to one package: returns the
    (edges, violations) of every sentinel it made, in order."""
    src = re.sub(r'any\("[^"]*" in v for v in s\.violations\)',
                 'any("re-entrant" in v for v in s.violations)',
                 open(CASES_FILE).read())
    spec = importlib.util.spec_from_loader(f"lock_cases_{name}",
                                           loader=None)
    mod = importlib.util.module_from_spec(spec)
    exec(compile(src, CASES_FILE, "exec"), mod.__dict__)
    made = []

    class Recording(sent_mod.LockOrderSentinel):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)

    mod.tel_faults = faults_mod
    mod.LockOrderSentinel = Recording
    mod.active_sentinel = sent_mod.active_sentinel
    getattr(mod, name)()
    return [(s.order_edges(), [v.split(" — ")[0] for v in s.violations])
            for s in made]


@pytest.mark.parametrize("case", _case_names())
def test_every_jax_case_gives_the_same_edges_and_violations(case):
    want = _run_case(case, jfaults, jsent)
    got = _run_case(case, tfaults, tsent)
    assert want, case  # the case made a sentinel
    assert got == want


def test_a_cli_run_with_the_host_plane_armed_is_clean(tmp_path):
    words = ["--backend", "cpu", "--data_plane", "stream",
             "--async_checkpoint", "--watchdog_timeout_s", "300",
             "--host_fault_seams", "stream.gather,ckpt.write",
             "--host_fault_rate", "0.3", "--host_fault_seed", "2",
             "--host_retry_backoff_s", "0"]
    with tsent.LockOrderSentinel(strict=True) as s:
        res = tcli.main(cli_argv(tmp_path / "run", rounds=3, extra=words))
    assert res["rounds"] == 3 and s.violations == []
    assert res["host_recovery"]["host_faults"] >= 1
    assert {"JsonlWriter._mutex", "JsonlWriter._open_lock",
            "JsonlWriter._io_lock", "HostRecovery._lock",
            "HostFaultInjector._lock", "AsyncCheckpointer._gauges"} <= \
        set(s.lock_names())
    assert tfaults.new_lock("after") is not None
    assert tsent.active_sentinel() is None
