"""The port's static analysis (``fedtorch_tpu_torch/lint``) on the CPU.

* Concurrency audit: every synthetic source of
  ``tests/test_concurrency_audit.py`` gives the same findings (rule,
  line) through the JAX pass and the port's copy, as a module outside
  the package and as one inside it (FTH006 holds only the package's own
  writers); the port's tree has no FTH001, and its gate is clean against
  its baseline.
* Registry audit: the FTC source extractors give equal sets on the same
  sources in both packages, and the port's registries show no drift.
* Host-sync lint: each rule fires on a seeded snippet and is silent on
  the fixed form; the suppression syntax works; the gates exit 0 on the
  tree against the checked-in baselines; a host sync seeded into
  ``parallel/federated.py`` makes the gate fail.
"""
import ast
import os
import shutil
import textwrap

import pytest

import torch_threads  # noqa: F401 (two torch threads a worker)
from fedtorch_tpu.lint import concurrency_audit as jconc
from fedtorch_tpu.lint import registry_audit as jreg
from fedtorch_tpu_torch.lint import cli as tlint
from fedtorch_tpu_torch.lint import concurrency_audit as tconc
from fedtorch_tpu_torch.lint import registry_audit as treg
from fedtorch_tpu_torch.lint.analyzer import analyze_source
from fedtorch_tpu_torch.lint.rules import (
    ALL_RULES, NO_TORCH_MEANING, PROGRAM_RULES, explain,
)
from torch_lifecycle import REPO

CONC_CASES = os.path.join(REPO, "tests", "test_concurrency_audit.py")


def _synthetic_sources():
    """Every string constant of the JAX concurrency tests that is a
    Python module (dedented): their seeded hazards and fixed forms."""
    out = []
    for node in ast.walk(ast.parse(open(CONC_CASES).read())):
        if isinstance(node, ast.Constant) and isinstance(node.value, str) \
                and "\n" in node.value and "def " in node.value:
            src = textwrap.dedent(node.value)
            try:
                ast.parse(src)
            except SyntaxError:
                continue
            out.append((node.lineno, src))
    return out


SOURCES = _synthetic_sources()


def _hits(fn, src, path):
    return [(f.rule, f.line) for f in fn(src, path)]


@pytest.mark.parametrize("line, src", SOURCES,
                         ids=[f"line{n}" for n, _ in SOURCES])
def test_concurrency_findings_equal_the_jax_pass(line, src):
    for jpath, tpath in (("snippet.py", "snippet.py"),
                         ("fedtorch_tpu/fake_mod.py",
                          "fedtorch_tpu_torch/fake_mod.py")):
        assert _hits(tconc.analyze_concurrency_source, src, tpath) == \
            _hits(jconc.analyze_concurrency_source, src, jpath), jpath


def test_the_synthetic_sources_cover_every_fth_rule():
    assert len(SOURCES) >= 15
    seen = {r for _, src in SOURCES for r, _ in _hits(
        tconc.analyze_concurrency_source, src, "fedtorch_tpu_torch/m.py")}
    assert seen == {"FTH001", "FTH002", "FTH003", "FTH004", "FTH005",
                    "FTH006"}


def test_the_concurrency_targets_are_the_port_and_the_chip_script():
    assert tconc.CONCURRENCY_TARGETS == ("fedtorch_tpu_torch",
                                         "chip_smoke.py")
    assert tconc.CONCURRENCY_BASELINE_REL == os.path.join(
        "fedtorch_tpu_torch", "lint", "concurrency_baseline.json")


# -- the registry audit -------------------------------------------------------

def _src(rel):
    return open(os.path.join(REPO, rel), encoding="utf-8").read()


def _port_modules():
    out = []
    for dirpath, _, files in os.walk(os.path.join(REPO,
                                                  "fedtorch_tpu_torch")):
        out += [os.path.relpath(os.path.join(dirpath, f), REPO)
                for f in files if f.endswith(".py")]
    return sorted(out)


@pytest.mark.parametrize("extractor", [
    "emitted_row_fields_from_source", "emitted_event_names_from_source",
    "parser_dests", "consumed_args", "axis_tuples", "documented_rule_ids"])
def test_registry_extractors_equal_the_jax_ones(extractor):
    sources = [_src(p) for p in (
        "fedtorch_tpu_torch/cli.py", "fedtorch_tpu/cli.py",
        "fedtorch_tpu_torch/parallel/federated.py",
        "fedtorch_tpu/parallel/federated.py",
        "fedtorch_tpu_torch/parallel/round_program.py",
        "fedtorch_tpu/parallel/round_program.py",
        "fedtorch_tpu_torch/telemetry/costs.py",
        "fedtorch_tpu/telemetry/costs.py", "README.md")
        if not (p.endswith(".md") and extractor != "documented_rule_ids")]
    if extractor == "emitted_event_names_from_source":
        sources += [_src(p) for p in _port_modules()]
    for src in sources:
        assert getattr(treg, extractor)(src) == \
            getattr(jreg, extractor)(src)


def test_seam_literals_equal_the_jax_ones():
    from fedtorch_tpu_torch.config import HOST_FAULT_SEAMS
    for text in (_src("README.md"), _src("fedtorch_tpu_torch/cli.py")):
        assert treg.seam_literals(text, HOST_FAULT_SEAMS) == \
            jreg.seam_literals(text, HOST_FAULT_SEAMS)


def test_registry_drift_is_reported():
    """Each diff on a seeded drift: an uncataloged row field, an
    unlisted event, an unconsumed flag, an unreadable axis tuple, an
    undocumented rule."""
    f = treg.diff_metric_fields({"loss", "new_gauge"}, {"loss", "old"})
    assert [x.source_line for x in f] == ["new_gauge", "old"]
    f = treg.diff_event_names({"run.start", "x.y"}, {"run.start"})
    assert [x.rule for x in f] == ["FTC002"]
    f = treg.diff_config_cli({"lr": 3, "ghost": 9}, {"lr", "typo"})
    assert sorted(x.source_line for x in f) == ["ghost", "typo"]
    assert [x.rule for x in treg.diff_builder_cells({}, "")] == ["FTC005"]
    axes = {"SOURCES": (), "DISPATCHES": (), "EXECUTIONS": ()}
    assert len(treg.diff_builder_cells(axes, "iter_cells only")) == 1
    assert [x.source_line for x in treg.diff_rule_docs(
        ["FTL001", "FTH001"], {"FTL001"})] == ["FTH001"]


# -- the host-sync lint -------------------------------------------------------

HOT = """\
import torch
import numpy as np


class Trainer:
    def run_round(self, server, clients):
        x = torch.zeros(3)
        {line}
        return server
"""

RULE_CASES = [
    ("FTL001", "v = x.sum().item()", "v = x.sum()"),
    ("FTL001", "v = float(x.max())", "v = x.max()"),
    ("FTL001", "v = x.tolist()", "v = len(x)"),
    ("FTL001", "v = x.cpu()", "v = x.shape"),
    ("FTL001", "v = np.asarray(x)", "v = np.asarray(x.shape)"),
    ("FTL001", "torch.cuda.synchronize()", "torch.cuda.current_device()"),
    ("FTL001", "v = int(server.round)", "v = int(x.numel())"),
    ("FTL005", "assert x.sum() > 0", "assert x.dim() == 1"),
    ("FTL005", "v = 1 if x.any() else 0", "v = 1 if x.shape[0] else 0"),
    ("FTL003", "v = torch.rand(3)",
     "v = torch.rand(3, generator=server.rng)"),
    ("FTL003", "v = x.uniform_()", "v = x.uniform_(generator=server.rng)"),
    ("FTL003", "v = torch.nn.functional.dropout(x, 0.5)",
     "v = torch.nn.functional.relu(x)"),
]


@pytest.mark.parametrize("rule, bad, good", RULE_CASES)
def test_each_rule_fires_on_the_hazard_and_not_on_the_fix(rule, bad, good):
    assert [(f.rule, f.line) for f in analyze_source(
        HOT.format(line=bad), "m.py")] == [(rule, 8)]
    assert analyze_source(HOT.format(line=good), "m.py") == []


def test_hot_means_reachable_from_the_round_s_entry_points():
    src = """\
import torch


class T:
    def run_round(self, s):
        return self._helper(s) + inner(s)

    def _helper(self, s):
        return s.item()

    def setup(self, s):
        return s.item()


def inner(s):
    def closure(t):
        return float(t)
    return closure(s)


def not_hot(s):
    return s.item()
"""
    assert [(f.rule, f.line) for f in analyze_source(src, "m.py")] == [
        ("FTL001", 9), ("FTL001", 17)]


def test_host_parameters_and_metadata_are_not_tensors():
    src = """\
import torch


def local_step(params, step_idx: int, cfg: OptimConfig, train=False):
    if step_idx + 1 == 2 or train or cfg.nesterov:
        n = params.numel()
    if params is None or len(params) > params.shape[0]:
        return int(params.dim())
    return params
"""
    assert analyze_source(src, "m.py") == []


def test_a_suppression_needs_its_reason():
    line = "v = x.sum().item()  # lint: disable=FTL001"
    assert [f.rule for f in analyze_source(HOT.format(line=line),
                                           "m.py")] == ["FTL001"]
    line += " — the one fetch"
    assert analyze_source(HOT.format(line=line), "m.py") == []


@pytest.mark.parametrize("argv, says", [
    ([], " baselined)"),
    # no FTH001 anywhere in the port: a cycle is never baselined
    (["--concurrency"], "0 hard)"),
    # the port's registries show no drift
    (["--audit", "--registry-only"], "(0 registry, 0 concurrency); no "
                                     "program audit")])
def test_the_gates_exit_0_on_the_tree(argv, says, capsys):
    assert tlint.main(argv) == 0
    out = capsys.readouterr().out
    assert "0 NEW finding(s)" in out and says in out


def test_a_host_sync_seeded_in_federated_py_fails_the_gate(tmp_path,
                                                           capsys):
    rel = os.path.join("fedtorch_tpu_torch", "parallel", "federated.py")
    fed = tmp_path / rel
    fed.parent.mkdir(parents=True)
    shutil.copy(os.path.join(REPO, rel), fed)
    argv = ["--root", str(tmp_path), "--baseline", tlint.DEFAULT_BASELINE,
            rel]
    assert tlint.main(argv) == 0
    text = fed.read_text()
    anchor = "    def _round_core(self, server: ServerState, " \
             "clients: ClientState,"
    assert anchor in text
    head, tail = text.split(anchor, 1)
    body_at = tail.index('"""', tail.index('"""') + 3) + 3
    fed.write_text(head + anchor + tail[:body_at]
                   + "\n        _probe = float(server.params[next(iter("
                     "server.params))].sum())" + tail[body_at:])
    capsys.readouterr()
    assert tlint.main(argv) == 1
    out = capsys.readouterr().out
    assert "FTL001" in out and "parallel/federated.py" in out
    assert "1 NEW finding(s)" in out


def test_the_catalog_says_what_has_no_torch_meaning(capsys):
    text = explain()
    for rid in list(ALL_RULES) + list(NO_TORCH_MEANING):
        assert rid in text
    assert set(NO_TORCH_MEANING) == {"FTL002", "FTL004"}
    stand_ins = {r: PROGRAM_RULES[r].hint for r in PROGRAM_RULES}
    assert "SyncSentinel" in stand_ins["FTP002"]
    assert "collective_budget" in stand_ins["FTP004"]
    assert "hbm_program_peak_bytes" in stand_ins["FTP006"]
    assert "bfloat16" in stand_ins["FTP001"]
    assert tlint.main(["--explain"]) == 0
    assert "no eager-torch meaning" in capsys.readouterr().out
