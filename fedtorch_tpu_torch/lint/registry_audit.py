"""Registry-drift audit over the port's own registries (the port's
counterpart of ``fedtorch_tpu/lint/registry_audit.py``; the same rule
ids, its source extractors word for word).

The port keeps these registries by hand, and this checker holds each to
its sources:

* the **metrics-row field catalog** (``telemetry/schema.py``
  ``METRICS_REQUIRED``/``METRICS_OPTIONAL``) against the fields the
  port's round loop and gauge providers emit (FTC001);
* ``telemetry/schema.py`` ``EVENT_NAMES`` against every
  ``*.event("...")`` emit site of the port (FTC002);
* ``config.HOST_FAULT_SEAMS`` against the port's drill
  (``tests/test_torch_host_chaos.py``, which enumerates the tuple), the
  README's port section (the ``--host_fault_seams`` line) and
  ``robustness/host_chaos.py`` ``UNPORTED_SEAMS`` (FTC003);
* the port CLI's parser against the ``args.*`` fields
  ``args_to_config`` and ``main`` consume (FTC004);
* ``parallel/round_program.py``'s axis tuples against the port's
  refusal test (``tests/test_torch_round_program.py``, which holds
  every cell's ``illegal_reason`` to the JAX package's) (FTC005);
* the registered rule ids against the README's rule tables (FTC006).

The JAX rules' legs against the JAX package's documents
(``docs/observability.md``'s metric and event lists,
``docs/robustness.md``'s seam table) have no port: the port writes the
JAX package's telemetry schema, and ``tests/test_torch_telemetry.py``
holds its rows to the JAX validators, so that document describes the
port's rows too; the port's seams are listed in the README.

Stdlib only (``ast`` + text scans + imports of the port's torch-free
``telemetry.schema`` and ``config``). Each check is an EXTRACTION
(source -> name set) and a DIFF (set logic -> findings). The audit ships
with no baseline: registry drift is fixed, not accepted.
"""
from __future__ import annotations

import ast
import os
import re
from typing import Dict, Iterable, List, Set, Tuple

from fedtorch_tpu_torch.lint.findings import Finding
from fedtorch_tpu_torch.lint.rules import hint_for

_P = "fedtorch_tpu_torch/"

# catalog entries intentionally without a live emit site (none today; a
# future reserved gauge goes here WITH a comment saying why)
RESERVED_METRIC_FIELDS: Tuple[str, ...] = ()

# argparse dests that are deliberately not config fields (consumed by
# main()/run_experiment directly, not args_to_config)
NON_CONFIG_DESTS: Tuple[str, ...] = ("download",)

# functions whose returned dict keys ride the metrics row
_GAUGE_FN_NAMES = {"stats", "telemetry_gauges", "round_gauges"}


def _finding(path: str, line: int, rule: str, message: str,
             evidence: str = "") -> Finding:
    return Finding(path=path, line=line, col=0, rule=rule,
                   message=message, hint=hint_for(rule),
                   source_line=evidence)


def _read(root: str, rel: str) -> str:
    with open(os.path.join(root, rel), encoding="utf-8") as fh:
        return fh.read()


def _str_keys(node: ast.AST) -> List[str]:
    """String keys of a dict literal node."""
    out = []
    if isinstance(node, ast.Dict):
        for k in node.keys:
            if isinstance(k, ast.Constant) and isinstance(k.value, str):
                out.append(k.value)
    return out


# -- FTC001: metrics-row fields ------------------------------------------

def emitted_row_fields_from_source(src: str) -> Set[str]:
    """Field names one module contributes to the metrics row:

    * keys of the round loop's ``row = {...}`` literal,
      ``row["x"] = ...`` assignments, and ``row.update(x=..., {...})``;
    * keys of dict literals built/returned inside functions named
      ``stats`` / ``telemetry_gauges`` / ``round_gauges`` (the gauge
      providers the loop merges in), including ``out["x"] = ...`` and
      ``out.update({...}, x=...)`` inside them.
    """
    tree = ast.parse(src)
    fields: Set[str] = set()

    def collect_updates(call: ast.Call) -> None:
        for kw in call.keywords:
            if kw.arg is not None:
                fields.add(kw.arg)
            else:
                fields.update(_str_keys(kw.value))
        for a in call.args:
            fields.update(_str_keys(a))

    # the row loop's direct writes
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign):
            for tgt in node.targets:
                if isinstance(tgt, ast.Name) and tgt.id == "row":
                    fields.update(_str_keys(node.value))
                if isinstance(tgt, ast.Subscript) and \
                        isinstance(tgt.value, ast.Name) and \
                        tgt.value.id == "row" and \
                        isinstance(tgt.slice, ast.Constant) and \
                        isinstance(tgt.slice.value, str):
                    fields.add(tgt.slice.value)
        elif isinstance(node, ast.Call) and \
                isinstance(node.func, ast.Attribute) and \
                node.func.attr == "update" and \
                isinstance(node.func.value, ast.Name) and \
                node.func.value.id == "row":
            collect_updates(node)

    # gauge-provider functions
    for node in ast.walk(tree):
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                or node.name not in _GAUGE_FN_NAMES:
            continue
        for sub in ast.walk(node):
            if isinstance(sub, ast.Dict):
                fields.update(_str_keys(sub))
            elif isinstance(sub, ast.Assign):
                for tgt in sub.targets:
                    if isinstance(tgt, ast.Subscript) and \
                            isinstance(tgt.slice, ast.Constant) and \
                            isinstance(tgt.slice.value, str):
                        fields.add(tgt.slice.value)
            elif isinstance(sub, ast.Call) and \
                    isinstance(sub.func, ast.Attribute) and \
                    sub.func.attr == "update":
                collect_updates(sub)
    return fields


# the port's emit sites. data/streaming.py's producer stats() is not a
# row provider in the port: FederatedTrainer.telemetry_gauges renames its
# keys to the catalog's stream_* fields
_EMIT_SITE_FILES = tuple(_P + f for f in (
    "cli.py",
    "parallel/federated.py",
    "async_plane/commit.py",
    "utils/checkpoint.py",
    "robustness/host_recovery.py",
    "robustness/host_chaos.py",
    "telemetry/costs.py",
    "telemetry/ledger.py",
    # the writer itself stamps every row (seq + t)
    "telemetry/metrics.py",
))


def emitted_row_fields(root: str) -> Set[str]:
    fields: Set[str] = set()
    for rel in _EMIT_SITE_FILES:
        fields.update(emitted_row_fields_from_source(_read(root, rel)))
    return fields


def cataloged_row_fields() -> Set[str]:
    from fedtorch_tpu_torch.telemetry.schema import all_metric_fields
    return set(all_metric_fields())


def diff_metric_fields(emitted: Set[str], cataloged: Set[str],
                       reserved: Iterable[str] = RESERVED_METRIC_FIELDS
                       ) -> List[Finding]:
    out = []
    schema_path = _P + "telemetry/schema.py"
    for f in sorted(emitted - cataloged):
        out.append(_finding(
            schema_path, 0, "FTC001",
            f"metrics-row field {f!r} is emitted but not cataloged in "
            "METRICS_REQUIRED/METRICS_OPTIONAL", f))
    for f in sorted(cataloged - emitted - set(reserved)):
        out.append(_finding(
            schema_path, 0, "FTC001",
            f"cataloged metrics-row field {f!r} has no emit site "
            "(and is not in RESERVED_METRIC_FIELDS)", f))
    return out


# -- FTC002: event names -------------------------------------------------

_EVENT_NAME_RE = re.compile(r"^[a-z_]+\.[a-z_]+$")


def emitted_event_names_from_source(src: str) -> Set[str]:
    """First string argument of every ``*.event("name", ...)`` call."""
    names: Set[str] = set()
    for node in ast.walk(ast.parse(src)):
        if isinstance(node, ast.Call) and \
                isinstance(node.func, ast.Attribute) and \
                node.func.attr == "event" and node.args and \
                isinstance(node.args[0], ast.Constant) and \
                isinstance(node.args[0].value, str):
            names.add(node.args[0].value)
    return names


def emitted_event_names(root: str) -> Set[str]:
    names: Set[str] = set()
    pkg = os.path.join(root, _P)
    for dirpath, dirnames, filenames in os.walk(pkg):
        dirnames[:] = [d for d in dirnames if d != "__pycache__"]
        for fn in filenames:
            if not fn.endswith(".py"):
                continue
            src = open(os.path.join(dirpath, fn), encoding="utf-8").read()
            for name in emitted_event_names_from_source(src):
                if _EVENT_NAME_RE.match(name):
                    names.add(name)
    return names


def diff_event_names(emitted: Set[str], cataloged: Set[str]
                     ) -> List[Finding]:
    out = []
    schema_path = _P + "telemetry/schema.py"
    for n in sorted(emitted - cataloged):
        out.append(_finding(
            schema_path, 0, "FTC002",
            f"event {n!r} is emitted but missing from EVENT_NAMES", n))
    for n in sorted(cataloged - emitted):
        out.append(_finding(
            schema_path, 0, "FTC002",
            f"EVENT_NAMES lists event {n!r} with no emit site in the "
            "port", n))
    return out


# -- FTC003: host-fault seams --------------------------------------------

def seam_literals(src: str, seams: Iterable[str]) -> Set[str]:
    """Which of ``seams`` appear verbatim (as string content) in a
    source/doc text — used for the CLI help and drill coverage."""
    return {s for s in seams if s in src}


def _readme_port_section(readme: str) -> str:
    lo = readme.find("## PyTorch/CUDA port")
    hi = readme.find("\n## ", lo + 1)
    return readme[lo:hi] if 0 <= lo < hi else readme[max(lo, 0):]


_DRILL = "tests/test_torch_host_chaos.py"


def check_seams(root: str) -> List[Finding]:
    from fedtorch_tpu_torch.config import HOST_FAULT_SEAMS
    from fedtorch_tpu_torch.robustness.host_chaos import UNPORTED_SEAMS
    seams = set(HOST_FAULT_SEAMS)
    out: List[Finding] = []
    for s in sorted(set(UNPORTED_SEAMS) - seams):
        out.append(_finding(
            _P + "robustness/host_chaos.py", 0, "FTC003",
            f"UNPORTED_SEAMS names {s!r}, which is not in "
            "config.HOST_FAULT_SEAMS", s))
    readme = _readme_port_section(_read(root, "README.md"))
    for s in sorted(seams - seam_literals(readme, seams)):
        out.append(_finding(
            "README.md", 0, "FTC003",
            f"seam {s!r} is missing from the README's port section", s))
    drill_src = _read(root, _DRILL)
    if "HOST_FAULT_SEAMS" not in drill_src \
            or "UNPORTED_SEAMS" not in drill_src:
        out.append(_finding(
            _DRILL, 0, "FTC003",
            "the port's host-fault drill no longer enumerates "
            "config.HOST_FAULT_SEAMS less UNPORTED_SEAMS — a new seam "
            "can land without a drill cell", "HOST_FAULT_SEAMS"))
    return out


# -- FTC004: config <-> CLI surface --------------------------------------

def parser_dests(src: str) -> Dict[str, int]:
    """argparse dest -> line for every ``add_argument`` call in
    ``build_parser``: the explicit ``dest=`` when given, else derived
    from the first long option."""
    dests: Dict[str, int] = {}
    for node in ast.walk(ast.parse(src)):
        if not (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr == "add_argument"):
            continue
        dest = None
        for kw in node.keywords:
            if kw.arg == "dest" and isinstance(kw.value, ast.Constant):
                dest = kw.value.value
        if dest is None:
            for a in node.args:
                if isinstance(a, ast.Constant) and \
                        isinstance(a.value, str) and \
                        a.value.startswith("--"):
                    dest = a.value[2:].replace("-", "_")
                    break
        if dest is not None:
            dests[dest] = node.lineno
    return dests


def consumed_args(src: str) -> Set[str]:
    """``args.X`` attribute loads inside ``args_to_config`` and
    ``main`` (the two consumers of the parsed namespace)."""
    tree = ast.parse(src)
    used: Set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                and node.name in ("args_to_config", "main"):
            for sub in ast.walk(node):
                if isinstance(sub, ast.Attribute) and \
                        isinstance(sub.value, ast.Name) and \
                        sub.value.id == "args":
                    used.add(sub.attr)
    return used


def diff_config_cli(dests: Dict[str, int], used: Set[str],
                    non_config: Iterable[str] = NON_CONFIG_DESTS
                    ) -> List[Finding]:
    out = []
    cli_path = _P + "cli.py"
    for d in sorted(set(dests) - used - set(non_config)):
        out.append(_finding(
            cli_path, dests[d], "FTC004",
            f"CLI flag dest {d!r} is parsed but never consumed by "
            "args_to_config/main — the flag silently does nothing", d))
    for a in sorted(used - set(dests)):
        out.append(_finding(
            cli_path, 0, "FTC004",
            f"args_to_config reads args.{a} but no add_argument "
            "defines that dest — it raises AttributeError at run "
            "time", a))
    return out


def check_config_cli(root: str) -> List[Finding]:
    src = _read(root, _P + "cli.py")
    return diff_config_cli(parser_dests(src), consumed_args(src))


# -- FTC005: builder cells -------------------------------------------------

def axis_tuples(round_program_src: str) -> Dict[str, Tuple[str, ...]]:
    """The SOURCES/DISPATCHES/EXECUTIONS tuples, read off the AST so
    the checker never imports jax."""
    out: Dict[str, Tuple[str, ...]] = {}
    for node in ast.walk(ast.parse(round_program_src)):
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name) \
                and node.targets[0].id in ("SOURCES", "DISPATCHES",
                                           "EXECUTIONS") \
                and isinstance(node.value, ast.Tuple):
            out[node.targets[0].id] = tuple(
                e.value for e in node.value.elts
                if isinstance(e, ast.Constant))
    return out


_REFUSAL_TEST = "tests/test_torch_round_program.py"


def diff_builder_cells(axes: Dict[str, Tuple[str, ...]],
                       test_src: str) -> List[Finding]:
    if set(axes) != {"SOURCES", "DISPATCHES", "EXECUTIONS"}:
        return [_finding(
            _P + "parallel/round_program.py", 0, "FTC005",
            "could not read the SOURCES/DISPATCHES/EXECUTIONS axis "
            "tuples from round_program.py", str(sorted(axes)))]
    out = []
    for needle, why in (
            ("iter_cells", "no longer enumerates iter_cells() — a new "
                           "axis value could be silently absent"),
            ("illegal_reason", "no longer holds illegal_reason to the "
                               "JAX package's — the refusal half is "
                               "ungated")):
        if needle not in test_src:
            out.append(_finding(_REFUSAL_TEST, 0, "FTC005",
                                f"{_REFUSAL_TEST} {why}", needle))
    return out


def check_builder_cells(root: str) -> List[Finding]:
    rp = _read(root, _P + "parallel/round_program.py")
    return diff_builder_cells(axis_tuples(rp), _read(root, _REFUSAL_TEST))


# -- FTC006: lint-rule docs drift ----------------------------------------

_RULE_ID_RE = re.compile(r"`([A-Z]{3}\d{3})`")


def documented_rule_ids(doc_text: str) -> Set[str]:
    """Backticked rule ids appearing anywhere in the doc (the pinned
    markdown_table renders each id as `FTXnnn`)."""
    return set(_RULE_ID_RE.findall(doc_text))


def diff_rule_docs(rule_ids: Iterable[str],
                   documented: Set[str]) -> List[Finding]:
    return [_finding(
        "README.md", 0, "FTC006",
        f"rule {rid} is registered in lint/rules.py but absent from the "
        "README's port rule tables", rid)
        for rid in sorted(set(rule_ids) - documented)]


def check_rule_docs(root: str) -> List[Finding]:
    from fedtorch_tpu_torch.lint.rules import ALL_RULES
    doc = _readme_port_section(_read(root, "README.md"))
    return diff_rule_docs(ALL_RULES, documented_rule_ids(doc))


# -- the whole registry audit --------------------------------------------

def audit_registries(root: str) -> List[Finding]:
    """All FTC checks over a checkout; sorted findings."""
    from fedtorch_tpu_torch.telemetry.schema import EVENT_NAMES
    findings: List[Finding] = []
    findings += diff_metric_fields(emitted_row_fields(root),
                                   cataloged_row_fields())
    findings += diff_event_names(emitted_event_names(root),
                                 set(EVENT_NAMES))
    findings += check_seams(root)
    findings += check_config_cli(root)
    findings += check_builder_cells(root)
    findings += check_rule_docs(root)
    return sorted(findings, key=lambda f: (f.rule, f.path, f.message))
