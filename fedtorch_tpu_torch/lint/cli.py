"""``python -m fedtorch_tpu_torch.lint`` and the port CLI's ``lint`` and
``audit`` subcommands (port of ``fedtorch_tpu/lint/cli.py``).

Runs the host-sync analyzer over the port (the package and
``chip_smoke.py``), diffs against the checked-in baseline, and exits
non-zero only on NEW findings:

    python -m fedtorch_tpu_torch.lint                 # gate
    python -m fedtorch_tpu_torch.lint --all           # ignore the baseline
    python -m fedtorch_tpu_torch.lint --write-baseline  # accept the tree
    python -m fedtorch_tpu_torch.lint --explain       # rule catalog
    python -m fedtorch_tpu_torch.lint path/to/file.py # specific targets

``--concurrency`` runs the host-plane concurrency audit (FTH rules)
instead, gated against ``lint/concurrency_baseline.json``, except FTH001
lock-order cycles, which are hard errors and bypass the baseline.

``--audit`` (``python -m fedtorch_tpu_torch.cli audit``) runs the
registry audit (FTC rules) and the concurrency gate. The JAX package's
audit has a third half, the program audit (FTP rules), which lowers
every round-program cell to XLA; eager torch lowers no program, so the
port has none (``--registry-only`` is accepted and changes nothing).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List, Optional

from fedtorch_tpu_torch.lint.analyzer import analyze_paths
from fedtorch_tpu_torch.lint.findings import (
    diff_against_baseline, load_baseline, save_baseline,
)
from fedtorch_tpu_torch.lint.rules import explain

DEFAULT_TARGETS = ("fedtorch_tpu_torch", "chip_smoke.py")
DEFAULT_BASELINE = os.path.join(os.path.dirname(os.path.abspath(
    __file__)), "baseline.json")
NO_PROGRAM_HALF = ("no program audit: eager torch lowers no program; the "
                   "runtime checks that stand for its FTP rules are listed "
                   "by --explain")


def repo_root() -> str:
    """The directory the package sits in (works from a checkout)."""
    return os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m fedtorch_tpu_torch.lint",
        description="Static analysis of the PyTorch/CUDA port: host syncs "
                    "in the round's hot path, host-plane concurrency, "
                    "registry drift")
    p.add_argument("targets", nargs="*", default=None,
                   help="files/dirs relative to the repo root "
                        f"(default: {' '.join(DEFAULT_TARGETS)})")
    p.add_argument("--root", default=None,
                   help="repo root (default: auto-detected)")
    p.add_argument("--baseline", default=DEFAULT_BASELINE,
                   help="baseline JSON path")
    p.add_argument("--all", action="store_true",
                   help="report every finding, ignoring the baseline")
    p.add_argument("--write-baseline", action="store_true",
                   help="accept the current findings as the baseline")
    p.add_argument("--format", choices=("text", "json"), default="text")
    p.add_argument("--explain", action="store_true",
                   help="print the rule catalog and exit")
    p.add_argument("--audit", action="store_true",
                   help="run the registry-drift audit and the concurrency "
                        "gate instead of the host-sync gate")
    p.add_argument("--concurrency", action="store_true",
                   help="run the host-plane concurrency audit (FTH "
                        "rules) instead of the host-sync gate")
    p.add_argument("--registry-only", action="store_true",
                   help="with --audit: accepted for the JAX package's "
                        "command line; the port's audit has no program "
                        "half")
    p.add_argument("--out", default=None,
                   help="with --audit or --concurrency: write the report "
                        "document (JSON) to this path")
    return p


def _write_report(path: str, doc: dict) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w") as fh:
        json.dump(doc, fh, indent=2, sort_keys=True)
        fh.write("\n")
    os.replace(tmp, path)


def run_concurrency(args) -> int:
    """The concurrency gate: FTH findings diffed against
    ``lint/concurrency_baseline.json``; FTH001 cycles are hard errors
    (never baselined, and ``--write-baseline`` refuses to pin them)."""
    from fedtorch_tpu_torch.lint.concurrency_audit import (
        CONCURRENCY_BASELINE_REL, CONCURRENCY_TARGETS,
        audit_concurrency_paths, split_hard_findings,
    )

    root = args.root or repo_root()
    targets = args.targets or list(CONCURRENCY_TARGETS)
    baseline_path = args.baseline if args.baseline != DEFAULT_BASELINE \
        else os.path.join(root, CONCURRENCY_BASELINE_REL)
    findings = audit_concurrency_paths(root, targets)
    hard, soft = split_hard_findings(findings)

    if args.write_baseline:
        save_baseline(baseline_path, soft, comment=(
            "Accepted pre-existing FTH findings of the port. Regenerate "
            "with: python -m fedtorch_tpu_torch.lint --concurrency "
            "--write-baseline"))
        print(f"wrote {len(soft)} finding(s) to {baseline_path}")
        for f in hard:
            print(f.render())
        if hard:
            print(f"fedtorch_tpu_torch.lint --concurrency: {len(hard)} "
                  "FTH001 cycle(s) NOT baselined — hard errors")
            return 1
        return 0

    if args.all:
        new, matched = findings, 0
    else:
        new_soft, matched = diff_against_baseline(
            soft, load_baseline(baseline_path))
        new = sorted(hard + new_soft,
                     key=lambda f: (f.path, f.line, f.rule))

    report = {"total": len(findings), "baselined": matched,
              "hard_errors": len(hard),
              "new": [f.__dict__ for f in new]}
    if args.format == "json":
        print(json.dumps(report, indent=2))
    else:
        for f in new:
            print(f.render())
        label = "finding(s)" if args.all else "NEW finding(s)"
        print(f"fedtorch_tpu_torch.lint --concurrency: {len(new)} {label} "
              f"({len(findings)} total, {matched} baselined, "
              f"{len(hard)} hard)")
    if args.out:
        _write_report(args.out, report)
        print(f"concurrency report written to {args.out}")
    return 1 if new else 0


def run_audit(args) -> int:
    """``python -m fedtorch_tpu_torch.cli audit``: the registry audit and
    the concurrency gate (both stdlib)."""
    from fedtorch_tpu_torch.lint.concurrency_audit import concurrency_gate
    from fedtorch_tpu_torch.lint.registry_audit import audit_registries

    root = args.root or repo_root()
    reg_findings = audit_registries(root)
    conc_new, conc_total = concurrency_gate(root)
    findings = list(reg_findings) + conc_new
    report = {"registry_findings": len(reg_findings),
              "concurrency_findings": len(conc_new),
              "concurrency_total": conc_total,
              "program": NO_PROGRAM_HALF}
    if args.format == "json":
        print(json.dumps({"new": [f.__dict__ for f in findings], **report},
                         indent=2))
    else:
        for f in findings:
            print(f.render())
        print(f"fedtorch_tpu_torch audit: {len(findings)} NEW finding(s) "
              f"({len(reg_findings)} registry, {len(conc_new)} "
              f"concurrency); {NO_PROGRAM_HALF}")
    if args.out:
        _write_report(args.out, dict(
            report, findings=[f.__dict__ for f in findings]))
        print(f"audit report written to {args.out}")
    return 1 if findings else 0


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    if args.explain:
        print(explain())
        return 0
    if args.audit:
        return run_audit(args)
    if args.concurrency:
        return run_concurrency(args)
    root = args.root or repo_root()
    targets = args.targets or list(DEFAULT_TARGETS)
    findings = analyze_paths(root, targets)

    if args.write_baseline:
        save_baseline(args.baseline, findings)
        print(f"wrote {len(findings)} finding(s) to {args.baseline}")
        return 0

    if args.all:
        new, matched = findings, 0
    else:
        new, matched = diff_against_baseline(findings,
                                             load_baseline(args.baseline))

    if args.format == "json":
        print(json.dumps({
            "total": len(findings), "baselined": matched,
            "new": [f.__dict__ for f in new]}, indent=2))
    else:
        for f in new:
            print(f.render())
        label = "finding(s)" if args.all else "NEW finding(s)"
        print(f"fedtorch_tpu_torch.lint: {len(new)} {label} "
              f"({len(findings)} total, {matched} baselined)")
    return 1 if new else 0


if __name__ == "__main__":
    sys.exit(main())
