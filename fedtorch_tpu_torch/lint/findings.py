"""Finding records, suppression comments, and the regression baseline
(port of ``fedtorch_tpu/lint/findings.py``; the same fingerprints,
suppression syntax and baseline format).

The analyzers (``fedtorch_tpu_torch.lint.analyzer`` and
``concurrency_audit``) emit :class:`Finding` records; this module owns
everything around them:

* the stable **fingerprint** a finding is tracked by — ``path : rule :
  normalized source line`` — deliberately excludes the line *number* so
  unrelated edits above a finding don't churn the baseline;
* **suppressions**: a ``# lint: disable=FTL00x — <justification>``
  comment on the flagged line (or the line above) silences a rule at
  that site.  A justification is REQUIRED — a bare ``disable`` does not
  suppress, so every accepted hazard carries its reason in the source;
* the **baseline** file (JSON, checked in): a multiset of fingerprints
  for accepted pre-existing findings, so the gate fails only on
  regressions.  Removing a finding never fails the gate (the baseline
  may go stale-generous); adding one not in the baseline does.

Stdlib-only on purpose: the linter imports (and runs in CI) without
torch.
"""
from __future__ import annotations

import dataclasses
import json
import re
from collections import Counter
from typing import Dict, Iterable, List, Tuple


@dataclasses.dataclass(frozen=True)
class Finding:
    """One analyzer hit: where, which rule, and how to fix it."""
    path: str          # repo-relative, posix separators
    line: int          # 1-indexed
    col: int           # 0-indexed (ast convention)
    rule: str          # e.g. "FTL001"
    message: str       # what is wrong at this site
    hint: str = ""     # how to fix it
    source_line: str = ""  # the stripped source text of ``line``

    def fingerprint(self) -> str:
        # whitespace-insensitive so reindenting doesn't churn the
        # baseline; line numbers are deliberately not part of it
        norm = re.sub(r"\s+", " ", self.source_line.strip())
        return f"{self.path}:{self.rule}:{norm}"

    def render(self) -> str:
        out = f"{self.path}:{self.line}:{self.col + 1}: " \
              f"{self.rule} {self.message}"
        if self.hint:
            out += f"\n    hint: {self.hint}"
        return out


# -- suppression comments ---------------------------------------------------

_SUPPRESS_RE = re.compile(
    r"#\s*lint:\s*disable=([A-Z]{3}\d{3}(?:\s*,\s*[A-Z]{3}\d{3})*|all)"
    r"(.*)$")


def suppressions_for_source(src: str) -> Dict[int, set]:
    """Map line number -> set of rule ids suppressed there.

    A suppression comment covers its own line and the line below it
    (so it can sit on the preceding line of a long expression).  A
    comment with no justification text after the rule list suppresses
    NOTHING — the discipline is "accepted hazards carry their reason".
    """
    out: Dict[int, set] = {}
    for i, text in enumerate(src.splitlines(), 1):
        m = _SUPPRESS_RE.search(text)
        if not m:
            continue
        justification = m.group(2).strip(" -—:.")
        if not justification:
            continue  # bare disable: intentionally inert
        rules = {r.strip() for r in m.group(1).split(",")}
        for line in (i, i + 1):
            out.setdefault(line, set()).update(rules)
    return out


def apply_suppressions(findings: Iterable[Finding],
                       by_line: Dict[int, set]) -> List[Finding]:
    kept = []
    for f in findings:
        rules = by_line.get(f.line, set())
        if f.rule in rules or "all" in rules:
            continue
        kept.append(f)
    return kept


# -- baseline ---------------------------------------------------------------

BASELINE_VERSION = 1


def save_baseline(path: str, findings: Iterable[Finding],
                  comment: str = "Accepted pre-existing "
                  "fedtorch_tpu_torch.lint findings. Regenerate with: "
                  "python -m fedtorch_tpu_torch.lint --write-baseline"
                  ) -> None:
    counts = Counter(f.fingerprint() for f in findings)
    doc = {
        "version": BASELINE_VERSION,
        "comment": comment,
        "fingerprints": {k: counts[k] for k in sorted(counts)},
    }
    with open(path, "w") as fh:
        json.dump(doc, fh, indent=2, sort_keys=False)
        fh.write("\n")


def load_baseline(path: str) -> Counter:
    try:
        with open(path) as fh:
            doc = json.load(fh)
    except OSError:
        return Counter()
    return Counter({k: int(v) for k, v in
                    doc.get("fingerprints", {}).items()})


def diff_against_baseline(findings: List[Finding], baseline: Counter,
                          ) -> Tuple[List[Finding], int]:
    """Return (new findings, number of baseline entries matched).

    The baseline is a multiset: two accepted FTL001 hits on identical
    source lines need a count of 2; a third identical hit is new.
    """
    budget = Counter(baseline)
    new: List[Finding] = []
    matched = 0
    for f in sorted(findings, key=lambda f: (f.path, f.line, f.rule)):
        fp = f.fingerprint()
        if budget[fp] > 0:
            budget[fp] -= 1
            matched += 1
        else:
            new.append(f)
    return new, matched
