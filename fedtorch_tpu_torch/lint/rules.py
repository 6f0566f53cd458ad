"""Rule registry of the port's static analysis: ids, rationale, fix hints
(port of ``fedtorch_tpu/lint/rules.py``).

The detection logic lives in ``analyzer.py`` (FTL: host syncs and the
global generator in the round's hot functions), ``concurrency_audit.py``
(FTH: host-plane lock/thread hazards) and ``registry_audit.py`` (FTC:
drift between the port's hand-kept registries and their sources). This
module is the one place a rule's id, title and fix hint are defined, so
``--explain``, the README's tables (:func:`markdown_table`, pinned by
FTC006) and the findings cannot drift apart.

Where a JAX rule has no meaning in eager PyTorch the catalog says why
(:data:`NO_TORCH_MEANING`), and where the JAX package's program audit
(FTP rules, checks over a lowered XLA program) has a runtime check in
the port that stands for it, :data:`PROGRAM_RULES` names that check.

Why each FTL rule exists on a CUDA card:

* FTL001: ``.item()``, ``.tolist()``, ``.cpu()``, ``.numpy()``,
  ``float()``/``int()``/``bool()`` of a tensor, ``np.asarray`` of a
  tensor and ``torch.cuda.synchronize()`` block the host until the
  stream drains. The port's round is host-bound (the host issues every
  launch), so each sync in the round's hot path idles the card while the
  next launches are queued and caps throughput.
* FTL003: a random op without ``generator=`` draws from torch's global
  generator instead of the round's explicit plan generators, so two runs
  from one seed stop agreeing as soon as anything else draws.
* FTL005: ``if``/``while``/a ternary/``assert`` on a tensor calls
  ``bool()`` on it: an implicit host sync.
"""
from __future__ import annotations

from typing import Dict, NamedTuple


class Rule(NamedTuple):
    rule_id: str
    title: str
    hint: str


RULES: Dict[str, Rule] = {r.rule_id: r for r in [
    Rule("FTL001",
         "host sync on a tensor in the round's hot path "
         "(.item()/.tolist()/.cpu()/.numpy()/float()/int()/bool()/"
         "np.asarray/torch.cuda.synchronize())",
         "keep the value on the device, or batch it into the round's one "
         "fetch (FederatedTrainer.round_host_scalars)"),
    Rule("FTL003",
         "random op in the round's hot path without generator= (draws "
         "from torch's global generator)",
         "pass the round's plan generator (generator=...), as every draw "
         "of the round does"),
    Rule("FTL005",
         "Python branch on a tensor value in the round's hot path (an "
         "implicit bool(): a host sync)",
         "use torch.where / a mask, or decide from host state the round "
         "already holds"),
]}

# JAX rules with no eager-torch meaning: rule id -> why
NO_TORCH_MEANING: Dict[str, str] = {
    "FTL002": "numpy inside jitted code: eager torch traces nothing, so "
              "numpy runs when it is called (a host value; FTL001 covers "
              "numpy of a tensor)",
    "FTL004": "buffer donation to jax.jit: eager torch updates tensors in "
              "place and frees them by reference count",
}

# Program-level rules of the JAX package's program audit: they check a
# lowered XLA program, which eager torch never builds. Title: the
# runtime check of the port that stands for the rule, where one exists.
PROGRAM_RULES: Dict[str, Rule] = {r.rule_id: r for r in [
    Rule("FTP001",
         "dtype promotion in the lowered program",
         "stand-in: the models refuse compute dtypes other than float32 "
         "and bfloat16 (models/__init__.py define_model)"),
    Rule("FTP002",
         "host transfer inside the program body",
         "stand-in: utils.tracing.SyncSentinel counts and names the "
         "round's synchronizing CUDA calls"),
    Rule("FTP003",
         "ineffective donation",
         "no stand-in: eager torch donates nothing (FTL004)"),
    Rule("FTP004",
         "collective count over the cell's budget",
         "stand-in: parallel.podscale.collective_count held to "
         "parallel.round_program.collective_budget"),
    Rule("FTP005",
         "large constant baked into the lowered program",
         "no stand-in: eager torch bakes no constant into a program"),
    Rule("FTP006",
         "peak device-memory regression",
         "stand-in: the hbm_program_peak_bytes gauge "
         "(torch.cuda.max_memory_allocated over round 0, "
         "telemetry.costs)"),
]}

# Host-plane concurrency rules (concurrency_audit.py), the JAX package's
# word for word. FTH001 findings are HARD errors: a lock-order cycle
# cannot be baselined, only refactored away.
CONCURRENCY_RULES: Dict[str, Rule] = {r.rule_id: r for r in [
    Rule("FTH001",
         "lock-order cycle across host-plane call paths "
         "(with-blocks and bare .acquire())",
         "impose one documented acquisition order and release before "
         "calling into the other subsystem — cycles are hard errors "
         "and cannot be baselined"),
    Rule("FTH002",
         "telemetry/health emit reachable while holding a lock "
         "(the injector self-deadlock class)",
         "snapshot the announce fields inside the with-block and call "
         "telemetry.event / faults.check after releasing — an emit "
         "can re-enter the writer whose lock is held"),
    Rule("FTH003",
         "attribute written on a spawned thread and read from "
         "main-thread methods with no common lock",
         "take the writer's lock on the read side too, or justify the "
         "GIL-atomic single-store with a suppression naming the "
         "invariant"),
    Rule("FTH004",
         "unbounded blocking (queue get/put, join, wait, acquire "
         "without timeout) while holding a lock or inside a daemon "
         "worker",
         "pass a timeout and re-check the stop flag in a loop — a "
         "bounded wait keeps close() and the stall watchdog able to "
         "make progress"),
    Rule("FTH005",
         "thread spawned without a stable name= or daemon thread "
         "with no close/join path",
         "name every thread (watchdog stack dumps, span lanes, and "
         "sentinel reports key on it) and join daemon workers in a "
         "close() with a timeout"),
    Rule("FTH006",
         "run-dir artifact written without the write-tmp-then-"
         "os.replace protocol",
         "write to a tmp sibling and os.replace into place (health/"
         "ledger/checkpoint writers are the reference); append-mode "
         "jsonl is the other sanctioned shape"),
]}

# Registry-drift rules over the port's own registries (registry_audit.py)
REGISTRY_RULES: Dict[str, Rule] = {r.rule_id: r for r in [
    Rule("FTC001",
         "metrics-row field drift: emitted by the port vs "
         "telemetry.schema's catalog",
         "catalog every emitted row field in METRICS_REQUIRED/"
         "METRICS_OPTIONAL, and emit every cataloged one somewhere (or "
         "list it in RESERVED_METRIC_FIELDS)"),
    Rule("FTC002",
         "event-name drift: emitted telemetry events vs "
         "telemetry.schema.EVENT_NAMES",
         "add the new event name to EVENT_NAMES (or delete the dead "
         "emit site)"),
    Rule("FTC003",
         "host-fault-seam drift: config.HOST_FAULT_SEAMS vs the port's "
         "drill, the README's port section and host_chaos.UNPORTED_SEAMS",
         "a seam needs the config tuple, a drill cell (the drill "
         "enumerates HOST_FAULT_SEAMS) and the README's --host_fault_"
         "seams line, or an UNPORTED_SEAMS entry saying why not"),
    Rule("FTC004",
         "config<->CLI drift: argparse dests vs the args.* fields "
         "args_to_config consumes",
         "wire the flag through args_to_config (or drop it); a "
         "parsed-but-unconsumed flag silently ignores user intent"),
    Rule("FTC005",
         "builder-cell drift: round_program's axis tuples vs the port's "
         "refusal test",
         "the refusal test must enumerate iter_cells() and hold each "
         "cell's illegal_reason to the JAX package's"),
    Rule("FTC006",
         "lint-rule docs drift: registered rule ids absent from the "
         "README's port tables",
         "paste markdown_table() of each family into the README's "
         "static-analysis section — the tables are generated"),
]}

ALL_RULES: Dict[str, Rule] = {
    **RULES, **CONCURRENCY_RULES, **PROGRAM_RULES, **REGISTRY_RULES}


def hint_for(rule_id: str) -> str:
    return ALL_RULES[rule_id].hint


def markdown_table(rules: Dict[str, Rule]) -> str:
    """A rule family as the README's table renders it."""
    lines = ["| id | finding | fix |", "|---|---|---|"]
    for r in rules.values():
        lines.append(f"| `{r.rule_id}` | {r.title} | {r.hint} |")
    return "\n".join(lines)


def explain() -> str:
    lines = ["fedtorch_tpu_torch.lint rules", ""]
    for title, family in (
            ("source (python -m fedtorch_tpu_torch.lint)", RULES),
            ("host-plane concurrency (--concurrency)", CONCURRENCY_RULES),
            ("registry drift (fedtorch_tpu_torch.cli audit)",
             REGISTRY_RULES)):
        lines.append(f"-- {title} --")
        for r in family.values():
            lines.append(f"  {r.rule_id}  {r.title}")
            lines.append(f"          fix: {r.hint}")
        lines.append("")
    lines.append("-- no eager-torch meaning --")
    for rid, why in NO_TORCH_MEANING.items():
        lines.append(f"  {rid}  {why}")
    lines.append("")
    lines.append("-- the JAX program audit (no port: eager torch lowers no "
                 "program) --")
    for r in PROGRAM_RULES.values():
        lines.append(f"  {r.rule_id}  {r.title}")
        lines.append(f"          {r.hint}")
    return "\n".join(lines)
