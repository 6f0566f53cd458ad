"""FTH: static concurrency audit of the port's host plane (the port's
own copy of ``fedtorch_tpu/lint/concurrency_audit.py``: the same rules,
walk and findings; its own targets and baseline).

The port's host plane runs several threads in one process: the stream
feed producer (``native/host_pipeline.py`` ``HostPrefetcher``), the
async checkpoint writer (``utils/checkpoint.py``), the stall watchdog
(``robustness/watchdog.py``), the three-lock ``JsonlWriter``, the
fault-injector hooks and the supervisor. This pass gates the hazard
*class* with a stdlib-only AST walk per module that builds

* a **lock-acquisition graph**: which locks a function holds when it
  acquires another (``with``-blocks and bare ``.acquire()``), made
  transitive over the intra-module call graph; and
* a **thread-escape map**: which functions run on a spawned thread
  (``threading.Thread(target=...)`` and producer-callback consumers
  like ``HostPrefetcher``), made transitive the same way.

Rules (registry: ``lint/rules.py`` CONCURRENCY_RULES):

* **FTH001**: lock-order cycle across call paths, including
  re-acquiring a non-reentrant lock already held. HARD errors:
  :func:`split_hard_findings` keeps them out of the baseline diff, so
  a cycle can only be refactored away, never pinned.
* **FTH002**: a telemetry/health emit (``*.event("name", ...)``,
  ``faults.check``/``note_degraded``) reachable while holding ANY
  lock. The emit can re-enter the writer whose lock is held.
* **FTH003**: an attribute written on a spawned thread and read from
  main-thread methods with no common lock.
* **FTH004**: unbounded blocking (``queue.get/put``, ``join``,
  ``wait``, ``acquire`` without timeout) while holding a lock or
  inside a daemon worker.
* **FTH005**: threads spawned without a stable ``name=`` and daemon
  threads with no join path.
* **FTH006**: package run-dir artifact writes (``open(..., "w")``)
  bypassing the write-tmp-then-``os.replace`` protocol.

Analysis is intra-module and conservative: cross-module lock
interactions are the runtime sentinel's job
(``fedtorch_tpu_torch/utils/lock_sentinel.py``).
"""
from __future__ import annotations

import ast
import os
from typing import Dict, List, Optional, Sequence, Set, Tuple

from fedtorch_tpu_torch.lint.analyzer import (
    _attr_path, _set_parents, iter_py_files,
)
from fedtorch_tpu_torch.lint.findings import (
    Finding, apply_suppressions, diff_against_baseline, load_baseline,
    suppressions_for_source,
)
from fedtorch_tpu_torch.lint.rules import hint_for

# What `python -m fedtorch_tpu_torch.lint --concurrency` walks by
# default: the port and the chip script. Tests are excluded on purpose —
# they spawn scratch threads freely.
CONCURRENCY_TARGETS: Tuple[str, ...] = ("fedtorch_tpu_torch",
                                        "chip_smoke.py")
# the package whose run-dir writers FTH006 holds to the protocol
PACKAGE_PREFIX = "fedtorch_tpu_torch/"

# Accepted findings live here (FTH001 excepted — hard errors).
CONCURRENCY_BASELINE_REL = os.path.join(
    "fedtorch_tpu_torch", "lint", "concurrency_baseline.json")

_LOCK_CTORS = {"Lock": False, "RLock": True, "Condition": True,
               "Semaphore": False, "BoundedSemaphore": False,
               "new_lock": False}
_QUEUE_CTORS = {"Queue", "SimpleQueue", "LifoQueue", "PriorityQueue",
                "JoinableQueue"}
# Producer-callback consumers that run their first argument on a
# spawned thread (the HostPrefetcher idiom from native/host_pipeline).
_THREAD_CONSUMERS = {"HostPrefetcher"}


def _enclosing_class(node: ast.AST) -> Optional[ast.ClassDef]:
    cur = getattr(node, "_lint_parent", None)
    while cur is not None:
        if isinstance(cur, ast.ClassDef):
            return cur
        cur = getattr(cur, "_lint_parent", None)
    return None


def _scope_parent(node: ast.AST) -> Optional[ast.AST]:
    """The nearest enclosing Module/ClassDef/FunctionDef."""
    cur = getattr(node, "_lint_parent", None)
    while cur is not None:
        if isinstance(cur, (ast.Module, ast.ClassDef, ast.FunctionDef,
                            ast.AsyncFunctionDef)):
            return cur
        cur = getattr(cur, "_lint_parent", None)
    return None


def _const_is(node, value) -> bool:
    return isinstance(node, ast.Constant) and node.value is value


class _FnRecord:
    """Everything the post-passes need about one function."""

    def __init__(self, node, cls: Optional[str], name: str) -> None:
        self.node = node
        self.cls = cls
        self.name = name
        self.qualname = f"{cls}.{name}" if cls else name
        # (lock_id, held_tuple, site)
        self.acquires: List[Tuple[str, Tuple[str, ...], ast.AST]] = []
        # (callee_records_key, held_tuple, site) — resolved later
        self.calls: List[Tuple[List["_FnRecord"], Tuple[str, ...],
                               ast.AST]] = []
        # (held_tuple, site, what) for direct emit calls
        self.emits: List[Tuple[Tuple[str, ...], ast.AST, str]] = []
        # (kind, tail, held_tuple, site) for unbounded blocking calls
        self.blocking: List[Tuple[str, str, Tuple[str, ...],
                                  ast.AST]] = []
        # (cls, attr, held_tuple, site)
        self.attr_writes: List[Tuple[str, str, Tuple[str, ...],
                                     ast.AST]] = []
        self.attr_reads: List[Tuple[str, str, Tuple[str, ...],
                                    ast.AST]] = []
        # (site, mode, path_subtree)
        self.opens: List[Tuple[ast.AST, str, ast.AST]] = []
        self.has_replace = False
        self.direct_emit = False


class _Spawn:
    def __init__(self, site, in_cls, has_name, daemon, targets,
                 assigned_path) -> None:
        self.site = site
        self.in_cls = in_cls
        self.has_name = has_name
        self.daemon = daemon
        self.targets = targets            # raw dotted paths
        self.assigned_path = assigned_path  # "self._thread" / "t" / None


class ConcurrencyAnalysis:
    """Single-module FTH pass."""

    def __init__(self, src: str, path: str) -> None:
        self.src = src
        self.path = path
        self.lines = src.splitlines()
        self.tree = ast.parse(src, filename=path)
        _set_parents(self.tree)
        self.findings: List[Finding] = []
        self._emitted: Set[Tuple[str, int, str]] = set()

        # -- primitive inventory (prepass) --------------------------------
        # lock id ("Cls.attr" / module name) -> reentrant?
        self.locks: Dict[str, bool] = {}
        # (cls, attr) / (None, name) -> kind in
        # {lock, queue, event, thread, tls}
        self.kinds: Dict[Tuple[Optional[str], str], str] = {}
        self._collect_primitives()

        # -- function registry --------------------------------------------
        self.records: List[_FnRecord] = []
        self._methods: Dict[Tuple[str, str], List[_FnRecord]] = {}
        self._bare: Dict[str, List[_FnRecord]] = {}
        for fn in ast.walk(self.tree):
            if not isinstance(fn, (ast.FunctionDef,
                                   ast.AsyncFunctionDef)):
                continue
            cls = _enclosing_class(fn)
            rec = _FnRecord(fn, cls.name if cls else None, fn.name)
            self.records.append(rec)
            if cls is not None:
                self._methods.setdefault((cls.name, fn.name),
                                         []).append(rec)
            if not isinstance(_scope_parent(fn), ast.ClassDef):
                # module-level and nested functions resolve by bare name
                self._bare.setdefault(fn.name, []).append(rec)
        self._module_rec = _FnRecord(self.tree, None, "<module>")
        self.records.append(self._module_rec)

        self.spawns: List[_Spawn] = []
        # functions handed to producer-callback consumers
        self._consumer_targets: List[_FnRecord] = []
        # receiver paths of every `<recv>.join(...)` in the module
        self._join_receivers: Set[str] = set()
        # receiver paths of every `<recv>.daemon = True`
        self._daemon_set: Set[str] = set()
        for node in ast.walk(self.tree):
            if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Attribute) \
                    and node.targets[0].attr == "daemon" \
                    and _const_is(node.value, True):
                recv = _attr_path(node.targets[0].value)
                if recv:
                    self._daemon_set.add(recv)

    # -- prepass ----------------------------------------------------------

    def _ctor_kind(self, call: ast.Call):
        parts = (_attr_path(call.func) or "").split(".")
        tail = parts[-1]
        head_ok = len(parts) == 1 or parts[-2] in (
            "threading", "queue", "multiprocessing")
        if tail == "new_lock":          # telemetry.faults.new_lock
            return "lock", False
        if not head_ok:
            return None, False
        if tail in _LOCK_CTORS:
            return "lock", _LOCK_CTORS[tail]
        if tail in _QUEUE_CTORS:
            return "queue", False
        if tail == "Event":
            return "event", False
        if tail == "Thread":
            return "thread", False
        if tail == "local":
            return "tls", False
        return None, False

    def _collect_primitives(self) -> None:
        for node in ast.walk(self.tree):
            if isinstance(node, ast.Assign) and len(node.targets) == 1:
                tgt = node.targets[0]
            elif isinstance(node, ast.AnnAssign):
                tgt = node.target
            else:
                continue
            if not isinstance(node.value, ast.Call):
                continue
            kind, reentrant = self._ctor_kind(node.value)
            if kind is None:
                continue
            p = _attr_path(tgt)
            if p and p.startswith("self.") and p.count(".") == 1:
                cls = _enclosing_class(node)
                if cls is None:
                    continue
                attr = p.split(".", 1)[1]
                self.kinds[(cls.name, attr)] = kind
                if kind == "lock":
                    self.locks[f"{cls.name}.{attr}"] = reentrant
            elif isinstance(tgt, ast.Name):
                scope = _scope_parent(node)
                if isinstance(scope, ast.Module):
                    self.kinds[(None, tgt.id)] = kind
                    if kind == "lock":
                        self.locks[tgt.id] = reentrant
                elif isinstance(scope, ast.ClassDef):
                    self.kinds[(scope.name, tgt.id)] = kind
                    if kind == "lock":
                        self.locks[f"{scope.name}.{tgt.id}"] = reentrant

    # -- emit -------------------------------------------------------------

    def _emit(self, node: ast.AST, rule: str, message: str) -> None:
        line = getattr(node, "lineno", 1)
        key = (rule, line, message)
        if key in self._emitted:
            return
        self._emitted.add(key)
        text = self.lines[line - 1] if 0 < line <= len(self.lines) \
            else ""
        self.findings.append(Finding(
            path=self.path, line=line,
            col=getattr(node, "col_offset", 0), rule=rule,
            message=message, hint=hint_for(rule), source_line=text))

    # -- lock / callee resolution ----------------------------------------

    def _resolve_lock_path(self, rec: _FnRecord,
                           path: Optional[str]) -> Optional[str]:
        if not path:
            return None
        parts = path.split(".")
        if parts[0] == "self" and len(parts) == 2 and rec.cls:
            if self.kinds.get((rec.cls, parts[1])) == "lock":
                return f"{rec.cls}.{parts[1]}"
        elif len(parts) == 1:
            if self.kinds.get((None, parts[0])) == "lock":
                return parts[0]
        return None

    def _resolve_lock(self, rec: _FnRecord,
                      expr: ast.AST) -> Optional[str]:
        return self._resolve_lock_path(rec, _attr_path(expr))

    def _recv_kind(self, rec: _FnRecord,
                   path: Optional[str]) -> Optional[str]:
        if not path:
            return None
        parts = path.split(".")
        if parts[0] == "self" and len(parts) == 2 and rec.cls:
            return self.kinds.get((rec.cls, parts[1]))
        if len(parts) == 1:
            return self.kinds.get((None, parts[0]))
        return None

    def _resolve_callees(self, rec: _FnRecord,
                         path: str) -> List[_FnRecord]:
        parts = path.split(".")
        if parts[0] == "self" and len(parts) == 2 and rec.cls:
            return self._methods.get((rec.cls, parts[1]), [])
        if len(parts) == 1:
            return self._bare.get(parts[0], [])
        return []

    def _fn_refs(self, rec: _FnRecord,
                 expr: Optional[ast.AST]) -> List[_FnRecord]:
        if expr is None:
            return []
        p = _attr_path(expr)
        return self._resolve_callees(rec, p) if p else []

    # -- emit-call classification ----------------------------------------

    def _is_emit_call(self, parts: List[str], call: ast.Call) -> bool:
        tail = parts[-1]
        if tail == "event" and len(parts) > 1 and call.args \
                and isinstance(call.args[0], ast.Constant) \
                and isinstance(call.args[0].value, str):
            return True
        if tail in ("check", "note_degraded") and len(parts) > 1 \
                and "faults" in parts[-2]:
            return True
        return False

    # -- statement walk ---------------------------------------------------

    def scan(self) -> None:
        for rec in self.records:
            body = rec.node.body
            self._scan_block(rec, body, ())

    def _scan_block(self, rec: _FnRecord, stmts: Sequence[ast.stmt],
                    held: Tuple[str, ...]) -> None:
        cur: List[str] = list(held)
        for stmt in stmts:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                continue  # own records / class bodies
            if isinstance(stmt, (ast.With, ast.AsyncWith)):
                inner = list(cur)
                for item in stmt.items:
                    self._scan_expr(rec, item.context_expr,
                                    tuple(inner))
                    lock = self._resolve_lock(rec, item.context_expr)
                    if lock:
                        self._note_acquire(rec, lock, tuple(inner),
                                           item.context_expr)
                        inner.append(lock)
                self._scan_block(rec, stmt.body, tuple(inner))
                continue
            if isinstance(stmt, ast.Expr) \
                    and isinstance(stmt.value, ast.Call):
                call = stmt.value
                p = _attr_path(call.func)
                parts = p.split(".") if p else []
                if parts and parts[-1] == "acquire":
                    lock = self._resolve_lock_path(
                        rec, ".".join(parts[:-1]))
                    if lock:
                        self._note_acquire(rec, lock, tuple(cur), call)
                        self._note_blocking(rec, call, parts,
                                            tuple(cur))
                        self._scan_expr_children(rec, call, tuple(cur))
                        cur.append(lock)
                        continue
                elif parts and parts[-1] == "release":
                    lock = self._resolve_lock_path(
                        rec, ".".join(parts[:-1]))
                    if lock:
                        for i in range(len(cur) - 1, -1, -1):
                            if cur[i] == lock:
                                del cur[i]
                                break
                        continue
            if isinstance(stmt, (ast.For, ast.AsyncFor)):
                self._scan_expr(rec, stmt.iter, tuple(cur))
                self._scan_expr(rec, stmt.target, tuple(cur))
                self._scan_block(rec, stmt.body, tuple(cur))
                self._scan_block(rec, stmt.orelse, tuple(cur))
            elif isinstance(stmt, ast.While):
                self._scan_expr(rec, stmt.test, tuple(cur))
                self._scan_block(rec, stmt.body, tuple(cur))
                self._scan_block(rec, stmt.orelse, tuple(cur))
            elif isinstance(stmt, ast.If):
                self._scan_expr(rec, stmt.test, tuple(cur))
                self._scan_block(rec, stmt.body, tuple(cur))
                self._scan_block(rec, stmt.orelse, tuple(cur))
            elif isinstance(stmt, ast.Try):
                self._scan_block(rec, stmt.body, tuple(cur))
                for h in stmt.handlers:
                    self._scan_block(rec, h.body, tuple(cur))
                self._scan_block(rec, stmt.orelse, tuple(cur))
                self._scan_block(rec, stmt.finalbody, tuple(cur))
            else:
                self._scan_expr(rec, stmt, tuple(cur))

    def _scan_expr(self, rec: _FnRecord, node: Optional[ast.AST],
                   held: Tuple[str, ...]) -> None:
        if node is None or isinstance(
                node, (ast.Lambda, ast.FunctionDef,
                       ast.AsyncFunctionDef, ast.ClassDef)):
            return  # deferred bodies are their own records
        if isinstance(node, ast.Call):
            self._handle_call(rec, node, held)
        elif isinstance(node, ast.Attribute) \
                and isinstance(node.value, ast.Name) \
                and node.value.id == "self" and rec.cls:
            kind = self.kinds.get((rec.cls, node.attr))
            if kind is None:  # plain data attribute
                if isinstance(node.ctx, ast.Store):
                    rec.attr_writes.append((rec.cls, node.attr, held,
                                            node))
                elif isinstance(node.ctx, ast.Load):
                    rec.attr_reads.append((rec.cls, node.attr, held,
                                           node))
        self._scan_expr_children(rec, node, held)

    def _scan_expr_children(self, rec, node, held) -> None:
        for child in ast.iter_child_nodes(node):
            self._scan_expr(rec, child, held)

    # -- per-call handling -------------------------------------------------

    def _handle_call(self, rec: _FnRecord, call: ast.Call,
                     held: Tuple[str, ...]) -> None:
        p = _attr_path(call.func)
        if not p:
            return
        parts = p.split(".")
        tail = parts[-1]

        if tail == "Thread" and (len(parts) == 1
                                 or parts[-2] == "threading"):
            self._note_spawn(rec, call)
        elif tail in _THREAD_CONSUMERS and call.args:
            tgt = None
            for kw in call.keywords:
                if kw.arg in ("produce", "target"):
                    tgt = kw.value
            refs = self._fn_refs(rec, tgt or call.args[0])
            for ref in refs:
                self._consumer_targets.append(ref)

        if tail in ("replace", "rename") and len(parts) > 1 \
                and parts[-2] == "os":
            rec.has_replace = True

        if self._is_emit_call(parts, call):
            rec.direct_emit = True
            rec.emits.append((held, call, p))

        if tail in ("get", "put", "join", "wait", "acquire"):
            self._note_blocking(rec, call, parts, held)

        if tail == "open" or (len(parts) == 1 and tail == "open"):
            self._note_open(rec, call, parts)

        callees = self._resolve_callees(rec, p)
        if callees:
            rec.calls.append((callees, held, call))

    def _note_acquire(self, rec: _FnRecord, lock: str,
                      held: Tuple[str, ...], site: ast.AST) -> None:
        if lock in held and not self.locks.get(lock, False):
            self._emit(site, "FTH001",
                       f"non-reentrant lock {lock} acquired while "
                       f"already held on the same path (held: "
                       f"{', '.join(held)}) — this deadlocks at "
                       "runtime")
        rec.acquires.append((lock, held, site))

    @staticmethod
    def _call_bounded(call: ast.Call, tail: str) -> bool:
        for kw in call.keywords:
            if kw.arg == "timeout" and not _const_is(kw.value, None):
                return True
            if kw.arg in ("block", "blocking") \
                    and _const_is(kw.value, False):
                return True
        pos = call.args
        if tail in ("join", "wait"):
            return bool(pos)
        if tail == "get":
            return len(pos) >= 2 or (len(pos) >= 1
                                     and _const_is(pos[0], False))
        if tail == "put":
            return len(pos) >= 3 or (len(pos) >= 2
                                     and _const_is(pos[1], False))
        if tail == "acquire":
            return len(pos) >= 2 or (len(pos) >= 1
                                     and _const_is(pos[0], False))
        return False

    def _note_blocking(self, rec: _FnRecord, call: ast.Call,
                       parts: List[str],
                       held: Tuple[str, ...]) -> None:
        tail = parts[-1]
        recv = ".".join(parts[:-1])
        kind = self._recv_kind(rec, recv)
        if tail == "join":
            self._join_receivers.add(recv)
        ok = ((tail in ("get", "put") and kind == "queue")
              or (tail == "join" and kind in ("thread", "queue"))
              or (tail == "wait" and kind in ("event", "lock"))
              or (tail == "acquire" and kind == "lock"))
        if not ok or self._call_bounded(call, tail):
            return
        rec.blocking.append((kind or "", tail, held, call))

    def _note_spawn(self, rec: _FnRecord, call: ast.Call) -> None:
        has_name = any(kw.arg == "name" for kw in call.keywords)
        daemon = any(kw.arg == "daemon" and _const_is(kw.value, True)
                     for kw in call.keywords)
        targets = []
        for kw in call.keywords:
            if kw.arg == "target":
                tp = _attr_path(kw.value)
                if tp:
                    targets.append(tp)
        assigned = None
        parent = getattr(call, "_lint_parent", None)
        if isinstance(parent, ast.Assign) and len(parent.targets) == 1:
            assigned = _attr_path(parent.targets[0])
        self.spawns.append(_Spawn(call, rec.cls, has_name, daemon,
                                  targets, assigned))

    def _note_open(self, rec: _FnRecord, call: ast.Call,
                   parts: List[str]) -> None:
        mode = None
        if len(parts) == 1:                      # builtin open(path, mode)
            path_expr = call.args[0] if call.args else None
            if len(call.args) >= 2:
                mode = call.args[1]
        else:                                    # Path(...).open(mode)
            path_expr = call.func.value
            if call.args:
                mode = call.args[0]
        for kw in call.keywords:
            if kw.arg == "mode":
                mode = kw.value
        if not (isinstance(mode, ast.Constant)
                and isinstance(mode.value, str)
                and mode.value[:1] in ("w", "x")):
            return
        if path_expr is not None and self._mentions_tmp(path_expr):
            return
        rec.opens.append((call, mode.value, path_expr))

    @staticmethod
    def _mentions_tmp(expr: ast.AST) -> bool:
        for sub in ast.walk(expr):
            if isinstance(sub, ast.Constant) \
                    and isinstance(sub.value, str) \
                    and "tmp" in sub.value.lower():
                return True
            if isinstance(sub, ast.Name) and "tmp" in sub.id.lower():
                return True
            if isinstance(sub, ast.Attribute) \
                    and "tmp" in sub.attr.lower():
                return True
        return False

    # -- post-passes -------------------------------------------------------

    def run(self) -> List[Finding]:
        self.scan()
        acq_trans, emit_trans = self._fixpoints()
        self._rule_lock_graph(acq_trans, emit_trans)
        self._rule_thread_shared_state()
        self._rule_blocking(acq_trans)
        self._rule_thread_hygiene()
        self._rule_atomic_writes()
        by_line = suppressions_for_source(self.src)
        return apply_suppressions(
            sorted(self.findings,
                   key=lambda f: (f.line, f.col, f.rule)), by_line)

    def _fixpoints(self):
        """Transitive per-function acquired-lock sets and can-emit
        flags over the intra-module call graph."""
        acq: Dict[_FnRecord, Set[str]] = {
            rec: {a for a, _, _ in rec.acquires}
            for rec in self.records}
        emits: Dict[_FnRecord, bool] = {
            rec: rec.direct_emit for rec in self.records}
        changed = True
        while changed:
            changed = False
            for rec in self.records:
                for callees, _, _ in rec.calls:
                    for c in callees:
                        if c is rec:
                            continue
                        before = len(acq[rec])
                        acq[rec] |= acq.get(c, set())
                        if len(acq[rec]) != before:
                            changed = True
                        if emits.get(c) and not emits[rec]:
                            emits[rec] = True
                            changed = True
        return acq, emits

    def _rule_lock_graph(self, acq_trans, emit_trans) -> None:
        # edges[a][b] = first site acquiring b while holding a
        edges: Dict[str, Dict[str, ast.AST]] = {}

        def add_edge(a: str, b: str, site: ast.AST) -> None:
            if a != b:
                edges.setdefault(a, {}).setdefault(b, site)

        for rec in self.records:
            for lock, held, site in rec.acquires:
                for h in held:
                    add_edge(h, lock, site)
            for held, site, what in rec.emits:
                if held:
                    self._emit(site, "FTH002",
                               f"emit `{what}` while holding "
                               f"{', '.join(held)} — the emit can "
                               "re-enter the writer this lock guards "
                               "(the self-deadlock class)")
            for callees, held, site in rec.calls:
                if not held:
                    continue
                for c in callees:
                    for lock in acq_trans.get(c, ()):  # noqa: B007
                        if lock in held \
                                and not self.locks.get(lock, False):
                            self._emit(
                                site, "FTH001",
                                f"call into {c.qualname}() re-acquires "
                                f"{lock} already held here — "
                                "deadlocks at runtime")
                        else:
                            for h in held:
                                add_edge(h, lock, site)
                    if emit_trans.get(c):
                        self._emit(
                            site, "FTH002",
                            f"call into {c.qualname}() can reach a "
                            f"telemetry emit while holding "
                            f"{', '.join(held)} (the self-deadlock "
                            "class)")

        # cycle detection over the name graph: any lock pair mutually
        # reachable is an ordering cycle.
        def reaches(a: str, b: str) -> bool:
            seen, stack = set(), [a]
            while stack:
                n = stack.pop()
                if n == b:
                    return True
                if n in seen:
                    continue
                seen.add(n)
                stack.extend(edges.get(n, ()))
            return False

        reported: Set[frozenset] = set()
        for a in sorted(edges):
            for b in sorted(edges[a]):
                if frozenset((a, b)) in reported:
                    continue
                if reaches(b, a):
                    reported.add(frozenset((a, b)))
                    site = edges[a][b]
                    self._emit(
                        site, "FTH001",
                        f"lock-order cycle: {a} -> {b} here but "
                        f"{b} ..-> {a} on another path — threads "
                        "taking the two orders deadlock against "
                        "each other")

    def _thread_side(self) -> Set[_FnRecord]:
        side: Set[_FnRecord] = set(self._consumer_targets)
        for sp in self.spawns:
            for tp in sp.targets:
                # resolve against a record in the spawning class
                rec = _FnRecord(sp.site, sp.in_cls, "")
                side.update(self._resolve_callees(rec, tp))
        # transitive closure over the call graph
        changed = True
        while changed:
            changed = False
            for rec in list(side):
                for callees, _, _ in rec.calls:
                    for c in callees:
                        if c not in side:
                            side.add(c)
                            changed = True
        return side

    def _rule_thread_shared_state(self) -> None:
        side = self._thread_side()
        writes: Dict[Tuple[str, str], List] = {}
        reads: Dict[Tuple[str, str], List] = {}
        for rec in self.records:
            if rec in side:
                for cls, attr, held, site in rec.attr_writes:
                    writes.setdefault((cls, attr), []).append(
                        (held, site, rec))
            elif rec.name != "__init__":
                for cls, attr, held, site in rec.attr_reads:
                    reads.setdefault((cls, attr), []).append(
                        (held, site, rec))
        for key in sorted(set(writes) & set(reads),
                          key=lambda k: (k[0] or "", k[1])):
            cls, attr = key
            wlocks = [set(h) for h, _, _ in writes[key]]
            rlocks = [set(h) for h, _, _ in reads[key]]
            common = set.intersection(*(wlocks + rlocks))
            if common:
                continue
            _, rsite, rrec = min(reads[key],
                                 key=lambda t: t[1].lineno)
            wrec = writes[key][0][2]
            wheld = sorted(set.union(*wlocks)) if any(wlocks) else []
            self._emit(
                rsite, "FTH003",
                f"self.{attr} is written on the {wrec.qualname}() "
                f"thread"
                + (f" under {', '.join(wheld)}" if wheld else
                   " with no lock")
                + f" but read here in {rrec.qualname}() without a "
                "common lock")

    def _rule_blocking(self, acq_trans) -> None:
        daemon_side: Set[_FnRecord] = set()
        for sp in self.spawns:
            if not sp.daemon:
                continue
            for tp in sp.targets:
                rec = _FnRecord(sp.site, sp.in_cls, "")
                daemon_side.update(self._resolve_callees(rec, tp))
        changed = True
        while changed:
            changed = False
            for rec in list(daemon_side):
                for callees, _, _ in rec.calls:
                    for c in callees:
                        if c not in daemon_side:
                            daemon_side.add(c)
                            changed = True
        for rec in self.records:
            for kind, tail, held, site in rec.blocking:
                if held:
                    self._emit(
                        site, "FTH004",
                        f"unbounded {kind}.{tail}() while holding "
                        f"{', '.join(held)} — nothing can interrupt "
                        "the wait and the lock pins every peer")
                elif rec in daemon_side:
                    self._emit(
                        site, "FTH004",
                        f"unbounded {kind}.{tail}() inside daemon "
                        f"worker {rec.qualname}() — close() and the "
                        "stall watchdog cannot bound this wait")

    def _rule_thread_hygiene(self) -> None:
        for sp in self.spawns:
            if not sp.has_name:
                self._emit(
                    sp.site, "FTH005",
                    "thread spawned without an explicit stable name= "
                    "— watchdog stack dumps, span lanes, and "
                    "lock-sentinel reports key on thread names")
            if sp.daemon or (sp.assigned_path
                             and sp.assigned_path in self._daemon_set):
                joined = False
                if sp.assigned_path:
                    last = sp.assigned_path.split(".")[-1]
                    joined = any(
                        r == sp.assigned_path or r.endswith("." + last)
                        for r in self._join_receivers)
                if not joined:
                    self._emit(
                        sp.site, "FTH005",
                        "daemon thread with no close/join path — "
                        "in-flight work is lost at interpreter "
                        "teardown and leaks across tests")

    def _rule_atomic_writes(self) -> None:
        if not self.path.replace(os.sep, "/").startswith(
                PACKAGE_PREFIX):
            return  # scripts write scratch reports freely
        for rec in self.records:
            if rec.has_replace:
                continue  # write-tmp-then-replace function
            for site, mode, _ in rec.opens:
                self._emit(
                    site, "FTH006",
                    f"open(..., {mode!r}) without the write-tmp-then-"
                    "os.replace protocol — a crash mid-write leaves a "
                    "torn artifact that readers then parse")


def analyze_concurrency_source(src: str,
                               path: str = "<string>"
                               ) -> List[Finding]:
    """FTH findings for one module's source text (sorted by line)."""
    return ConcurrencyAnalysis(src, path).run()


def audit_concurrency_paths(root: str,
                            targets: Sequence[str] =
                            CONCURRENCY_TARGETS) -> List[Finding]:
    """FTH findings for every .py under ``targets`` (repo-relative)."""
    findings: List[Finding] = []
    for full in iter_py_files(root, targets):
        rel = os.path.relpath(full, root).replace(os.sep, "/")
        try:
            src = open(full, encoding="utf-8").read()
            findings.extend(analyze_concurrency_source(src, rel))
        except (SyntaxError, UnicodeDecodeError) as e:
            findings.append(Finding(
                path=rel, line=getattr(e, "lineno", 1) or 1, col=0,
                rule="FTH000", message=f"could not analyze: {e}",
                hint="", source_line=""))
    return findings


def split_hard_findings(findings: Sequence[Finding]
                        ) -> Tuple[List[Finding], List[Finding]]:
    """(hard, soft): FTH001 cycles are hard errors and never take
    part in the baseline diff — they cannot be pinned, only fixed."""
    hard = [f for f in findings if f.rule == "FTH001"]
    soft = [f for f in findings if f.rule != "FTH001"]
    return hard, soft


def concurrency_gate(root: str,
                     baseline_path: Optional[str] = None
                     ) -> Tuple[List[Finding], int]:
    """The CI shape: (blocking findings, total findings). Blocking =
    every FTH001 plus soft findings not in the baseline."""
    findings = audit_concurrency_paths(root)
    hard, soft = split_hard_findings(findings)
    bp = baseline_path or os.path.join(root, CONCURRENCY_BASELINE_REL)
    new, _ = diff_against_baseline(soft, load_baseline(bp))
    return hard + new, len(findings)
