"""AST analysis: host syncs and global-generator draws in the round's
hot functions (the port's counterpart of ``fedtorch_tpu/lint/
analyzer.py``).

One pass per module, stdlib ``ast`` only (no torch import, no
execution), heuristic in the same places the JAX analyser is:

* **Hot functions.** The JAX analyser's *traced* contexts become the
  functions the round runs: the entry points :data:`HOT_ENTRY_POINTS`
  (the trainer's ``run_round``/``run_rounds``/``_round_core``/
  ``_client_loops``/``_fused_client_round`` and the algorithms' hooks,
  ``local_step`` among them), functions nested in a hot function, and,
  to a fixpoint, every function of the same module a hot function calls
  by name (``self.f(...)`` or ``f(...)``). Cross-module reachability is
  not modelled; the runtime :class:`~fedtorch_tpu_torch.utils.tracing.
  SyncSentinel` covers that half.
* **Tensor-flavoured expressions.** An expression is a tensor when its
  subtree mentions a ``torch.*`` call (``F.*`` included), a local name
  assigned from one (one forward pass), or a parameter of the hot
  function, except ``self``/``cls`` and parameters that are host values
  by their annotation (``bool``/``int``/``float``/``str``, a
  ``*Config`` dataclass) or their constant default. ``.shape``/
  ``.dtype``/``.device``/``.ndim``/``.numel()``/``len()`` prune the
  subtree (host metadata), as do ``is``/``is not`` tests.

Rules (``rules.py``): FTL001 host syncs, FTL003 random ops without
``generator=``, FTL005 branches on a tensor. ``# lint: disable=FTL00x —
why`` suppresses with a justification; the checked-in baseline absorbs
accepted findings (``findings.py``).
"""
from __future__ import annotations

import ast
import os
from typing import Dict, List, Optional, Set

from fedtorch_tpu_torch.lint.findings import (
    Finding, apply_suppressions, suppressions_for_source,
)
from fedtorch_tpu_torch.lint.rules import hint_for

# the round's entry points: the trainer's and the algorithms' hooks
HOT_ENTRY_POINTS = frozenset({
    "run_round", "run_rounds", "_round_core", "_client_loops",
    "_fused_client_round", "local_step",
    "participation", "plan_draws", "pre_round", "forward_reset",
    "transform_grads", "client_weights", "client_payload",
    "payload_batch_transform", "aggregate_transform", "server_update",
    "client_post", "post_round_global", "post_round_global_feed",
})

# tensor methods that copy to the host and wait for the stream (FTL001)
_SYNC_METHODS = {"item", "tolist", "cpu", "numpy"}
_COERCIONS = {"float", "int", "bool"}
# host metadata: attribute reads and method calls that prune a subtree
_STATIC_ATTRS = {"shape", "dtype", "device", "ndim", "is_cuda",
                 "requires_grad", "layout"}
_STATIC_METHODS = {"numel", "dim", "size", "element_size", "nelement",
                   "get_device", "is_floating_point", "is_complex",
                   "data_ptr", "stride", "is_contiguous"}
_HOST_RESULT_NAMES = {"isinstance", "issubclass", "len", "getattr",
                      "hasattr", "type", "repr", "str", "callable", "id"}
_HOST_ANNOTATIONS = {"bool", "int", "float", "str"}
# torch.* calls whose result is a host value
_HOST_RESULT_CALLS = {"torch.is_tensor", "torch.is_floating_point",
                      "torch.get_default_dtype", "torch.finfo",
                      "torch.iinfo", "torch.device", "torch.dtype",
                      "torch.Size", "torch.cuda.is_available",
                      "torch.cuda.current_device",
                      "torch.cuda.get_device_name", "torch.promote_types",
                      "torch.result_type", "torch.can_cast"}
# random ops that take generator= (FTL003); F.dropout cannot take one
_RANDOM_CALLS = {"torch.rand", "torch.randn", "torch.randint",
                 "torch.randperm", "torch.bernoulli", "torch.multinomial",
                 "torch.normal", "torch.poisson", "torch.rand_like",
                 "torch.randn_like", "torch.randint_like",
                 "torch.nn.functional.dropout",
                 "torch.nn.functional.dropout2d",
                 "torch.nn.functional.alpha_dropout"}
_RANDOM_METHODS = {"uniform_", "normal_", "bernoulli_", "random_",
                   "exponential_", "geometric_", "cauchy_", "log_normal_"}


def _attr_path(node: ast.AST) -> Optional[str]:
    """Dotted path of a Name/Attribute chain, else None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _set_parents(tree: ast.AST) -> None:
    for parent in ast.walk(tree):
        for child in ast.iter_child_nodes(parent):
            child._lint_parent = parent  # type: ignore[attr-defined]


def _enclosing_function(node: ast.AST):
    cur = getattr(node, "_lint_parent", None)
    while cur is not None:
        if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef,
                            ast.Lambda)):
            return cur
        cur = getattr(cur, "_lint_parent", None)
    return None


def _index(tree: ast.AST):
    """One pass over the tree: parent links set, and the (functions,
    imports, calls) it holds."""
    functions, imports, calls = [], [], []
    stack = [tree]
    while stack:
        node = stack.pop()
        for child in ast.iter_child_nodes(node):
            child._lint_parent = node  # type: ignore[attr-defined]
            stack.append(child)
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            functions.append(node)
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            imports.append(node)
        elif isinstance(node, ast.Call):
            calls.append(node)
    return functions, imports, calls


class _Aliases:
    """What this module calls torch, torch.nn.functional and numpy."""

    def __init__(self, imports):
        self.prefix: Dict[str, str] = {}
        for node in imports:
            if isinstance(node, ast.Import):
                for a in node.names:
                    if a.name == "torch" or a.name.startswith("torch.") \
                            or a.name == "numpy":
                        if a.asname:
                            self.prefix[a.asname] = a.name
                        else:
                            head = a.name.split(".")[0]
                            self.prefix[head] = head
            elif isinstance(node, ast.ImportFrom):
                mod = node.module or ""
                if mod == "torch" or mod.startswith("torch.") \
                        or mod == "numpy":
                    for a in node.names:
                        self.prefix[a.asname or a.name] = f"{mod}.{a.name}"

    def canon(self, path: Optional[str]) -> Optional[str]:
        """'F.relu' -> 'torch.nn.functional.relu', 'np.asarray' ->
        'numpy.asarray'; a local path comes back unchanged."""
        if not path:
            return None
        head, _, rest = path.partition(".")
        if head in self.prefix:
            return self.prefix[head] + ("." + rest if rest else "")
        return path

    def is_library(self, path: str) -> bool:
        return self.canon(path) != path


def _host_param(arg: ast.arg, default: Optional[ast.AST]) -> bool:
    ann = arg.annotation
    if isinstance(ann, ast.Name) and (ann.id in _HOST_ANNOTATIONS
                                      or ann.id.endswith("Config")):
        return True
    if isinstance(ann, ast.Constant) and ann.value in _HOST_ANNOTATIONS:
        return True
    return isinstance(default, ast.Constant)


def _tensor_params(fn) -> Set[str]:
    """Parameters of ``fn`` treated as tensors: all but self/cls and the
    host-typed or constant-defaulted ones."""
    args = fn.args
    positional = args.posonlyargs + args.args
    defaults = [None] * (len(positional) - len(args.defaults)) \
        + list(args.defaults)
    pairs = list(zip(positional, defaults)) \
        + list(zip(args.kwonlyargs, args.kw_defaults))
    return {a.arg for a, d in pairs
            if a.arg not in ("self", "cls") and not _host_param(a, d)}


class ModuleAnalysis:
    """Single-module pass producing FTL001/FTL003/FTL005 findings."""

    def __init__(self, src: str, path: str,
                 entry_points=HOT_ENTRY_POINTS):
        self.src = src
        self.path = path
        self.lines = src.splitlines()
        self.tree = ast.parse(src, filename=path)
        functions, imports, self._calls = _index(self.tree)
        self.aliases = _Aliases(imports)
        self.findings: List[Finding] = []
        self.functions = sorted(functions, key=lambda f: (f.lineno,
                                                          f.col_offset))
        self._fn_by_name: Dict[str, List[ast.AST]] = {}
        for fn in self.functions:
            if not isinstance(fn, ast.Lambda):
                self._fn_by_name.setdefault(fn.name, []).append(fn)
        self.hot: Set[ast.AST] = set()
        self._mark_hot(entry_points)
        self._tensor_vars: Dict[ast.AST, Set[str]] = {
            fn: self._collect_tensor_vars(fn) for fn in self.hot}
        self._claimed_tests: Set[ast.AST] = set()

    # -- hot-function discovery ----------------------------------------

    def _mark_hot(self, entry_points) -> None:
        # the local names each function calls, its closures' calls
        # included (library calls excluded)
        callees: Dict[ast.AST, Set[str]] = {fn: set()
                                             for fn in self.functions}
        for call in self._calls:
            p = _attr_path(call.func)
            if p is None or self.aliases.is_library(p):
                continue
            fn = _enclosing_function(call)
            while fn is not None:
                callees[fn].add(p.rsplit(".", 1)[-1])
                fn = _enclosing_function(fn)
        todo = [fn for fn in self.functions
                if not isinstance(fn, ast.Lambda) and fn.name in entry_points]
        while todo:
            fn = todo.pop()
            if fn in self.hot:
                continue
            self.hot.add(fn)
            # closures defined inside a hot function are hot
            todo.extend(sub for sub in ast.walk(fn) if sub is not fn
                        and isinstance(sub, (ast.FunctionDef,
                                             ast.AsyncFunctionDef,
                                             ast.Lambda)))
            # the intra-module call graph: a hot caller makes its
            # callees hot
            for name in callees[fn]:
                todo.extend(self._fn_by_name.get(name, []))
        # the nodes the rules visit: the outermost hot functions' trees
        roots = [fn for fn in self.hot
                 if _enclosing_function(fn) not in self.hot]
        self._hot_nodes = [n for fn in sorted(roots, key=lambda f: (
            f.lineno, f.col_offset)) for n in ast.walk(fn)]

    def _hot_fn(self, node: ast.AST):
        """The innermost enclosing function when it is hot, else None."""
        fn = _enclosing_function(node)
        return fn if fn in self.hot else None

    # -- tensor-flavoured expressions ----------------------------------

    @staticmethod
    def _target_names(tgt: ast.AST) -> List[str]:
        if isinstance(tgt, ast.Name):
            return [tgt.id]
        if isinstance(tgt, (ast.Tuple, ast.List)):
            out = []
            for e in tgt.elts:
                out.extend(ModuleAnalysis._target_names(e))
            return out
        return []

    def _collect_tensor_vars(self, fn) -> Set[str]:
        """The hot function's tensor parameters, plus names assigned
        from tensor expressions (one forward pass); a closure sees its
        enclosing hot functions' names too."""
        out = _tensor_params(fn)
        anc = _enclosing_function(fn)
        while anc is not None:
            if anc in self.hot:
                out |= _tensor_params(anc)
            anc = _enclosing_function(anc)
        body = fn.body if isinstance(fn.body, list) else [fn.body]
        for stmt in body:
            for sub in ast.walk(stmt):
                if isinstance(sub, ast.Assign) and \
                        self._is_tensor(sub.value, out):
                    for tgt in sub.targets:
                        out.update(self._target_names(tgt))
                elif isinstance(sub, (ast.AugAssign, ast.AnnAssign)) \
                        and sub.value is not None \
                        and isinstance(sub.target, ast.Name) \
                        and self._is_tensor(sub.value, out):
                    out.add(sub.target.id)
        return out

    def _is_tensor(self, node: ast.AST, tensor_vars: Set[str]) -> bool:
        """Does this expression's value (heuristically) live in a
        tensor?"""
        if isinstance(node, ast.Attribute) and node.attr in _STATIC_ATTRS:
            return False
        if isinstance(node, ast.Compare) and \
                all(isinstance(op, (ast.Is, ast.IsNot)) for op in node.ops):
            return False
        if isinstance(node, ast.Call):
            func = node.func
            if isinstance(func, ast.Name) and \
                    func.id in _HOST_RESULT_NAMES | _COERCIONS:
                return False
            if isinstance(func, ast.Attribute) and \
                    func.attr in _STATIC_METHODS | _SYNC_METHODS:
                return False  # metadata, or already a host value
            canon = self.aliases.canon(_attr_path(func))
            if canon in _HOST_RESULT_CALLS:
                return False
            if canon and canon.startswith("torch."):
                return True
        if isinstance(node, ast.Name) and node.id in tensor_vars:
            return True
        for child in ast.iter_child_nodes(node):
            if self._is_tensor(child, tensor_vars):
                return True
        return False

    def _tensors_at(self, node: ast.AST) -> Set[str]:
        fn = self._hot_fn(node)
        return self._tensor_vars.get(fn, set()) if fn is not None \
            else set()

    # -- emit -----------------------------------------------------------

    def _emit(self, node: ast.AST, rule: str, message: str) -> None:
        line = getattr(node, "lineno", 1)
        col = getattr(node, "col_offset", 0)
        text = self.lines[line - 1] if 0 < line <= len(self.lines) \
            else ""
        self.findings.append(Finding(
            path=self.path, line=line, col=col, rule=rule,
            message=message, hint=hint_for(rule), source_line=text))

    # -- rules -----------------------------------------------------------

    def run(self) -> List[Finding]:
        self._rule_branching()      # claims If/While tests first
        self._rule_host_sync()
        self._rule_global_generator()
        by_line = suppressions_for_source(self.src)
        return apply_suppressions(
            sorted(self.findings, key=lambda f: (f.line, f.col, f.rule)),
            by_line)

    # FTL005: a branch on a tensor ---------------------------------------
    def _rule_branching(self) -> None:
        for node in self._hot_nodes:
            if not isinstance(node, (ast.If, ast.While, ast.Assert,
                                     ast.IfExp)):
                continue
            test = node.test
            tv = self._tensors_at(node)
            if self._is_tensor(test, tv) or any(
                    isinstance(sub, ast.Call) and self._is_host_sync(sub, tv)
                    for sub in ast.walk(test)):
                self._claimed_tests.add(test)
                self._emit(test, "FTL005",
                           "Python branch on a tensor value in the round's "
                           "hot path — an implicit host sync")

    def _under_claimed_test(self, node: ast.AST) -> bool:
        cur = node
        while cur is not None:
            if cur in self._claimed_tests:
                return True
            cur = getattr(cur, "_lint_parent", None)
        return False

    # FTL001: host syncs --------------------------------------------------
    def _is_host_sync(self, call: ast.Call, tensor_vars: Set[str]) -> bool:
        func = call.func
        if isinstance(func, ast.Name) and func.id in _COERCIONS \
                and len(call.args) == 1 and not call.keywords:
            return self._is_tensor(call.args[0], tensor_vars)
        if isinstance(func, ast.Attribute) and func.attr in _SYNC_METHODS \
                and not call.args:
            return self._is_tensor(func.value, tensor_vars)
        canon = self.aliases.canon(_attr_path(func))
        if canon == "torch.cuda.synchronize":
            return True
        if canon in ("numpy.asarray", "numpy.array") and call.args:
            return self._is_tensor(call.args[0], tensor_vars)
        return False

    def _rule_host_sync(self) -> None:
        for node in self._hot_nodes:
            if not isinstance(node, ast.Call):
                continue
            if self._under_claimed_test(node):
                continue  # FTL005 owns this site
            if self._is_host_sync(node, self._tensors_at(node)):
                self._emit(node, "FTL001",
                           "host sync on a tensor in the round's hot path — "
                           "the host waits for the stream to drain")

    # FTL003: the global generator ----------------------------------------
    def _rule_global_generator(self) -> None:
        for node in self._hot_nodes:
            if not isinstance(node, ast.Call):
                continue
            if any(kw.arg == "generator" for kw in node.keywords):
                continue
            canon = self.aliases.canon(_attr_path(node.func))
            method = isinstance(node.func, ast.Attribute) and \
                node.func.attr in _RANDOM_METHODS
            if canon in _RANDOM_CALLS or method:
                what = canon if canon in _RANDOM_CALLS \
                    else f".{node.func.attr}()"
                self._emit(node, "FTL003",
                           f"{what} without generator= in the round's hot "
                           "path draws from torch's global generator")


def analyze_source(src: str, path: str = "<string>",
                   entry_points=HOT_ENTRY_POINTS) -> List[Finding]:
    """Findings for one module's source text (sorted by line)."""
    return ModuleAnalysis(src, path, entry_points).run()


def iter_py_files(root: str, targets) -> List[str]:
    out = []
    for t in targets:
        full = os.path.join(root, t)
        if os.path.isfile(full) and full.endswith(".py"):
            out.append(full)
        elif os.path.isdir(full):
            for dirpath, dirnames, filenames in os.walk(full):
                dirnames[:] = [d for d in dirnames
                               if d not in ("__pycache__", ".git",
                                            "_build")]
                for f in sorted(filenames):
                    if f.endswith(".py"):
                        out.append(os.path.join(dirpath, f))
    return sorted(set(out))


def analyze_paths(root: str, targets) -> List[Finding]:
    """Findings for every .py under ``targets`` (repo-relative)."""
    findings: List[Finding] = []
    for full in iter_py_files(root, targets):
        rel = os.path.relpath(full, root).replace(os.sep, "/")
        try:
            src = open(full, encoding="utf-8").read()
            findings.extend(analyze_source(src, rel))
        except (SyntaxError, UnicodeDecodeError) as e:
            findings.append(Finding(
                path=rel, line=getattr(e, "lineno", 1) or 1, col=0,
                rule="FTL000", message=f"could not analyze: {e}",
                hint="", source_line=""))
    return findings
