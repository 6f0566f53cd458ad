"""Profiler-trace attribution (port of ``fedtorch_tpu/tools/
trace_attrib.py``): bucket a captured trace's device time into the JAX
package's categories, so its vocabulary (``fedtorch-tpu report
--device``) holds for the port's runs.

``utils.tracing.capture_round_trace`` writes a Chrome trace
(``<host>.<pid>.trace.json``) into its capture directory. This tool
attributes every device record of it: CUDA kernels, memcpys and memsets
(``cat`` ``kernel``/``gpu_memcpy``/``gpu_memset``, one lane per stream)
on a card, the CPU ops on a CPU capture (which has no device records),
and the XLA op events a JAX capture holds (the JAX rules and selection
unchanged). Nested events are self-time split, and the gap on the
device lanes becomes ``idle_gap``.

Categories (the JAX package's): ``collective``, ``infeed_outfeed_h2d``,
``matmul_conv_mxu``, ``reduce``, ``copy_reshape_transpose``,
``elementwise``, ``control_flow``, ``idle_gap``, ``other``. Torch and
CUDA names are matched on their base name (``void``, templates and
arguments cut) by :data:`TORCH_RULES`, first hit wins, and then by the
JAX rules: cuDNN, cuBLAS, CUTLASS, ``xmma``/``gemm`` and the hand
``flash_fwd_*`` kernels are ``matmul_conv_mxu``; ``nccl*`` is
``collective``; ``Memcpy HtoD``/``DtoH`` are ``infeed_outfeed_h2d``;
norms and reductions are ``reduce`` (XLA lowers a norm to reductions
and fusions); the hand quantizer is ``elementwise`` (as XLA counts it).

Beside the categories, one row per hand kernel (:data:`HAND_KERNELS`:
``qdq_ragged_*``, ``qdq_tiled_*``, ``flash_fwd_*``, the flash
pre-pass) with its ms and launches, the norm kernels' total, and from
them :func:`columns`, the E/M/N/F/Q split of PERF.md's "Where the time
goes" (E elementwise/reduce/copy, M conv/matmul, N norm, F flash, Q
quantizer).

**Invariant**: ``attributed_frac`` (everything except ``other``) must
cover >= 95% of device time.

    python -m fedtorch_tpu_torch.tools.trace_attrib <capture_dir> \\
        [--out attrib.json] [--render attrib.txt]

:func:`attribute_sums` is the in-memory entry: it attributes a CUDA
``utils.tracing.ProfileWindow`` from its per-name sums of the raw kineto
records and reads no file (kernels on a stream do not nest, so the sums
give the categories; there is no ``idle_gap``). A CPU capture's ops nest
and need the self-time split: it is attributed from its trace file.
Stdlib only (json + gzip) apart from that entry's caller.
"""
from __future__ import annotations

import argparse
import glob
import gzip
import json
import os
import re
import sys
from typing import Dict, List, Optional, Tuple

TRACE_ATTRIB_SCHEMA = "fedtorch_tpu.trace_attrib/v1"

ATTRIBUTED_MIN_FRAC = 0.95

# the JAX package's rules, matched against XLA op names
CATEGORY_RULES: List[Tuple[str, "re.Pattern"]] = [
    ("collective", re.compile(
        r"all-reduce|all-gather|reduce-scatter|all-to-all|"
        r"collective|cross-replica", re.I)),
    ("infeed_outfeed_h2d", re.compile(
        r"infeed|outfeed|copy-start|copy-done|\bsend\b|\brecv\b|"
        r"transfer", re.I)),
    ("matmul_conv_mxu", re.compile(
        r"conv(?!ert)|\bdot\b|dot[._\-]|gemm|matmul|einsum", re.I)),
    ("reduce", re.compile(
        r"reduce|arg-?max|arg-?min|\bsort\b|sort[._\-]|cumsum|"
        r"cumulative|select-and-scatter|top-?k", re.I)),
    ("copy_reshape_transpose", re.compile(
        r"copy|reshape|transpose|bitcast|slice|gather|scatter|\bpad\b|"
        r"pad[._\-]|concat|reverse|broadcast|tuple", re.I)),
    ("elementwise", re.compile(
        r"fusion|add|sub|mul|div|max|min|tanh|exp\b|exp[._\-]|"
        r"exponential|expm1|log|pow|sqrt|rsqrt|sigmoid|logistic|"
        r"select|compare|convert|clamp|\band\b|\bor\b|\bxor\b|"
        r"\bnot\b|neg|abs|sign|shift|floor|ceil|round|rem\b|"
        r"remainder|sin|cos|atan|erf|rng|threefry|iota|constant|"
        r"is-finite|relu|softmax|map\b|map[._\-]", re.I)),
    # the while/conditional shells around lax.scan bodies: their SELF
    # time (loop-condition eval, iteration buffer shuffling) is real
    # device time a scan-shaped round program pays every local step —
    # a named line item, not "other". custom-call stays unknown.
    ("control_flow", re.compile(
        r"\bwhile\b|conditional|(?<!custom-)\bcall\b|\bcase\b", re.I)),
]

CATEGORIES = tuple(c for c, _ in CATEGORY_RULES) + ("idle_gap", "other")




# ordered (category, pattern) rules for torch and CUDA names, matched
# case-insensitively against the base name; first hit wins
_NORM = (r"batch_?norm|layer_?norm|group_?norm|welford|gammabeta|"
         r"\bbn_|cudnn::bn|::bn_")
TORCH_RULES: List[Tuple[str, "re.Pattern"]] = [
    # the hand kernels: the quantizer and the flash pre-pass as XLA
    # counts them (elementwise work), the flash forward a matmul
    ("elementwise", re.compile(r"qdq_|tiled_stats|tiled_apply|"
                               r"v_last_nonfinite", re.I)),
    ("matmul_conv_mxu", re.compile(r"flash_fwd", re.I)),
    # the autograd engine's shells around each backward function (their
    # self time; the ops inside are their own events)
    ("control_flow", re.compile(r"autograd::engine|evaluate_function",
                                re.I)),
    ("collective", re.compile(
        r"nccl|all_?reduce|all_?gather|reduce_?scatter|all_?to_?all|"
        r"c10d::|broadcast_coalesced", re.I)),
    ("infeed_outfeed_h2d", re.compile(
        r"memcpy (htod|dtoh|htoh|ptod|dtop|ptop)|"
        r"aten::(item|_local_scalar_dense)$", re.I)),
    ("reduce", re.compile(_NORM, re.I)),
    ("copy_reshape_transpose", re.compile(
        r"nchwtonhwc|nhwctonchw|tensortransform|transform|transpose",
        re.I)),
    ("matmul_conv_mxu", re.compile(
        r"gemm|gemv|xmma|wgmma|cutlass|cublas|nvjet|conv(?!ert)|wgrad|"
        r"dgrad|fprop|sdpa|fmha|winograd|cudnn|aten::(mm|bmm|addmm|"
        r"matmul|linear|einsum|baddbmm|addmv|mv|dot)$|"
        r"scaled_dot_product|sm\d\d_|ampere_|hopper_|volta_", re.I)),
    ("reduce", re.compile(
        r"reduce|sum|mean|amax|amin|arg-?max|arg-?min|topk|top-?k|sort|"
        r"cumsum|cumprod|scan|softmax|logsumexp|pool|\bvar|\bstd|"
        r"histc|bincount|unique|nonzero|\bprod|radix|bitonic|"
        r"(?<![a-z])(max|min)(?![a-z])|aten::(all|any|norm)", re.I)),
    ("copy_reshape_transpose", re.compile(
        r"memcpy|memset|copy|cat|concat|gather|scatter|index|slice|"
        r"select|pad|flip|roll|reshape|view|expand|as_strided|empty|"
        r"zeros|ones|stack|split|chunk|narrow|unsqueeze|squeeze|"
        r"contiguous|clone|alias|detach|unfold|im2col|col2im|repeat|"
        r"resize|set_|lift|permute|flatten|unbind|movedim|take|put|"
        r"full|arange|scalar_tensor|linspace|"
        r"aten::(t|to|_to_copy|numpy_t|resolve_conj|resolve_neg)$",
        re.I)),
    ("elementwise", re.compile(
        r"elementwise|pointwise|vectoriz|unrolled|fill|add|sub|mul|div|"
        r"tanh|exp|log|pow|sqrt|sigmoid|relu|gelu|silu|clamp|where|neg|"
        r"abs|sign|floor|ceil|round|remainder|fmod|sin|cos|erf|dropout|"
        r"bernoulli|uniform|normal|random|rand|distribution|philox|"
        r"cast|convert|\beq|\bne|\blt|\bgt|\ble|\bge|logical|bitwise|"
        r"isnan|isinf|isfinite|nan_to_num|lerp|addc|zero_|hardtanh|"
        r"threshold|elu|softplus|reciprocal|square|foreach|"
        r"multi_tensor|amp_|triton_|lambda|trunc|__(and|or|xor|not)__",
        re.I)),
]

# one row per hand kernel of the port: (row, base-name pattern)
HAND_KERNELS: List[Tuple[str, "re.Pattern"]] = [
    ("qdq_ragged_stats", re.compile(r"qdq_ragged_stats")),
    ("qdq_ragged_apply", re.compile(r"qdq_ragged_apply")),
    ("qdq_tiled_stats", re.compile(r"(?<![a-z])tiled_stats")),
    ("qdq_tiled_apply", re.compile(r"(?<![a-z])tiled_apply")),
    ("flash_fwd_tc", re.compile(r"flash_fwd_tc")),
    ("flash_fwd_tf32", re.compile(r"flash_fwd_tf32")),
    ("flash_prepass", re.compile(r"v_last_nonfinite")),
]
_NORM_RE = re.compile(_NORM, re.I)


def base_name(name: str) -> str:
    """A torch or CUDA record's name without ``void``, anonymous
    namespaces, template arguments and parameters."""
    n = name[5:] if name.startswith("void ") else name
    n = n.replace("(anonymous namespace)::", "")
    cuts = [i for i in (n.find("<"), n.find("(")) if i > 0]
    return (n[:min(cuts)] if cuts else n).strip()


def categorize(name: str, torch_names: bool = False) -> str:
    """The category of an XLA op name (the JAX package's rules) or, with
    ``torch_names``, of a torch or CUDA record (:data:`TORCH_RULES`
    first, on its base name, then the JAX rules)."""
    if torch_names:
        base = base_name(name)
        for cat, pat in TORCH_RULES:
            if pat.search(base):
                return cat
        name = base
    for cat, pat in CATEGORY_RULES:
        if pat.search(name):
            return cat
    return "other"


def hand_kernel(name: str) -> Optional[str]:
    base = base_name(name)
    for row, pat in HAND_KERNELS:
        if pat.search(base):
            return row
    return None


# -- trace discovery and parsing ----------------------------------------


def find_trace_files(path: str) -> List[str]:
    """Every trace file under ``path`` at any depth (``*.trace.json``
    as :func:`~fedtorch_tpu_torch.utils.tracing.capture_round_trace`
    writes them, the JAX profiler's ``*.trace.json.gz``), or ``path``
    itself when it names a trace file."""
    if os.path.isfile(path):
        return [path]
    found: List[str] = []
    for pat in ("**/*.trace.json.gz", "**/*.trace.json",
                "**/trace.json.gz"):
        found.extend(glob.glob(os.path.join(glob.escape(path), pat),
                               recursive=True))
    return sorted(set(found))


def load_trace_events(path: str) -> List[Dict]:
    """The ``traceEvents`` list of one (possibly gzipped) Chrome trace.
    Raises ``ValueError`` with the offending path on malformed input —
    a truncated capture must say so, not attribute garbage."""
    opener = gzip.open if path.endswith(".gz") else open
    try:
        with opener(path, "rb") as f:
            doc = json.loads(f.read().decode("utf-8", errors="replace"))
    except (OSError, json.JSONDecodeError, EOFError) as e:
        raise ValueError(f"{path}: not a readable Chrome trace "
                         f"({type(e).__name__}: {e})") from e
    evs = doc.get("traceEvents") if isinstance(doc, dict) else None
    if not isinstance(evs, list):
        raise ValueError(f"{path}: no traceEvents list — not a Chrome "
                         "trace export")
    return evs




# the empty kernels a CUDA capture pads its window's edges with
# (``utils/tracing.py`` ``PAD_KERNEL``): not the captured work
_PAD_KERNEL = "spin_kernel"

# the device-side record kinds of a torch Chrome trace (the older
# exporters' spellings included)
_TORCH_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset", "memcpy",
                      "memset")


def _select_device_events(events: List[Dict]) -> List[Dict]:
    """The device op events: the torch trace's kernel, memcpy and memset
    records (a CPU capture, which has none, gives its CPU ops), or the
    JAX selection: complete (``ph='X'``) events that carry XLA's
    ``hlo_op``/``hlo_module`` args, or sit on an 'XLA Ops' lane of a
    ``/device:*`` process. Torch records are marked ``_torch``."""
    procs: Dict = {}
    threads: Dict = {}
    for e in events:
        if e.get("ph") == "M":
            if e.get("name") == "process_name":
                procs[e.get("pid")] = str(
                    (e.get("args") or {}).get("name", ""))
            elif e.get("name") == "thread_name":
                threads[(e.get("pid"), e.get("tid"))] = str(
                    (e.get("args") or {}).get("name", ""))
    complete = [e for e in events if e.get("ph") == "X" and "ts" in e]
    torch_dev = [e for e in complete
                 if str(e.get("cat", "")).lower() in _TORCH_DEVICE_CATS
                 and _PAD_KERNEL not in str(e.get("name", ""))]
    if not torch_dev:
        torch_dev = [e for e in complete
                     if str(e.get("cat", "")).lower() == "cpu_op"]
    out = [dict(e, _torch=True) for e in torch_dev]
    for e in complete:
        args = e.get("args") or {}
        if "hlo_op" in args or "hlo_module" in args:
            out.append(e)
            continue
        proc = procs.get(e.get("pid"), "")
        lane = threads.get((e.get("pid"), e.get("tid")), "")
        if "/device:" in proc and "XLA Ops" in lane:
            out.append(e)
    return out


def _merge_intervals(intervals: List[Tuple[float, float]]
                     ) -> List[Tuple[float, float]]:
    """Union of [start, end) intervals as a sorted disjoint list."""
    merged: List[List[float]] = []
    for start, end in sorted(intervals):
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    return [(s, e) for s, e in merged]

# the idle window keeps >= this share of device busy time: the
# profiler occasionally flushes a stray event from a pre-window
# execution into the buffer, and a microsecond op seconds away from
# the real cluster must not read as seconds of device idle
_IDLE_TRIM_FRAC = 0.005


def _busy_span_idle(intervals: List[Tuple[float, float]]
                    ) -> Tuple[float, float, float]:
    """(busy, span, idle) microseconds. ``busy`` is the union of all
    op intervals; ``span``/``idle`` are measured over the trimmed
    window holding >= 99% of the busy mass (up to 0.5% dropped per
    side), so stray out-of-window events don't inflate the gap."""
    merged = _merge_intervals(intervals)
    if not merged:
        return 0.0, 0.0, 0.0
    busy = sum(e - s for s, e in merged)
    lo, hi = 0, len(merged) - 1
    lead = trail = 0.0
    while lo < hi and lead + (merged[lo][1] - merged[lo][0]) \
            <= _IDLE_TRIM_FRAC * busy:
        lead += merged[lo][1] - merged[lo][0]
        lo += 1
    while hi > lo and trail + (merged[hi][1] - merged[hi][0]) \
            <= _IDLE_TRIM_FRAC * busy:
        trail += merged[hi][1] - merged[hi][0]
        hi -= 1
    span = merged[hi][1] - merged[lo][0]
    in_window = busy - lead - trail
    return busy, span, max(span - in_window, 0.0)


def _self_times(records: List[Tuple[float, float, str]]
                ) -> List[Tuple[str, float]]:
    """(name, self-duration) per ``(ts, dur, name)`` record of one lane:
    a nested child's duration is subtracted from its enclosing parent,
    so module- or region-level wrappers don't double-count the ops they
    contain (the JAX package's order and arithmetic)."""
    recs = sorted(records, key=lambda r: (r[0], -r[1]))
    names: List[str] = []
    durs: List[float] = []
    child: List[float] = []
    ends: List[float] = []
    stack: List[int] = []   # indices, innermost last
    for ts, dur, name in recs:
        while stack and ts >= ends[stack[-1]] - 1e-9:
            stack.pop()
        if stack:
            child[stack[-1]] += dur
        stack.append(len(names))
        names.append(name)
        durs.append(dur)
        child.append(0.0)
        ends.append(ts + dur)
    return [(n, max(d - c, 0.0)) for n, d, c in zip(names, durs, child)]


# -- attribution --------------------------------------------------------


class _Tally:
    """Self time and event counts by category, op, hand kernel and norm."""

    def __init__(self):
        self.cat_us: Dict[str, float] = {}
        self.cat_events: Dict[str, int] = {}
        self.op_us: Dict[str, float] = {}
        self.op_cat: Dict[str, str] = {}
        self.op_events: Dict[str, int] = {}
        self.hand: Dict[str, List[float]] = {}
        self.norm = [0.0, 0]

    def add(self, name: str, self_us: float, n: int, torch_name: bool):
        if torch_name:
            base = base_name(name)
            cat, op = categorize(name, torch_names=True), base or name
            row = hand_kernel(name)
            if _NORM_RE.search(base):
                self.norm[0] += self_us
                self.norm[1] += n
            if row is not None:
                acc = self.hand.setdefault(row, [0.0, 0])
                acc[0] += self_us
                acc[1] += n
        else:
            # op key without the SSA suffix, so conv.1/conv.2 pool
            cat, op = categorize(name), re.sub(r"[.\d]+$", "", name) or name
        self.cat_us[cat] = self.cat_us.get(cat, 0.0) + self_us
        self.cat_events[cat] = self.cat_events.get(cat, 0) + n
        self.op_us[op] = self.op_us.get(op, 0.0) + self_us
        self.op_events[op] = self.op_events.get(op, 0) + n
        self.op_cat.setdefault(op, cat)

    def part(self, span: float, busy: float, idle: Optional[float],
             lanes: int, events: int) -> Dict:
        return {"cat_us": self.cat_us, "cat_events": self.cat_events,
                "op_us": self.op_us, "op_cat": self.op_cat,
                "op_events": self.op_events, "span_us": span,
                "busy_us": busy, "idle_us": idle, "hand": self.hand,
                "norm": self.norm, "lanes": lanes, "events": events}


def _attribute_lanes(lanes: Dict[Tuple, List[Tuple[float, float, str]]],
                     torch_lanes) -> Dict:
    """Attribute ``(ts, dur, name)`` records by lane; the records of
    ``torch_lanes`` are named by the torch rules and summed a name at a
    time, the others (XLA ops) an event at a time, as the JAX package
    sums them."""
    tally = _Tally()
    intervals: List[Tuple[float, float]] = []
    events = 0
    for lane, recs in lanes.items():
        events += len(recs)
        intervals.extend((ts, ts + dur) for ts, dur, _ in recs)
        if lane in torch_lanes:
            per_name: Dict[str, List[float]] = {}
            for name, self_us in _self_times(recs):
                acc = per_name.get(name)
                if acc is None:
                    per_name[name] = [self_us, 1]
                else:
                    acc[0] += self_us
                    acc[1] += 1
            for name, (us, n) in per_name.items():
                tally.add(name, us, n, True)
        else:
            for name, self_us in _self_times(recs):
                tally.add(name, self_us, 1, False)
    busy, span, idle = _busy_span_idle(intervals)
    return tally.part(span, busy, idle, len(lanes), events)


def attribute_events(events: List[Dict]) -> Dict:
    """Attribute a flat device-event list (one trace's worth); events
    marked ``_torch`` are named by the torch rules."""
    lanes: Dict[Tuple, List[Tuple[float, float, str]]] = {}
    torch_lanes = set()
    for e in events:
        lane = (e.get("pid"), e.get("tid"))
        if lane not in lanes:
            lanes[lane] = []
            if e.get("_torch"):
                torch_lanes.add(lane)
        lanes[lane].append((float(e["ts"]), float(e.get("dur") or 0.0),
                            str(e.get("name", "?"))))
    return _attribute_lanes(lanes, torch_lanes)


def _assemble(doc: Dict, parts: List[Dict]) -> Dict:
    """Sum per-trace attributions into ``doc`` and check the invariant."""
    doc.update(device_lanes=sum(p["lanes"] for p in parts),
               device_events=sum(p["events"] for p in parts))
    if not parts:
        doc.update(total_us=0.0, categories={}, top_ops=[],
                   attributed_frac=None, attributed_ok=False,
                   hand_kernels={},
                   note=("no device op events found (no trace files, "
                         "or none with device records) — nothing to "
                         "attribute"))
        return doc

    cat_us: Dict[str, float] = {}
    cat_events: Dict[str, int] = {}
    op_us: Dict[str, float] = {}
    op_cat: Dict[str, str] = {}
    op_events: Dict[str, int] = {}
    hand: Dict[str, List[float]] = {}
    norm = [0.0, 0]
    idle = busy = span = 0.0
    for p in parts:
        for c, v in p["cat_us"].items():
            cat_us[c] = cat_us.get(c, 0.0) + v
        for c, v in p["cat_events"].items():
            cat_events[c] = cat_events.get(c, 0) + v
        for o, v in p["op_us"].items():
            op_us[o] = op_us.get(o, 0.0) + v
            op_events[o] = op_events.get(o, 0) + p["op_events"][o]
            op_cat.setdefault(o, p["op_cat"][o])
        for r, (us, n) in p["hand"].items():
            acc = hand.setdefault(r, [0.0, 0])
            acc[0] += us
            acc[1] += n
        norm[0] += p["norm"][0]
        norm[1] += p["norm"][1]
        idle = None if idle is None or p["idle_us"] is None \
            else idle + p["idle_us"]
        busy += p["busy_us"]
        span += p["span_us"]
    if idle is not None:
        cat_us["idle_gap"] = idle
        cat_events.setdefault("idle_gap", 0)

    total = sum(cat_us.values())
    categories = {
        c: {"time_us": round(cat_us.get(c, 0.0), 3),
            "frac": round(cat_us.get(c, 0.0) / total, 6) if total else 0.0,
            "events": cat_events.get(c, 0)}
        for c in CATEGORIES
        if c in cat_us or (c == "idle_gap" and idle is not None)}
    attributed = 1.0 - (cat_us.get("other", 0.0) / total) if total \
        else None
    top = sorted(op_us.items(), key=lambda kv: -kv[1])[:15]
    doc.update(
        span_us=round(span, 3), busy_us=round(busy, 3),
        total_us=round(total, 3),
        categories=categories,
        attributed_frac=round(attributed, 6)
        if attributed is not None else None,
        attributed_ok=bool(attributed is not None
                           and attributed >= ATTRIBUTED_MIN_FRAC),
        top_ops=[{"name": o, "category": op_cat[o],
                  "time_us": round(us, 3), "events": op_events[o]}
                 for o, us in top],
        hand_kernels={r: {"ms": us / 1e3, "launches": n}
                      for r, (us, n) in sorted(hand.items())},
        norm_kernels={"ms": norm[0] / 1e3, "launches": norm[1]},
        other_ops=[{"name": o, "time_us": round(us, 3)}
                   for o, us in sorted(op_us.items(), key=lambda kv: -kv[1])
                   if op_cat[o] == "other"][:10],
    )
    return doc


def attribute(path: str) -> Dict:
    """The full attribution document for a capture dir (or a single
    trace file): every trace file's device events bucketed, summed,
    and checked against the >= 95%-attributed invariant."""
    files = find_trace_files(path)
    parts = []
    for f in files:
        evs = _select_device_events(load_trace_events(f))
        if evs:
            parts.append(attribute_events(evs))
    return _assemble({"schema": TRACE_ATTRIB_SCHEMA, "source": path,
                      "trace_files": files}, parts)


def event_sums(path: str) -> Dict[str, Tuple[float, int]]:
    """``{name: (ms, records)}`` of a capture's device records, each
    duration summed as read (no self-time split): the file's form of a
    ``utils.tracing.ProfileWindow``'s per-name sums."""
    sums: Dict[str, Tuple[float, int]] = {}
    for f in find_trace_files(path):
        for e in _select_device_events(load_trace_events(f)):
            name = str(e.get("name", "?"))
            ms, n = sums.get(name, (0.0, 0))
            sums[name] = (ms + float(e.get("dur") or 0.0) / 1e3, n + 1)
    return sums


def attribute_sums(window) -> Dict:
    """The attribution document of a ``utils.tracing.ProfileWindow`` from
    its per-name sums alone (``ProfileWindow.sums``: three reads a
    record, no record kept), for rounds of several hundred thousand
    launches: the categories, hand-kernel rows and norm total of the
    device records, with no ``idle_gap`` (no timeline is kept), so the
    invariant holds over device time alone; ``busy_us`` is the summed
    durations: overlap is counted twice, across streams and on one
    (a kernel whose record starts before the one ahead of it ends:
    0.05-1.35% of a
    ResNet-20 round's device ms in ``chip_smoke.py``'s profile on an
    NVIDIA H100 80GB HBM3 at 700 W), which the file entry's self-time
    split takes out."""
    tally = _Tally()
    busy, events = 0.0, 0
    for (dev, name), (ms, n) in window.sums().items():
        if dev:
            tally.add(name, ms * 1e3, n, True)
            busy += ms * 1e3
            events += n
    parts = [tally.part(busy, busy, None, 1, events)] if events else []
    return _assemble({"schema": TRACE_ATTRIB_SCHEMA,
                      "source": "<in memory, per-name sums>",
                      "trace_files": []}, parts)


def device_ms(doc: Dict) -> float:
    """Device busy ms of an attribution document (every category but
    ``idle_gap``)."""
    return sum(c["time_us"] for k, c in doc.get("categories", {}).items()
               if k != "idle_gap") / 1e3


def summary(doc: Dict, wall_ms: float, window=None) -> Dict:
    """A profiled round in a few numbers: device ms and busy share of
    ``wall_ms``, device records, :func:`columns`, the hand-kernel rows,
    the attributed share, the top ops and, given the ``window``, its top
    host calls."""
    busy = device_ms(doc)
    runtime = sorted(((ms, name, n) for (dev, name), (ms, n)
                      in window.sums().items() if not dev and ms > 0),
                     reverse=True) if window is not None else []
    return dict(
        round_wall_ms=wall_ms, device_ms=busy or None,
        busy_share=busy / wall_ms if busy else None,
        kernel_launches=doc["device_events"],
        device_ms_by_column=columns(doc) if busy else None,
        hand_kernels=doc.get("hand_kernels", {}),
        attribution=dict(
            attributed_frac=doc["attributed_frac"],
            attributed_ok=doc["attributed_ok"],
            categories={k: c["frac"] for k, c in doc["categories"].items()},
            other_ops=doc.get("other_ops", [])[:5]),
        top_kernels=[dict(name=o["name"][:120], ms=o["time_us"] / 1e3,
                          calls=o["events"], category=o["category"])
                     for o in doc["top_ops"][:8]],
        top_runtime_calls=[dict(name=n[:80], self_ms=ms, calls=c)
                           for ms, n, c in runtime[:8]])


def columns(doc: Dict) -> Dict[str, float]:
    """PERF.md's split of device ms: F the flash forward, Q the
    quantizer, N the norm kernels, M the rest of ``matmul_conv_mxu``, E
    everything else busy (elementwise, reduce, copies, transfers,
    collectives, the flash pre-pass)."""
    ms = lambda c: doc["categories"].get(c, {}).get("time_us", 0.0) / 1e3
    hand = doc.get("hand_kernels", {})
    row = lambda *rs: sum(hand.get(r, {}).get("ms", 0.0) for r in rs)
    busy = sum(ms(c) for c in CATEGORIES if c != "idle_gap")
    f = row("flash_fwd_tc", "flash_fwd_tf32")
    q = row("qdq_ragged_stats", "qdq_ragged_apply", "qdq_tiled_stats",
            "qdq_tiled_apply")
    n = doc.get("norm_kernels", {}).get("ms", 0.0)
    m = ms("matmul_conv_mxu") - f
    return {"E": busy - m - n - f - q, "M": m, "N": n, "F": f, "Q": q}


# -- rendering ----------------------------------------------------------


def _fmt_us(us: float) -> str:
    if us >= 1e6:
        return f"{us / 1e6:.3f} s"
    if us >= 1e3:
        return f"{us / 1e3:.2f} ms"
    return f"{us:.1f} us"


def render(doc: Dict) -> str:
    lines = [f"device-time attribution: {doc['source']}"]
    if not doc.get("categories"):
        lines.append(f"  {doc.get('note', 'nothing to attribute')}")
        return "\n".join(lines)
    lines.append(
        f"  {doc['device_events']} device op events on "
        f"{doc['device_lanes']} lane(s); span {_fmt_us(doc['span_us'])}"
        f", busy {_fmt_us(doc['busy_us'])}")
    lines.append("  category                  time          share  events")
    for cat in CATEGORIES:
        rec = doc["categories"].get(cat)
        if rec is None:
            continue
        lines.append(f"  {cat:<24} {_fmt_us(rec['time_us']):>12}  "
                     f"{rec['frac'] * 100:5.1f}%  {rec['events']:6d}")
    frac = doc["attributed_frac"]
    if frac is None:
        # events selected but every duration zero/absent: nothing to
        # apportion — say so instead of dividing by the zero total
        lines.append("  attributed: n/a (device events carry no "
                     "durations)")
    else:
        flag = "OK" if doc["attributed_ok"] else \
            f"BELOW the {ATTRIBUTED_MIN_FRAC * 100:.0f}% invariant"
        lines.append(f"  attributed: {frac * 100:.1f}% of device time "
                     f"into named categories ({flag})")
    if doc.get("hand_kernels"):
        lines.append("  hand kernels:")
        for row, rec in doc["hand_kernels"].items():
            lines.append(f"    {row:<20} {_fmt_us(rec['ms'] * 1e3):>12}"
                         f"  x{rec['launches']}")
    if doc.get("top_ops"):
        lines.append("  top ops by self time:")
        for op in doc["top_ops"][:8]:
            lines.append(
                f"    {op['name'][:36]:<36} {_fmt_us(op['time_us']):>12}"
                f"  [{op['category']}] x{op['events']}")
    return "\n".join(lines)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m fedtorch_tpu_torch.tools.trace_attrib",
        description="Attribute a capture directory's device time into "
                    "the JAX package's op categories")
    p.add_argument("capture_dir",
                   help="directory holding *.trace.json (or a "
                        "trace.json[.gz] file directly)")
    p.add_argument("--out", default=None,
                   help="also write the attribution JSON here")
    p.add_argument("--render", default=None,
                   help="also write the rendered table here")
    args = p.parse_args(argv)
    try:
        doc = attribute(args.capture_dir)
    except ValueError as e:
        print(f"trace_attrib: {e}", file=sys.stderr)
        return 2
    text = render(doc)
    print(text)
    for path, write in ((args.out, lambda f: json.dump(
            doc, f, indent=2, sort_keys=True)),
            (args.render, lambda f: f.write(text + "\n"))):
        if path:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            tmp = path + ".tmp"
            with open(tmp, "w") as f:
                write(f)
            os.replace(tmp, path)
    if not doc.get("categories"):
        return 2
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
