"""Host-side per-client federation ledger (port of
``fedtorch_tpu/telemetry/ledger.py``, docs/observability.md "Federation
plane").

The ledger accumulates what the round loop's one batched fetch carries
of each round's cohort (``FederatedTrainer.round_host_scalars`` with
``ledger=True``: the ``[k]`` vectors ride the same transfer as the log
scalars, so the per-round sync count stays at one): which clients
participated, which the guards rejected, what the robust rule suspected
of whom, how stale each committed update was. It persists them as the
schema-versioned, atomically replaced ``client_ledger.json`` that an
elastic restart adopts.

Memory: **O(min(C, sketch_budget)) at any population**.

* ``C <= sketch_budget``: **dense** mode, one numpy counter array per
  quantity (8 x 8 bytes a client).
* ``C > sketch_budget``: **sketch** mode, a count-min sketch (depth
  ``_CM_DEPTH``, width ``budget // depth``) answering participation
  queries within the overestimate bound, and a space-saving top-K
  (``budget // 16`` records) of exact records for the clients of
  highest cumulative suspicion.

Per round, for each cohort client (O(k) numpy updates):
``participation`` += 1, ``online`` += survived the round, ``accepted``
+= passed the guards, ``rejected`` += survived but guard-rejected,
``selected`` += the robust rule aggregated it, ``dropped`` +=
dispatched but never reported, ``suspicion`` += the rule's per-client
score (``robustness/aggregators.py`` ``RobustReport``), ``staleness``
+= commit staleness (the async plane; 0 on the sync planes).

The count-min hash is the JAX package's deterministic universal family
(:func:`_hash_params`), so fed the same vectors the two ledgers write
the same counters, sketch and top-K records (the timestamps differ).
numpy only, imported on first use; the reader half is stdlib. Writes
never raise: a failed flush is counted and logged.
"""
from __future__ import annotations

import heapq
import json
import os
import time
from typing import Dict, List, Optional, Tuple

# numpy is imported LAZILY (first ClientLedger construction): the
# reader half below is pure stdlib, and the telemetry package —
# through which `fedtorch-tpu report` imports — must stay importable
# on a monitor box without numpy.
np = None


def _numpy():
    global np
    if np is None:
        import numpy
        np = numpy
    return np

LEDGER_SCHEMA = "fedtorch_tpu.client_ledger/v1"
LEDGER_FILE = "client_ledger.json"

# per-client quantities the ledger accumulates; integer-count semantics
# for the first six, float sums for the last two. ``dropped`` is
# derived per round as participation - online: the client was
# dispatched but never reported (chaos crash, availability dropout, or
# deadline miss — the deployment-realism lifecycle's per-client
# accounting, docs/robustness.md "Deployment realism")
LEDGER_COUNTERS = ("participation", "online", "accepted", "rejected",
                   "selected", "dropped", "suspicion", "staleness")
_INT_COUNTERS = ("participation", "online", "accepted", "rejected",
                 "selected", "dropped")

# count-min geometry (sketch mode): classic (depth, width) trade —
# 4 rows bound the overestimate at ~e^-4 failure odds per query
_CM_DEPTH = 4
# 31-bit Mersenne prime for the universal hash family; a*x+b stays
# under 2^62, so uint64 arithmetic never overflows
_CM_PRIME = 2147483647


def ledger_path(run_dir: str) -> str:
    return os.path.join(run_dir, LEDGER_FILE)


def _hash_params(seed: int) -> List[Tuple[int, int]]:
    """Deterministic (a, b) pairs of the count-min universal hash
    family — a tiny LCG off the seed, so two ledgers with equal seeds
    sketch identically (the determinism-under-seed test)."""
    out = []
    s = (seed * 2654435761 + 0x9E3779B9) & 0x7FFFFFFF
    for _ in range(_CM_DEPTH):
        s = (s * 1103515245 + 12345) & 0x7FFFFFFF
        a = (s % (_CM_PRIME - 1)) + 1
        s = (s * 1103515245 + 12345) & 0x7FFFFFFF
        b = s % _CM_PRIME
        out.append((a, b))
    return out


class ClientLedger:
    """Accumulates the per-client federation record and persists it.

    ``update`` is called once per round with the host copies of the
    cohort vectors; ``flush`` atomically replaces
    ``client_ledger.json`` (every ``flush_every`` rounds and at run
    end); ``load_existing`` adopts a prior attempt's file on elastic
    restart. ``stats`` serves the two metrics-row gauges
    (``ledger_tracked`` / ``ledger_bytes``)."""

    # exact per-client records kept in sketch mode (space-saving by
    # cumulative suspicion); dense mode tracks everyone exactly
    TOP_DIVISOR = 16
    # entries of the persisted top-suspicion preview in dense mode
    PREVIEW = 32

    def __init__(self, run_dir: str, num_clients: int,
                 sketch_budget: int = 65536, seed: int = 0,
                 flush_every: int = 25,
                 run_meta: Optional[Dict] = None, log=None):
        np = _numpy()
        self.path = ledger_path(run_dir)
        self.num_clients = int(num_clients)
        self.sketch_budget = int(sketch_budget)
        self.seed = int(seed)
        self.flush_every = max(int(flush_every), 1)
        self.run_meta = run_meta or {}
        self._log = log if log is not None else (lambda *_: None)
        self.rounds = 0
        self.write_errors = 0
        self._created = time.time()
        self._rounds_since_flush = 0
        self.mode = "dense" if self.num_clients <= self.sketch_budget \
            else "sketch"
        if self.mode == "dense":
            self._dense = {
                name: np.zeros(
                    self.num_clients,
                    np.int64 if name in _INT_COUNTERS else np.float64)
                for name in LEDGER_COUNTERS}
            self._cm = None
            self._top: Dict[int, Dict[str, float]] = {}
            self.top_k = 0
        else:
            self._dense = None
            self._cm_width = max(self.sketch_budget // _CM_DEPTH, 64)
            self._cm_hash = _hash_params(self.seed)
            self._cm = np.zeros((_CM_DEPTH, self._cm_width), np.int64)
            self.top_k = max(self.sketch_budget // self.TOP_DIVISOR, 16)
            self._top = {}
            # lazy-deletion min-heap over (suspicion, cid): eviction
            # pops amortized O(log K) instead of scanning all K
            # records per insert; stale entries (a client updated
            # since its push) are skipped on pop — suspicion only
            # grows, so a stale entry never masks the true minimum
            self._heap: List[Tuple[float, int]] = []

    # -- accumulation ----------------------------------------------------
    def _cm_rows(self, idx):
        """[depth, k] count-min column indices for the client ids."""
        np = _numpy()
        idx = idx.astype(np.uint64)
        cols = np.empty((_CM_DEPTH, idx.shape[0]), np.int64)
        for j, (a, b) in enumerate(self._cm_hash):
            cols[j] = (((a * idx + b) % _CM_PRIME)
                       % self._cm_width).astype(np.int64)
        return cols

    def _evict_min(self) -> float:
        """Evict the minimum-suspicion record (lazy-deletion heap);
        returns the evicted suspicion floor."""
        while self._heap:
            susp, cid = heapq.heappop(self._heap)
            rec = self._top.get(cid)
            if rec is not None and rec["suspicion"] == susp:
                del self._top[cid]
                return susp
        # heap exhausted of valid entries (all stale): rebuild once
        self._rebuild_heap()
        susp, cid = heapq.heappop(self._heap)
        del self._top[cid]
        return susp

    def _rebuild_heap(self) -> None:
        self._heap = [(rec["suspicion"], cid)
                      for cid, rec in self._top.items()]
        heapq.heapify(self._heap)

    def _top_update(self, cid: int, inc: Dict[str, float]) -> None:
        """Space-saving top-K on cumulative suspicion: a tracked client
        updates in place; an untracked one evicts the current minimum,
        inheriting its suspicion floor (the classic overestimate that
        keeps genuine heavy hitters from being churned out)."""
        rec = self._top.get(cid)
        if rec is None:
            rec = {name: 0.0 for name in LEDGER_COUNTERS}
            if len(self._top) >= self.top_k:
                rec["suspicion"] = self._evict_min()
            self._top[cid] = rec
        for name in LEDGER_COUNTERS:
            rec[name] += inc[name]
        heapq.heappush(self._heap, (rec["suspicion"], cid))
        if len(self._heap) > 4 * self.top_k + 1024:
            self._rebuild_heap()

    def update(self, round_idx: int, led: Dict) -> None:
        """Fold one round's cohort vectors (host numpy copies of
        ``FederatedTrainer.cohort_fetch_dev``) into the ledger. O(k)."""
        np = _numpy()
        idx = np.asarray(led["idx"], np.int64).ravel()
        online = np.asarray(led["online"], np.float64).ravel()
        accept = np.asarray(led["accept"], np.float64).ravel()
        selected = np.asarray(led["selected"], np.float64).ravel()
        suspicion = np.asarray(led["suspicion"], np.float64).ravel()
        staleness = np.asarray(led["staleness"], np.float64).ravel()
        rejected = np.maximum(online - accept, 0.0)
        dropped = np.maximum(1.0 - online, 0.0)
        self.rounds += 1
        if self.mode == "dense":
            d = self._dense
            np.add.at(d["participation"], idx, 1)
            np.add.at(d["online"], idx, online.astype(np.int64))
            np.add.at(d["accepted"], idx, accept.astype(np.int64))
            np.add.at(d["rejected"], idx, rejected.astype(np.int64))
            np.add.at(d["selected"], idx, selected.astype(np.int64))
            np.add.at(d["dropped"], idx, dropped.astype(np.int64))
            np.add.at(d["suspicion"], idx, suspicion)
            np.add.at(d["staleness"], idx, staleness)
        else:
            cols = self._cm_rows(idx)
            for j in range(_CM_DEPTH):
                np.add.at(self._cm[j], cols[j], 1)
            for i, cid in enumerate(idx.tolist()):
                self._top_update(cid, {
                    "participation": 1.0, "online": float(online[i]),
                    "accepted": float(accept[i]),
                    "rejected": float(rejected[i]),
                    "selected": float(selected[i]),
                    "dropped": float(dropped[i]),
                    "suspicion": float(suspicion[i]),
                    "staleness": float(staleness[i])})
        self._rounds_since_flush += 1
        if self._rounds_since_flush >= self.flush_every:
            self.flush()

    # -- queries ---------------------------------------------------------
    def participation_estimate(self, cid: int) -> int:
        """Exact in dense mode; the count-min upper bound in sketch
        mode (min over rows — never undercounts)."""
        if self.mode == "dense":
            return int(self._dense["participation"][cid])
        cols = self._cm_rows(_numpy().asarray([cid]))
        return int(min(self._cm[j, cols[j, 0]]
                       for j in range(_CM_DEPTH)))

    def tracked(self) -> int:
        """Clients with exact per-client records."""
        if self.mode == "dense":
            return self.num_clients
        return len(self._top)

    def memory_bytes(self) -> int:
        """Host bytes the ledger holds — the O(min(C, budget)) bound
        TELEMETRY_AB.json measures at C=10^6."""
        if self.mode == "dense":
            return int(sum(a.nbytes for a in self._dense.values()))
        # dict-of-dict records: ~7 floats + key + dict overhead; the
        # lazy heap is bounded at 4*top_k + 1024 tuples
        per_rec = 8 * len(LEDGER_COUNTERS) + 120
        return int(self._cm.nbytes + len(self._top) * per_rec
                   + len(self._heap) * 72)

    def stats(self) -> Dict[str, float]:
        """The metrics-row gauges (cataloged in telemetry.schema)."""
        return {"ledger_tracked": float(self.tracked()),
                "ledger_bytes": float(self.memory_bytes())}

    # -- persistence -----------------------------------------------------
    def _doc(self) -> Dict:
        doc = {
            "schema": LEDGER_SCHEMA,
            "created_unix": self._created,
            "updated_unix": time.time(),
            "num_clients": self.num_clients,
            "sketch_budget": self.sketch_budget,
            "seed": self.seed,
            "mode": self.mode,
            "rounds": self.rounds,
            "run": self.run_meta,
        }
        np = _numpy()
        if self.mode == "dense":
            counters = {}
            for name, arr in self._dense.items():
                if name in _INT_COUNTERS:
                    counters[name] = arr.tolist()
                else:
                    # vectorized: a per-element Python round() over a
                    # budget-sized array would put tens of ms on the
                    # round the 25-round flush cadence lands on
                    counters[name] = np.round(arr, 6).tolist()
            doc["counters"] = counters
            order = np.argsort(-self._dense["suspicion"],
                               kind="stable")[:self.PREVIEW]
            doc["top_suspicion"] = [
                [int(c), round(float(self._dense["suspicion"][c]), 6)]
                for c in order if self._dense["participation"][c] > 0]
        else:
            doc["sketch"] = {
                "depth": _CM_DEPTH, "width": self._cm_width,
                "participation": self._cm.tolist(),
            }
            doc["top"] = {
                str(cid): {name: (int(rec[name])
                                  if name in _INT_COUNTERS
                                  else round(rec[name], 6))
                           for name in LEDGER_COUNTERS}
                for cid, rec in sorted(self._top.items())}
        return doc

    def flush(self) -> None:
        """Atomic replace (tmp + ``os.replace``): a reader at any
        moment sees a complete document. Never raises — a full disk
        counts an error and training continues."""
        self._rounds_since_flush = 0
        tmp = self.path + ".tmp"
        try:
            with open(tmp, "w") as f:
                json.dump(self._doc(), f)
            os.replace(tmp, self.path)
        except OSError as e:
            self.write_errors += 1
            self._log(f"client ledger: write failed ({e}); "
                      "will retry at the next flush")
            try:
                os.unlink(tmp)
            except OSError:
                pass

    def load_existing(self) -> bool:
        """Adopt a prior attempt's ledger (elastic restart — the
        ``program_costs.json`` convention): counters resume instead of
        restarting from zero and double-writing a half-empty file over
        the history. Returns True when adopted; a missing file, a
        different schema/population/geometry, or a corrupt document
        adopts nothing — the WHOLE parse runs inside the guard and
        state commits only at the end, so a content-corrupt file (a
        record missing a key, a string in a counter list) can neither
        crash an elastic restart nor leave a half-adopted ledger."""
        np = _numpy()
        try:
            with open(self.path) as f:
                doc = json.load(f)
            validate_client_ledger(doc)
            if doc["num_clients"] != self.num_clients \
                    or doc["mode"] != self.mode \
                    or doc.get("seed", 0) != self.seed \
                    or doc.get("sketch_budget") != self.sketch_budget:
                self._log("client ledger: existing file has a "
                          "different population/geometry; starting "
                          "fresh")
                return False
            rounds = int(doc["rounds"])
            if self.mode == "dense":
                dense = {
                    name: np.asarray(
                        doc["counters"][name],
                        np.int64 if name in _INT_COUNTERS
                        else np.float64)
                    for name in LEDGER_COUNTERS}
                if any(a.shape != (self.num_clients,)
                       for a in dense.values()):
                    raise ValueError("counter shape mismatch")
            else:
                sk = doc["sketch"]
                if sk["depth"] != _CM_DEPTH \
                        or sk["width"] != self._cm_width:
                    self._log("client ledger: existing sketch "
                              "geometry differs; starting fresh")
                    return False
                cm = np.asarray(sk["participation"], np.int64)
                if cm.shape != (_CM_DEPTH, self._cm_width):
                    raise ValueError("sketch table shape mismatch")
                top = {
                    int(cid): {name: float(rec[name])
                               for name in LEDGER_COUNTERS}
                    for cid, rec in doc["top"].items()}
        except (OSError, ValueError, KeyError, TypeError,
                json.JSONDecodeError):
            return False
        # parsed clean: commit
        self.rounds = rounds
        if self.mode == "dense":
            self._dense = dense
        else:
            self._cm = cm
            self._top = top
            self._rebuild_heap()
        return True


# -- stdlib reader half (report tool, monitors) --------------------------

def validate_client_ledger(doc: Dict) -> None:
    """Raise ``ValueError`` when ``doc`` violates the v1 contract."""
    if doc.get("schema") != LEDGER_SCHEMA:
        raise ValueError(
            f"client ledger schema {doc.get('schema')!r} != "
            f"{LEDGER_SCHEMA!r}")
    for key in ("num_clients", "mode", "rounds", "sketch_budget"):
        if key not in doc:
            raise ValueError(f"client_ledger.json missing {key!r}")
    if doc["mode"] == "dense":
        counters = doc.get("counters")
        if not isinstance(counters, dict):
            raise ValueError("dense ledger missing 'counters'")
        for name in LEDGER_COUNTERS:
            if name == "dropped" and name not in counters:
                # added after v1 shipped; absent in older run dirs —
                # readers backfill zeros (read_client_ledger)
                continue
            vals = counters.get(name)
            if not isinstance(vals, list) \
                    or len(vals) != doc["num_clients"]:
                raise ValueError(
                    f"dense ledger counter {name!r} missing or not "
                    f"[num_clients] long")
    elif doc["mode"] == "sketch":
        if not isinstance(doc.get("sketch"), dict) \
                or not isinstance(doc.get("top"), dict):
            raise ValueError("sketch ledger missing 'sketch'/'top'")
    else:
        raise ValueError(f"unknown ledger mode {doc['mode']!r}")


def read_client_ledger(path: str) -> Dict:
    """Load + validate a ``client_ledger.json`` (``path`` may be the
    file or its run dir). Pure stdlib."""
    if os.path.isdir(path):
        path = ledger_path(path)
    with open(path) as f:
        doc = json.load(f)
    validate_client_ledger(doc)
    # backfill the post-v1 'dropped' counter for older run dirs so
    # every consumer sees the full LEDGER_COUNTERS surface
    if doc["mode"] == "dense" and "dropped" not in doc["counters"]:
        doc["counters"]["dropped"] = [0] * doc["num_clients"]
    elif doc["mode"] == "sketch":
        for rec in doc["top"].values():
            rec.setdefault("dropped", 0)
    return doc


def suspicion_ranking(doc: Dict, top: int = 0) -> List[Tuple[int, float]]:
    """[(client, cumulative suspicion)] sorted most-suspect first,
    from either mode's document — the query the Byzantine-separation
    drill (``chaos_suite.py --ledger-attack``) and the report's
    Federation section ask. ``top`` truncates (0 = all tracked)."""
    if doc["mode"] == "dense":
        pairs = [(cid, float(s)) for cid, s in
                 enumerate(doc["counters"]["suspicion"])
                 if doc["counters"]["participation"][cid] > 0]
    else:
        pairs = [(int(cid), float(rec["suspicion"]))
                 for cid, rec in doc["top"].items()]
    pairs.sort(key=lambda p: (-p[1], p[0]))
    return pairs[:top] if top else pairs
