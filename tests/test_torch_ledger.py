"""The client ledger and the anomaly detector in the port against the
JAX package's (the twins of ``TestClientLedger`` and
``TestAnomalyDetector`` in ``tests/test_cohort_stats.py``), on the CPU.

The same cohort vectors go into both packages' ledgers: the flushed
``client_ledger.json`` documents are equal but their two timestamps
(dense mode, sketch mode with its count-min table and top-K records),
each package adopts the other's file on resume, and a failed write is
counted, not raised. The same metrics rows go into both detectors: the
same ``anomaly.detected`` records and the same summary. Everything here
is exact: both sides run the same float64 numpy and stdlib arithmetic.
"""
import json
import math
import os

import numpy as np
import pytest

import torch_threads  # noqa: F401 (two torch threads a worker)
from fedtorch_tpu.telemetry import anomaly as janomaly
from fedtorch_tpu.telemetry import ledger as jledger
from fedtorch_tpu_torch.telemetry import anomaly as tanomaly
from fedtorch_tpu_torch.telemetry import ledger as tledger


def _round_vectors(idx, online=None, accept=None, selected=None,
                   suspicion=None, staleness=None):
    """One round's cohort vectors as the round's fetch hands them over
    (float32, ids int64)."""
    k = len(idx)

    def vec(v, default):
        return np.asarray(default if v is None else v, np.float32)
    return {"idx": np.asarray(idx, np.int64),
            "online": vec(online, np.ones(k)),
            "accept": vec(accept, np.ones(k)),
            "selected": vec(selected, np.ones(k)),
            "suspicion": vec(suspicion, np.zeros(k)),
            "staleness": vec(staleness, np.zeros(k)),
            "norm_q": np.zeros(5, np.float32)}


def _rounds(num_clients, num_rounds, k, seed):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(num_rounds):
        idx = rng.choice(num_clients, size=k, replace=False)
        online = (rng.rand(k) > 0.2).astype(np.float32)
        accept = online * (rng.rand(k) > 0.2)
        out.append(_round_vectors(
            idx, online=online, accept=accept,
            selected=accept * (rng.rand(k) > 0.3),
            suspicion=rng.rand(k) * 3.0,
            staleness=rng.randint(0, 4, k)))
    return out


def _doc(path):
    with open(path) as f:
        doc = json.load(f)
    doc.pop("created_unix")
    doc.pop("updated_unix")
    return doc


@pytest.mark.parametrize("num_clients, budget", [
    (12, 65536), (200_000, 512), (1_000_000, 4096)],
    ids=["dense", "sketch", "sketch_1e6"])
def test_the_ledger_file_is_the_jax_ledger_s(num_clients, budget, tmp_path):
    docs = []
    for mod, sub in ((jledger, "jax"), (tledger, "port")):
        d = tmp_path / sub
        d.mkdir()
        led = mod.ClientLedger(str(d), num_clients=num_clients,
                               sketch_budget=budget, seed=7,
                               flush_every=4,
                               run_meta={"algorithm": "fedavg"})
        for r, vecs in enumerate(_rounds(num_clients, 9, 8, 3)):
            led.update(r, vecs)
        led.flush()
        docs.append((_doc(led.path), led.stats(),
                     led.participation_estimate(int(vecs["idx"][0]))))
    assert docs[0] == docs[1]
    assert docs[1][0]["mode"] == ("dense" if num_clients <= budget
                                  else "sketch")
    # the JAX package's reader takes the port's file
    doc = jledger.read_client_ledger(str(tmp_path / "port"))
    assert jledger.suspicion_ranking(doc, top=3) == \
        tledger.suspicion_ranking(tledger.read_client_ledger(
            str(tmp_path / "port")), top=3)


def test_dense_counter_semantics(tmp_path):
    """The JAX package's hand-computed case."""
    led = tledger.ClientLedger(str(tmp_path), num_clients=6,
                               flush_every=10 ** 9)
    led.update(0, _round_vectors([0, 1, 2], online=[1, 1, 0],
                                 accept=[1, 0, 0],
                                 suspicion=[0.5, 2.0, 0.0]))
    led.update(1, _round_vectors([1, 3, 5], staleness=[1, 2, 0],
                                 suspicion=[3.0, 0.1, 0.2]))
    d = led._dense
    assert d["participation"].tolist() == [1, 2, 1, 1, 0, 1]
    assert d["rejected"].tolist() == [0, 1, 0, 0, 0, 0]
    assert d["online"].tolist() == [1, 2, 0, 1, 0, 1]
    assert d["dropped"].tolist() == [0, 0, 1, 0, 0, 0]
    assert d["suspicion"][1] == pytest.approx(5.0)
    assert d["staleness"][3] == pytest.approx(2.0)
    assert led.stats()["ledger_tracked"] == 6.0


@pytest.mark.parametrize("writer", [jledger, tledger],
                         ids=["jax_file", "port_file"])
@pytest.mark.parametrize("num_clients, budget", [
    (12, 65536), (50_000, 256)], ids=["dense", "sketch"])
def test_adoption_on_resume_across_the_packages(writer, num_clients,
                                                budget, tmp_path):
    """Either package's file is adopted by both, and the two adopted
    ledgers continue to the same file (an adopted ledger resumes from the
    file's rounded sums, in either package)."""
    rounds = _rounds(num_clients, 6, 8, 5)
    os.makedirs(tmp_path / "a")
    first = writer.ClientLedger(str(tmp_path / "a"), num_clients,
                                sketch_budget=budget, flush_every=10 ** 9)
    for r, v in enumerate(rounds[:3]):
        first.update(r, v)
    first.flush()
    docs = []
    for mod, sub in ((jledger, "jax"), (tledger, "port")):
        os.makedirs(tmp_path / sub)
        with open(first.path) as f, \
                open(tmp_path / sub / tledger.LEDGER_FILE, "w") as g:
            g.write(f.read())
        resumed = mod.ClientLedger(str(tmp_path / sub), num_clients,
                                   sketch_budget=budget,
                                   flush_every=10 ** 9)
        assert resumed.load_existing() and resumed.rounds == 3
        for r, v in enumerate(rounds[3:], 3):
            resumed.update(r, v)
        resumed.flush()
        docs.append(_doc(resumed.path))
    assert docs[0] == docs[1] and docs[1]["rounds"] == 6


def test_adoption_refuses_another_geometry_and_corrupt_files(tmp_path):
    led = tledger.ClientLedger(str(tmp_path), num_clients=5,
                               flush_every=10 ** 9)
    led.update(0, _round_vectors([0, 1], suspicion=[1.0, 2.0]))
    led.flush()
    assert not tledger.ClientLedger(str(tmp_path), 9).load_existing()
    doc = json.load(open(led.path))
    doc["counters"]["suspicion"][0] = "oops"
    json.dump(doc, open(led.path, "w"))
    bad = tledger.ClientLedger(str(tmp_path), 5, flush_every=10 ** 9)
    assert not bad.load_existing() and bad.rounds == 0
    with open(led.path, "w") as f:
        f.write("{not json")
    assert not tledger.ClientLedger(str(tmp_path), 5).load_existing()


def test_a_failed_write_is_counted_not_raised(tmp_path):
    logged = []
    led = tledger.ClientLedger(str(tmp_path / "nope" / "deeper"),
                               num_clients=4, flush_every=1,
                               log=logged.append)
    led.update(0, _round_vectors([0]))  # flush_every=1 flushes here
    led.flush()
    assert led.write_errors == 2 and len(logged) == 2
    assert not os.path.exists(led.path + ".tmp")


# -- the anomaly detector ------------------------------------------------

def _row_sequence(seed):
    """Rows with a warm-up, a loss spike, a reject burst, a NaN, a
    staleness runaway, derived rates and odd fields."""
    rng = np.random.RandomState(seed)
    rows = []
    for r in range(60):
        row = {"round": r, "loss": 1.0 + 0.01 * rng.randn(),
               "rejected": 0.0, "n_online": 8.0,
               "staleness": 0.5 + 0.05 * rng.randn(),
               "cohort_dispersion": 0.3 + 0.01 * rng.randn(),
               "avail_dropped": 0.0, "deadline_missed": 1.0}
        if r == 20:
            row["loss"] = 40.0
        if r in (30, 31):
            row["rejected"] = 6.0
        if r == 40:
            row["loss"] = float("nan")
        if r >= 50:
            row["staleness"] = 9.0
        if r == 55:
            row["dp_clipped_frac"] = 0.9
            row["loss"] = "oops"
        rows.append(row)
    return rows


@pytest.mark.parametrize("kw", [dict(), dict(zscore=3.0, warmup=5),
                                dict(zscore=2.0, warmup=2,
                                     max_events_per_field=2)],
                         ids=["default", "z3", "capped"])
def test_the_detector_gives_the_jax_detector_s_events(kw):
    jd = janomaly.EwmaAnomalyDetector(**kw)
    td = tanomaly.EwmaAnomalyDetector(**kw)
    fired = 0
    for row in _row_sequence(1):
        want, got = jd.observe(row), td.observe(row)
        assert repr(got) == repr(want), row["round"]
        fired += len(got)
    assert td.summary() == jd.summary()
    assert fired > 0
    assert tanomaly.ANOMALY_FIELDS == janomaly.ANOMALY_FIELDS


def test_the_detector_is_observe_only_and_rearms():
    det = tanomaly.EwmaAnomalyDetector(zscore=4.0, warmup=5)
    rows = [{"loss": 1.0 + 0.001 * (i % 3)} for i in range(20)]
    assert all(det.observe(r) == [] for r in rows)
    assert det.observe({"loss": 50.0})[0]["field"] == "loss"
    assert det.observe({"loss": 60.0}) == []  # one event an excursion
    # a NaN is an anomaly and never enters the EWMA
    out = det.observe({"loss": float("nan")})
    assert out[0]["value"] == "nan"
    assert math.isfinite(det.summary()["loss"]["ewma_mean"])
    with pytest.raises(ValueError, match="zscore"):
        tanomaly.EwmaAnomalyDetector(zscore=0.0)


def test_replay_over_a_run_directory(tmp_path):
    d = tmp_path / "run"
    d.mkdir()
    with open(d / "metrics.jsonl", "w") as f:
        f.write(json.dumps({"schema": "fedtorch_tpu.metrics/v1"}) + "\n")
        for r in range(14):
            loss = 1.0 + 0.001 * (r % 3) if r < 13 else 50.0
            f.write(json.dumps({"round": r, "loss": loss}) + "\n")
        f.write('{"round": 14, "lo')  # a torn tail
    want = janomaly.replay_anomalies(str(d), zscore=6.0, warmup=5)
    got = tanomaly.replay_anomalies(str(d), zscore=6.0, warmup=5)
    assert got == want and got["torn_lines"] == 1
    assert any(a["round"] == 13 for a in got["anomalies"])
