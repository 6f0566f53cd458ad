"""The port's run telemetry (``fedtorch_tpu_torch/telemetry``), mirroring
the JAX package's ``test_telemetry.py`` and held to the JAX package's
readers, on the CPU.

* A port run directory passes the JAX package's
  ``validate_metrics_row``, ``validate_health``, ``load_jsonl``,
  ``stitch_rows`` and ``count_restarts``, and ``python -m
  fedtorch_tpu.cli report <port run dir>`` exits with 0 (the test runs
  the JAX package; the port never imports it).
* The JAX CLI and the port's CLI on one synthetic configuration write
  rows of the same keys — but the device-memory pair of the cost
  capture, which has no meaning on the CPU — and equal ``round``,
  ``n_online`` and ``comm_bytes`` (exact: counts and byte sums).
* The writers themselves: the schema catalog is the JAX package's, rows
  carry ``seq`` and ``t``, a torn tail is skipped, the trace exports,
  the health file validates and throttles, ``--telemetry off`` writes
  none of the files.
"""
import json
import os
import subprocess
import sys

import pytest

import torch_threads  # noqa: F401 (two torch threads a worker)
from fedtorch_tpu import telemetry as jtel
from fedtorch_tpu_torch import cli as tcli
from fedtorch_tpu_torch import telemetry as ttel
from fedtorch_tpu_torch.telemetry import schema as tschema
from torch_lifecycle import REPO, cli_argv

# the device gauges with no meaning on the CPU: the CUDA allocator's
# memory pair (absent from a CPU row, the JAX "graceful None" rule); the
# MFU trio rides both packages' rows (telemetry/costs.py)
COST_GAUGES = {"hbm_program_peak_bytes", "hbm_live_bytes"}
ROW = {"round": 0, "round_s": 0.5, "loss": 1.0, "acc": 0.5, "lr": 0.1,
       "n_online": 3.0, "comm_bytes": 10.0}


@pytest.fixture(scope="module")
def port_run(tmp_path_factory):
    run = tmp_path_factory.mktemp("port") / "run"
    res = tcli.main(cli_argv(run, rounds=3, extra=[
        "--backend", "cpu", "--save_all_models", "true"]))
    return run, res


def test_the_catalog_and_the_schema_names_are_the_jax_package_s():
    assert tschema.METRICS_SCHEMA == jtel.METRICS_SCHEMA
    assert tschema.EVENTS_SCHEMA == jtel.EVENTS_SCHEMA
    assert tschema.HEALTH_SCHEMA == jtel.HEALTH_SCHEMA
    assert tschema.METRICS_REQUIRED == jtel.METRICS_REQUIRED
    # the port's one gauge of its own: the bytes of the client-shard
    # seam's whole gather (its riders ride where GSPMD moves the JAX
    # package's)
    assert set(tschema.METRICS_OPTIONAL) == set(jtel.METRICS_OPTIONAL) \
        | {"cohort_gather_bytes"}
    assert tschema.HEALTH_INTENTS == jtel.HEALTH_INTENTS


def test_a_port_run_passes_the_jax_package_s_validators(port_run):
    run, res = port_run
    header, rows, torn = jtel.load_jsonl(str(run / "metrics.jsonl"))
    assert header["schema"] == jtel.METRICS_SCHEMA and torn == 0
    assert [r["round"] for r in rows] == [0, 1, 2]
    for row in rows:
        jtel.validate_metrics_row(row)
    assert [r["seq"] for r in rows] == [0, 1, 2]
    assert jtel.count_restarts(rows) == 0
    assert [r["round"] for r in jtel.stitch_rows(rows)] == [0, 1, 2]
    health = jtel.read_health(str(run))
    jtel.validate_health(health)
    assert health["intent"] == "complete" and health["round"] == 3
    eh, events, _ = jtel.load_jsonl(str(run / "events.jsonl"))
    names = [e["event"] for e in events]
    assert eh["schema"] == jtel.EVENTS_SCHEMA
    assert names[0] == "run.start" and names[-1] == "run.end"
    launches = next(e for e in events if e["event"] == "kernels.launches")
    assert launches["rounds"] == 3  # the CPU run launches no kernel
    trace = json.load(open(run / "trace.json"))
    spans = {e["name"] for e in trace["traceEvents"] if e["ph"] == "X"}
    assert {"round", "scalar_fetch", "eval", "checkpoint",
            "checkpoint.snapshot", "checkpoint.write"} <= spans
    assert rows[-1]["test_top1"] == res["test_top1"]


def test_the_jax_package_s_report_reads_a_port_run(port_run):
    run, _ = port_run
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    r = subprocess.run([sys.executable, "-m", "fedtorch_tpu.cli", "report",
                        str(run)], cwd=REPO, env=env, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert "rounds: 3" in r.stdout and "intent=complete" in r.stdout


def test_rows_match_the_jax_cli_s(tmp_path):
    from fedtorch_tpu import cli as jcli
    argv = cli_argv(tmp_path / "jax", rounds=2)
    jcli.main(argv)
    tcli.main(cli_argv(tmp_path / "port", rounds=2,
                       extra=["--backend", "cpu"]))
    _, jrows, _ = jtel.load_jsonl(str(tmp_path / "jax" / "metrics.jsonl"))
    _, trows, _ = jtel.load_jsonl(str(tmp_path / "port" / "metrics.jsonl"))
    assert len(jrows) == len(trows) == 2
    for j, t in zip(jrows, trows):
        assert set(j) - COST_GAUGES == set(t)
        for key in ("round", "n_online", "comm_bytes"):
            assert t[key] == j[key], key


def test_telemetry_off_writes_none_of_the_files(tmp_path):
    tcli.main(cli_argv(tmp_path / "run", rounds=2, extra=[
        "--backend", "cpu", "--telemetry", "off"]))
    files = set(os.listdir(tmp_path / "run"))
    assert not files & {"metrics.jsonl", "events.jsonl", "health.json",
                        "trace.json"}
    assert "checkpoint.ckpt" in files


# -- the writers ------------------------------------------------------------
def test_writer_roundtrip_header_seq_and_t(tmp_path):
    w = ttel.JsonlWriter(str(tmp_path / "m.jsonl"), ttel.METRICS_SCHEMA,
                         run_meta={"arch": "mlp"})
    for r in range(3):
        w.write(dict(ROW, round=r))
    w.close()
    header, rows, torn = jtel.load_jsonl(str(tmp_path / "m.jsonl"))
    assert header["schema"] == ttel.METRICS_SCHEMA
    assert header["run"] == {"arch": "mlp"} and torn == 0
    assert [r["seq"] for r in rows] == [0, 1, 2]
    assert all(isinstance(r["t"], float) for r in rows)


def test_schema_rejects_missing_uncataloged_and_bool_fields():
    ttel.validate_metrics_row(dict(ROW, sup_rollbacks=1.0, stream_depth=2.0))
    with pytest.raises(ValueError, match="missing required 'loss'"):
        ttel.validate_metrics_row({k: v for k, v in ROW.items()
                                   if k != "loss"})
    with pytest.raises(ValueError, match="uncataloged"):
        ttel.validate_metrics_row(dict(ROW, bogus=1.0))
    with pytest.raises(ValueError, match="must be float"):
        ttel.validate_metrics_row(dict(ROW, loss=True))


def test_a_torn_tail_and_an_appended_restart_are_read(tmp_path):
    path = str(tmp_path / "m.jsonl")
    w = ttel.JsonlWriter(path, ttel.METRICS_SCHEMA)
    for r in range(2):
        w.write(dict(ROW, round=r), flush=True)
    w.close()
    with open(path, "a") as f:
        f.write('{"round": 2, "round_s"')  # a crash mid-append
    w2 = ttel.JsonlWriter(path, ttel.METRICS_SCHEMA)  # the restart
    for r in (1, 2):
        w2.write(dict(ROW, round=r, loss=2.0), flush=True)
    w2.close()
    _, rows, torn = ttel.load_jsonl(path)
    assert torn == 1 and ttel.count_restarts(rows) == 1
    stitched = ttel.stitch_rows(rows)
    assert [r["round"] for r in stitched] == [0, 1, 2]
    assert [r["loss"] for r in stitched] == [1.0, 2.0, 2.0]


def test_chrome_trace_export_and_module_hooks(tmp_path):
    assert ttel.span("x") is ttel.NULL_SPAN  # nothing installed
    ttel.event("ignored")
    tel = ttel.Telemetry(str(tmp_path), level="default").install()
    try:
        with ttel.span("stream.gather", round=3):
            pass
        ttel.event("supervisor.rollback", round=3, attempt=1)
    finally:
        tel.close()
    doc = json.load(open(tmp_path / "trace.json"))
    ev = [e for e in doc["traceEvents"] if e["name"] == "stream.gather"]
    assert ev and ev[0]["ph"] == "X" and ev[0]["args"] == {"round": 3}
    _, events, _ = jtel.load_jsonl(str(tmp_path / "events.jsonl"))
    assert events[0]["event"] == "supervisor.rollback"
    assert ttel.get_active() is None


def test_span_buffer_bound_counts_drops():
    rec = ttel.SpanRecorder(max_events=2)
    for _ in range(5):
        with rec.span("s"):
            pass
    assert len(rec) == 2 and rec.dropped == 3


def test_off_level_and_a_bad_level(tmp_path):
    tel = ttel.Telemetry(str(tmp_path / "off"), level="off").install()
    tel.round_row(ROW)
    tel.health_update("running", round_idx=1)
    tel.close()
    assert not os.path.exists(tmp_path / "off")
    with pytest.raises(ValueError, match="telemetry level"):
        ttel.Telemetry(str(tmp_path), level="loud")


def test_health_file_validates_throttles_and_reads_back(tmp_path):
    clock = [0.0]
    hf = ttel.HealthFile(str(tmp_path / "health.json"),
                         clock=lambda: clock[0], min_interval_s=1.0)
    hf.update("running", round_idx=1)
    jtel.validate_health(jtel.read_health(str(tmp_path)))
    clock[0] = 0.5
    hf.update("running", round_idx=2)  # throttled: same intent
    assert hf.throttled == 1 and ttel.read_health(str(tmp_path))["round"] == 1
    hf.update("drain", round_idx=2)  # an intent change always writes
    doc = ttel.read_health(str(tmp_path))
    assert doc["intent"] == "drain" and doc["round"] == 2
    assert ttel.read_health(str(tmp_path / "missing")) is None
    with open(tmp_path / "bad.json", "w") as f:
        json.dump(dict(doc, schema="other/v9"), f)
    with pytest.raises(ValueError, match="health schema"):
        ttel.read_health(str(tmp_path / "bad.json"))
    with pytest.raises(ValueError, match="unknown health intent"):
        ttel.validate_health(dict(doc, intent="dancing"))


def test_health_write_error_counted_not_raised(tmp_path):
    hf = ttel.HealthFile(str(tmp_path / "no" / "dir" / "health.json"),
                         min_interval_s=0.0)
    hf.update("running", round_idx=1)
    assert hf.write_errors == 1 and not hf.degraded
