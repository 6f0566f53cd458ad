"""The port's CLI with the federation plane's observers and the async
commit plane, on the CPU: ``--sync_mode async --cohort_stats true`` with
telemetry on, held to the JAX package's readers and CLI.

* The run directory: ``client_ledger.json`` (participation summing to
  m x commits, the per-job staleness), the rows with the cohort gauges,
  the ledger's and the async plane's, the staleness histogram and the
  anomaly summary in the events; every row passes the JAX package's
  validator, and ``python -m fedtorch_tpu.cli report`` reads the
  directory, its Federation section included.
* The JAX CLI on the same flags writes rows of the same keys (but its
  XLA cost gauges) and a ledger of the same geometry.
* The kill drill on the commit plane: exit codes ``[75, 0]``, every
  commit's keep bitwise the uninterrupted run's, the ledger adopted by
  the resumed child.
* The stream plane's rows carry ``overlap_efficiency`` in [0, 1].
"""
import json
import os
import subprocess
import sys
import threading

import pytest

import torch_threads  # noqa: F401 (two torch threads a worker)
from fedtorch_tpu import telemetry as jtel
from fedtorch_tpu_torch import cli as tcli
from fedtorch_tpu_torch.tools.kill_drill import kill_drill
from torch_lifecycle import REPO, child_env, cli_argv, keep_digests

COMMITS = 4
ASYNC = ["--sync_mode", "async", "--cohort_stats", "true",
         "--fault_straggler_rate", "0.4",
         "--fault_straggler_step_frac", "0.1"]
# the device gauges with no meaning on the CPU: the CUDA allocator's
# memory pair (absent from a CPU row, the JAX "graceful None" rule); the
# MFU trio rides both packages' rows (telemetry/costs.py)
COST_GAUGES = {"hbm_program_peak_bytes", "hbm_live_bytes"}


def _events(run):
    _, events, _ = jtel.load_jsonl(str(run / "events.jsonl"))
    return events


@pytest.fixture(scope="module")
def async_run(tmp_path_factory):
    run = tmp_path_factory.mktemp("port") / "run"
    res = tcli.main(cli_argv(run, rounds=COMMITS,
                             extra=["--backend", "cpu"] + ASYNC))
    return run, res


def test_the_run_directory_holds_the_ledger_and_the_async_record(
        async_run):
    run, res = async_run
    assert res["rounds"] == COMMITS
    doc = json.load(open(run / "client_ledger.json"))
    assert doc["mode"] == "dense" and doc["rounds"] == COMMITS
    # k_online = 3 of 6: concurrency 3, buffer m = 1
    m = 1
    assert sum(doc["counters"]["participation"]) == m * COMMITS
    assert doc["run"]["sync_mode"] == "async"
    _, rows, torn = jtel.load_jsonl(str(run / "metrics.jsonl"))
    assert torn == 0 and [r["round"] for r in rows] == list(range(COMMITS))
    for row in rows:
        jtel.validate_metrics_row(row)
        for key in ("cohort_dispersion", "cohort_norm_med",
                    "ledger_tracked", "async_dispatches",
                    "async_buffer", "staleness"):
            assert key in row, key
        assert row["async_buffer"] == m
    assert sum(doc["counters"]["staleness"]) == pytest.approx(
        sum(r["staleness"] * m for r in rows))
    events = _events(run)
    hist = [e for e in events if e["event"] == "async.staleness_hist"]
    assert hist and hist[-1]["snapshot"] == "final"
    assert sum(hist[-1]["hist"].values()) == m * COMMITS
    summary = next(e for e in events if e["event"] == "anomaly.summary")
    assert summary["fields"]["loss"]["observations"] == COMMITS


def test_the_jax_package_s_report_reads_the_federation_section(async_run):
    run, _ = async_run
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    r = subprocess.run([sys.executable, "-m", "fedtorch_tpu.cli", "report",
                        str(run)], cwd=REPO, env=env, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    out = r.stdout
    assert "federation plane" in out and "ledger: dense mode" in out
    assert "staleness histogram" in out and "async_dispatches" in out


def test_rows_and_ledger_match_the_jax_cli_s(async_run, tmp_path):
    from fedtorch_tpu import cli as jcli
    run, _ = async_run
    jcli.main(cli_argv(tmp_path / "jax", rounds=COMMITS, extra=ASYNC))
    _, jrows, _ = jtel.load_jsonl(str(tmp_path / "jax" / "metrics.jsonl"))
    _, trows, _ = jtel.load_jsonl(str(run / "metrics.jsonl"))
    assert len(jrows) == len(trows) == COMMITS
    for j, t in zip(jrows, trows):
        assert set(j) - COST_GAUGES == set(t)
        for key in ("round", "n_online", "comm_bytes", "async_buffer"):
            assert t[key] == j[key], key
    jdoc = json.load(open(tmp_path / "jax" / "client_ledger.json"))
    tdoc = json.load(open(run / "client_ledger.json"))
    for key in ("schema", "num_clients", "mode", "rounds",
                "sketch_budget", "seed"):
        assert tdoc[key] == jdoc[key], key
    assert sum(tdoc["counters"]["participation"]) == \
        sum(jdoc["counters"]["participation"])


def test_the_kill_drill_on_the_commit_plane(tmp_path):
    words = ["--backend", "cpu", "--save_all_models", "true",
             "--checkpoint_keep_last_n", "0", "--debug", "true"] + ASYNC
    cli = [sys.executable, "-m", "fedtorch_tpu_torch.cli"]
    rounds = 5
    ref = subprocess.run(
        cli + cli_argv(tmp_path / "ref", rounds=rounds, extra=words),
        env=child_env(), capture_output=True, text=True, timeout=240)
    assert ref.returncode == 0, ref.stdout[-2000:] + ref.stderr[-2000:]
    want = keep_digests(tmp_path / "ref")
    assert sorted(want) == list(range(1, rounds + 1))
    run = tmp_path / "drill"
    before = set(threading.enumerate())
    out = kill_drill(cli + cli_argv(run, rounds=rounds, extra=words),
                     str(run), kill_after=1, timeout_s=240,
                     env=child_env())
    assert out["rcs"] == [75, 0], out["harness_log"]
    assert keep_digests(run) == want
    assert any("client ledger: adopted existing" in ln
               for ln in out["outputs"][1])
    doc = json.load(open(run / "client_ledger.json"))
    assert doc["rounds"] == rounds
    assert doc == {**json.load(open(tmp_path / "ref"
                                    / "client_ledger.json")),
                   "created_unix": doc["created_unix"],
                   "updated_unix": doc["updated_unix"]}
    drains = [e for e in _events(run) if e["event"] ==
              "async.staleness_hist" and e["snapshot"] == "drain"]
    assert len(drains) == 1
    assert not [t for t in set(threading.enumerate()) - before
                if t.is_alive()]


@pytest.mark.parametrize("extra", [[], ASYNC], ids=["sync", "async"])
def test_stream_rows_carry_the_overlap_efficiency(extra, tmp_path):
    run = tmp_path / "run"
    tcli.main(cli_argv(run, rounds=3, extra=[
        "--backend", "cpu", "--data_plane", "stream"] + extra))
    _, rows, _ = jtel.load_jsonl(str(run / "metrics.jsonl"))
    effs = [r.get("overlap_efficiency") for r in rows]
    assert effs[0] is None  # no delta before the second row
    assert [e for e in effs[1:] if e is not None]
    assert all(0.0 <= e <= 1.0 for e in effs if e is not None)
