"""The kill drill on the CPU, mirroring the JAX package's
``test_kill_drill.py``: ``python -m fedtorch_tpu_torch.cli`` on a small
``mlp`` under the port's ``ElasticRunner``
(``fedtorch_tpu_torch/tools/kill_drill.py``), SIGTERM after round 2 (its
train line of round index 1), a drained checkpoint and exit 75, the
relaunch with ``--resume``, and the run to the end: exit codes ``[75,
0]``, and every round's keep — server params, optimizer state, round,
generator state and all client tensors — bitwise (sha256, tolerance 0)
the uninterrupted run's, with sync and with ``--async_checkpoint``
writes, on the device and the stream plane. The uninterrupted run is a
process of its own as well (torch's thread count orders the CPU's float
sums). Each child has a timeout and the drill closes every thread it
starts.
"""
import subprocess
import sys
import threading

import pytest

import torch_threads  # noqa: F401 (two torch threads a worker)
from fedtorch_tpu_torch.telemetry import (
    count_restarts, load_jsonl, read_health, stitch_rows,
)
from fedtorch_tpu_torch.tools.kill_drill import kill_drill
from torch_lifecycle import child_env, cli_argv, keep_digests

ROUNDS = 6
WORDS = ["--backend", "cpu", "--save_all_models", "true",
         "--checkpoint_keep_last_n", "0"]


@pytest.mark.parametrize("extra", [
    [], ["--async_checkpoint"], ["--data_plane", "stream"]],
    ids=["sync", "async", "stream"])
def test_kill_drill_stitches_a_bitwise_trajectory(extra, tmp_path):
    words = WORDS + extra + ["--debug", "true"]
    cli = [sys.executable, "-m", "fedtorch_tpu_torch.cli"]
    # the reference in a process of its own too: the same torch thread
    # count sums the same floats in the same order
    ref = subprocess.run(
        cli + cli_argv(tmp_path / "ref", rounds=ROUNDS, extra=words),
        env=child_env(), capture_output=True, text=True, timeout=240)
    assert ref.returncode == 0, ref.stdout[-2000:] + ref.stderr[-2000:]
    want = keep_digests(tmp_path / "ref")
    assert sorted(want) == list(range(1, ROUNDS + 1))

    run = tmp_path / "drill"
    cmd = cli + cli_argv(run, rounds=ROUNDS, extra=words)
    before = set(threading.enumerate())
    out = kill_drill(cmd, str(run), kill_after=1, timeout_s=240,
                     env=child_env())
    assert out["rcs"] == [75, 0], out["harness_log"]
    assert out["rc"] == 0 and out["killed_after"] == 1
    assert any("--resume" in ln and "launch #2" in ln
               for ln in out["harness_log"])
    assert any("preemption: stop requested (SIGTERM)" in ln
               for ln in out["outputs"][0])
    assert keep_digests(run) == want
    _, rows, _ = load_jsonl(str(run / "metrics.jsonl"))
    assert count_restarts(rows) == 1
    assert [r["round"] for r in stitch_rows(rows)] == list(range(ROUNDS))
    assert read_health(str(run))["intent"] == "complete"
    assert not [t for t in set(threading.enumerate()) - before
                if t.is_alive()]
