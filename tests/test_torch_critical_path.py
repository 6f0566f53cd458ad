"""The round-wall critical path in the port against the JAX package's
(the twin of the overlap and decomposition cases of
``tests/test_ops_plane.py``), on the CPU: the same rows and gauges give
the same numbers, exactly (both sides run the same float arithmetic).
"""
import json
import os

import pytest

import torch_threads  # noqa: F401 (two torch threads a worker)
from fedtorch_tpu.telemetry import critical_path as jcp
from fedtorch_tpu.telemetry.schema import load_jsonl, stitch_rows
from fedtorch_tpu_torch.telemetry import critical_path as tcp

FIXROOT = os.path.join(os.path.dirname(__file__), "data", "ops_runs")


def _row(g, h, w, **extra):
    return {"stream_gather_s": g, "stream_h2d_s": h, "stream_wait_s": w,
            **extra}


@pytest.mark.parametrize("gather, h2d, wait", [
    (1.0, 0.5, 0.0), (1.0, 0.0, 1.0), (1.0, 0.0, 5.0), (1.0, 1.0, 0.5),
    (0.0, 0.0, 0.0), (0.0, 0.0, 1.0), (1.0, 0.0, -3.0),
    (0.0063, 0.0107, 0.00019)])
def test_overlap_efficiency_is_the_jax_function_s(gather, h2d, wait):
    assert tcp.overlap_efficiency(gather, h2d, wait) == \
        jcp.overlap_efficiency(gather, h2d, wait)


ROW_SEQUENCES = {
    "deltas": [_row(1.0, 0.5, 0.1), _row(2.0, 1.0, 0.4)],
    "reset": [_row(5.0, 1.0, 1.0), _row(0.5, 0.1, 0.0),
              _row(1.5, 0.1, 0.0)],
    "non_stream": [{"round": 0, "loss": 1.0}, {"round": 1}],
    "emitted": [_row(1.0, 0.0, 0.0),
                _row(2.0, 0.0, 0.5, overlap_efficiency=0.123)],
    "restart": [_row(1.0, 0.5, 0.1, round=0, round_s=0.1),
                _row(2.0, 1.0, 0.2, round=1, round_s=0.2),
                _row(0.5, 0.25, 0.05, round=2, round_s=0.1),
                _row(1.5, 0.75, 0.15, round=3, round_s=0.3,
                     fetch_s=0.01, eval_s=0.02, checkpoint_s=0.03)],
}


@pytest.mark.parametrize("name", sorted(ROW_SEQUENCES))
def test_tracker_replay_summary_and_decomposition(name):
    rows = ROW_SEQUENCES[name]
    jt, tt = jcp.StreamOverlapTracker(), tcp.StreamOverlapTracker()
    assert [tt.observe(r) for r in rows] == [jt.observe(r) for r in rows]
    assert tcp.replay_overlap(rows) == jcp.replay_overlap(rows)
    assert tcp.overlap_summary(rows) == jcp.overlap_summary(rows)
    assert tcp.round_wall_decomposition(rows) == \
        jcp.round_wall_decomposition(rows)
    for key in ("stream_gather_s", "stream_wait_s", "missing"):
        assert tcp._counter_total(rows, key) == \
            jcp._counter_total(rows, key)


@pytest.mark.parametrize("run", ["clean", "torn", "restart", "regressed"])
def test_the_fixture_runs_give_the_jax_numbers(run):
    d = os.path.join(FIXROOT, run)
    _, records, _ = load_jsonl(os.path.join(d, "metrics.jsonl"))
    rows = stitch_rows(records)
    costs = None
    if os.path.exists(os.path.join(d, "program_costs.json")):
        with open(os.path.join(d, "program_costs.json")) as f:
            costs = json.load(f)
    assert tcp.overlap_summary(rows) == jcp.overlap_summary(rows)
    assert tcp.device_floor_s(costs) == jcp.device_floor_s(costs)
    assert tcp.round_wall_decomposition(rows, costs) == \
        jcp.round_wall_decomposition(rows, costs)


def test_without_program_costs_the_decomposition_has_no_device_floor():
    """Without a ``program_costs.json`` (a run with telemetry off, or a
    failed capture) the decomposition holds the host phases only, as the
    JAX function's does without costs."""
    rows = ROW_SEQUENCES["restart"]
    dec = tcp.round_wall_decomposition(rows, None)
    assert dec == jcp.round_wall_decomposition(rows, None)
    assert "device_floor_s" not in dec and dec["rounds"] == 3
    for doc in (None, {}, {"programs": {}, "primary": "x"},
                {"programs": {"x": {"flops": 1e9}}, "primary": "x"}):
        assert tcp.device_floor_s(doc) is None
    assert tcp.round_wall_decomposition([]) is None
