"""``fedtorch_tpu_torch.tools.order_spread`` on the CPU: the helpers
``chip_smoke.py``'s card-vs-CPU rounds use, and the scan itself at a
small width.

At ResNet-8 the round has few ReLU inputs, so whether one or two of
them flip sets the gap between two float32 orders: at seed 2 every
order measured lands within about 1.09 int8 downlink steps, at other
seeds up to 24 (``--arch resnet8 --seeds 0-63``, recorded as
``RESNET8_MAX_GAP``).
"""
import json

import torch

import torch_threads  # noqa: F401 (two torch threads a worker)
from fedtorch_tpu_torch.tools import order_spread as os_mod


def test_update_gap_counts_downlink_steps():
    a = {"w": torch.tensor([0.0, 2.55, 1.0]), "b": torch.tensor([1.0, 1.0])}
    assert os_mod.update_gap(a, a) == (0.0, 0.0)
    b = {"w": a["w"] + torch.tensor([0.0, 0.0, 0.03]), "b": a["b"]}
    steps, l2 = os_mod.update_gap(a, b)
    assert abs(steps - 3.0) < 1e-4   # 0.03 in steps of 2.55 / 255
    assert abs(l2 - 0.03 / float(torch.cat([a["w"], a["b"]]).norm())) < 1e-6


def test_orders_agree_at_resnet8_and_threads_are_restored():
    cfg = os_mod.small_round_cfg("resnet8")
    threads = torch.get_num_threads()
    ref, p0 = os_mod.run_round(cfg, 2, "cpu")
    ups = {o: os_mod.run_round(cfg, 2, o)[0] for o in os_mod.SPREAD_ORDERS}
    assert torch.get_num_threads() == threads
    assert set(ref) == set(p0) and any(bool(u.abs().max() > 0)
                                       for u in ref.values())
    steps, _ = os_mod.spread(ref, ups)
    assert steps <= 2.0


def test_scan_prints_a_line_per_seed_and_the_ratio(monkeypatch, capsys):
    monkeypatch.setattr(os_mod, "WIDEN", 1)
    assert os_mod.main(["--seeds", "0-0"]) == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert lines[0]["seed"] == 0
    assert set(lines[0]["gaps"]) == set(os_mod.SPREAD_ORDERS
                                        + os_mod.HELD_OUT_ORDERS)
    assert lines[-1]["spread_factor"] == os_mod.SPREAD_FACTOR
    assert lines[-1]["max_held_out_ratio_steps"] >= 0.0


def test_scan_takes_the_resnet8_round(capsys):
    assert os_mod.round_cfg("resnet8").model.arch == "resnet8"
    assert os_mod.main(["--arch", "resnet8", "--seeds", "2-2"]) == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert [x["seed"] for x in lines[:-1]] == [2]
    last = lines[-1]
    assert last["arch"] == "resnet8" and last["max_card_gap"] is None
    worst = max(g[0] for g in lines[0]["gaps"].values())
    assert last["max_cpu_gap"][0] == worst
    assert all(g > 0 for g in os_mod.RESNET8_MAX_GAP)
