"""The port's cost capture (``fedtorch_tpu_torch/telemetry/costs.py``) and
the CLI's device gauges, on the CPU.

* ResNet-20's training-step FLOPs from ``torch.utils.flop_counter`` are
  held to the JAX package's analytic count (``analytic_train_flops_per_
  image("resnet20")`` x batch) within 1%: the counter sees every
  convolution and matmul of the forward and the backward, less the first
  convolution's input gradient, which no step computes (0.33% of the
  step). The JAX package's ``train_step_flops`` (XLA's cost analysis on
  the CPU) is checked beside it: XLA counts every elementwise operation
  too (the norms, the activations, the residual adds, the loss), which
  the counter leaves out, so its count is larger, by 26.5% at batch 2.
* The count leaves the live params, client state and every generator
  state bitwise unchanged.
* ``program_costs.json`` validates with both packages' validators, and
  both packages' ``critical_path`` read it to the same numbers.
* The CLI, telemetry on: the rows carry the MFU trio and leave out the
  CUDA memory pair (the JAX "graceful None" rule; the same fields as
  the JAX CLI's rows is ``test_torch_telemetry.py``'s
  ``test_rows_match_the_jax_cli_s``); ``--cost_capture_scan_rounds 2``
  writes a ``rounds_scan[2]`` entry; a resumed run adopts the capture; a
  failed capture turns the gauges off and not the run.
"""
import hashlib
import json

import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401 (two torch threads a worker)
from fedtorch_tpu import telemetry as jtel
from fedtorch_tpu.telemetry import costs as jcosts
from fedtorch_tpu.telemetry import critical_path as jcp
from fedtorch_tpu_torch import cli as tcli
from fedtorch_tpu_torch import config as tcfg
from fedtorch_tpu_torch.algorithms import make_algorithm
from fedtorch_tpu_torch.data.batching import stack_partitions
from fedtorch_tpu_torch.models import define_model
from fedtorch_tpu_torch.parallel import FederatedTrainer
from fedtorch_tpu_torch.telemetry import costs as tcosts
from fedtorch_tpu_torch.telemetry import critical_path as tcp
from torch_lifecycle import cli_argv, state_digest

# the CUDA allocator's pair: no meaning on the CPU, absent from its rows
CUDA_GAUGES = {"hbm_program_peak_bytes", "hbm_live_bytes"}
MFU_GAUGES = {"model_flops_utilization", "round_device_min_s",
              "round_host_frac"}
FLOP_TOL = 0.01


def _cfg(mod, arch, batch):
    return mod.ExperimentConfig(
        data=mod.DataConfig(dataset="cifar10", batch_size=batch,
                            augment=False),
        federated=mod.FederatedConfig(
            federated=True, num_clients=4, online_client_rate=0.5,
            sync_type="local_step", quantized=True),
        model=mod.ModelConfig(arch=arch), optim=mod.OptimConfig(lr=0.1),
        train=mod.TrainConfig(local_step=2)).finalize()


def test_resnet20_step_flops_match_the_analytic_count():
    from fedtorch_tpu import config as jcfg
    from fedtorch_tpu.models import define_model as jdefine
    B = 2
    cfg = _cfg(tcfg, "resnet20", B)
    model = define_model(cfg, batch_size=B, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    rng = np.random.RandomState(0)
    bx = torch.from_numpy(rng.randn(B, 32, 32, 3).astype(np.float32))
    by = torch.from_numpy(rng.randint(0, 10, B))
    got = tcosts.train_step_flops(model, params, bx, by)
    want = jcosts.analytic_train_flops_per_image("resnet20") * B
    assert tcosts.analytic_train_flops_per_image("resnet20") * B == want
    assert got["flash_kernel"] == 0.0
    assert abs(got["counted"] / want - 1) <= FLOP_TOL, got
    xla = jcosts.train_step_flops(jdefine(_cfg(jcfg, "resnet20", B),
                                          batch_size=B), B)
    assert xla is not None and 1.2 < xla / got["counted"] < 1.35, \
        (xla, got["counted"])


def test_the_flash_forward_is_counted_from_the_model_s_shapes():
    """The hand kernel is no aten op, so its forward is counted from the
    transformer's shapes (each layer's causal attention, ``fwd_ops``)
    where the batch lies on a card and attention takes the flash route;
    on the CPU the plain version's matmuls are counted instead (0)."""
    from types import SimpleNamespace

    from fedtorch_tpu_torch.ops.cuda.flash_attention import fwd_ops

    def cfg(attention):
        return tcfg.ExperimentConfig(
            data=tcfg.DataConfig(dataset="shakespeare"),
            model=tcfg.ModelConfig(arch="transformer", rnn_hidden_size=32,
                                   mlp_num_layers=3, rnn_seq_len=16,
                                   vocab_size=11, attention=attention),
            mesh=tcfg.MeshConfig(compute_dtype="bfloat16")).finalize()
    flash = define_model(cfg("flash"), batch_size=2, device="cpu")
    on_card = SimpleNamespace(device=torch.device("cuda"), shape=(2, 16))
    m = flash.module
    d, H = m.pos_embed.shape[1], m.num_heads
    assert m.num_layers == 3 and d % H == 0
    assert tcosts.flash_kernel_ops(flash, on_card) == \
        3 * fwd_ops(2, 16, H, d // H, True)
    assert fwd_ops(8, 2048, 4, 64, True) == pytest.approx(17.2e9, rel=1e-3)
    assert tcosts.flash_kernel_ops(flash, torch.zeros(2, 16)) == 0.0
    dense = define_model(cfg("dense"), batch_size=2, device="cpu")
    assert tcosts.flash_kernel_ops(dense, on_card) == 0.0
    resnet = define_model(_cfg(tcfg, "resnet8", 2), batch_size=2,
                          device="cpu")
    assert tcosts.flash_kernel_ops(resnet, on_card) == 0.0


def _small_trainer():
    cfg = _cfg(tcfg, "resnet8", 4)
    rng = np.random.RandomState(0)
    x = rng.randn(16, 32, 32, 3).astype(np.float32)
    y = rng.randint(0, 10, 16)
    parts = [np.arange(i * 4, i * 4 + 4) for i in range(4)]
    return FederatedTrainer(cfg, define_model(cfg, batch_size=4,
                                              device="cpu"),
                            make_algorithm(cfg),
                            stack_partitions(x, y, parts), device="cpu")


def _generators(server):
    return hashlib.sha256(torch.get_rng_state().numpy().tobytes()
                          + server.rng.get_state().numpy().tobytes()
                          ).hexdigest()


def test_the_count_leaves_every_state_bitwise(tmp_path):
    trainer = _small_trainer()
    server, clients = trainer.init_state(0)
    server, clients, _ = trainer.run_round(server, clients)
    before = (state_digest(server, clients), _generators(server))
    bx = trainer.data.x[0, :4]
    by = trainer.data.y[0, :4]
    counted = tcosts.round_flops(trainer, server.params, bx, by)
    assert (state_digest(server, clients), _generators(server)) == before
    n = sum(v.numel() for v in server.params.values())
    assert counted["steps"] == 2 * 2
    assert counted["quantizer"] == tcosts.QDQ_OPS_PER_ELEM * 3 * n
    assert counted["round"] == counted["steps"] * counted["step_counted"] \
        + counted["quantizer"]
    cap = tcosts.ProgramCostCapture(
        str(tmp_path), compute_dtype="float32", arch="resnet8",
        batch_size=4, local_steps=2, k_online=2, backend="cpu",
        scan_rounds=3, run_meta={"algorithm": "fedavg"})
    doc = cap.capture(counted, None)
    jcosts.validate_program_costs(doc)
    assert tcosts.read_program_costs(str(tmp_path)) == doc
    assert doc["programs"]["rounds_scan[3]"]["flops"] == 3 * counted["round"]
    rows = [{"round": r, "round_s": 0.5, "fetch_s": 0.01, "eval_s": 0.0,
             "checkpoint_s": 0.0} for r in range(3)]
    assert tcp.device_floor_s(doc) == jcp.device_floor_s(doc) == \
        counted["round"] / 67e12
    assert tcp.round_wall_decomposition(rows, doc) == \
        jcp.round_wall_decomposition(rows, doc)
    gauges = cap.round_gauges(0.5)
    assert set(gauges) == MFU_GAUGES
    assert gauges["model_flops_utilization"] == pytest.approx(
        counted["round"] / (0.5 * 67e12))


def test_the_peak_is_the_h100_s_by_compute_dtype(monkeypatch):
    monkeypatch.delenv("BENCH_PEAK_TFLOPS", raising=False)
    name = "NVIDIA H100 80GB HBM3"
    assert tcosts.resolve_peak_tflops("bfloat16", name) == (
        989.0, "default:h100:bfloat16")
    assert tcosts.resolve_peak_tflops("float32", name) == (
        67.0, "default:h100:float32")
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        assert tcosts.resolve_peak_tflops("float32", name)[0] == 495.0
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    assert tcosts.resolve_peak_tflops("bfloat16", "NVIDIA A100")[0] is None
    peak, src = tcosts.resolve_peak_tflops("bfloat16")
    assert peak == 989.0 and "no card" in src
    # a round's flash forward at its kernel's rate: float32's 3xTF32
    # products at 495 / 3, the rest at the float32 peak
    counted = {"step_flash_kernel": 1e9, "steps": 10.0, "round": 1e11}
    peak, src = tcosts.round_peak_tflops(counted, "float32", name)
    assert peak == pytest.approx(1e11 / (9e10 / 67.0 + 1e10 / 165.0))
    assert 67.0 < peak < 165.0 and "flash forward at 165" in src
    assert tcosts.round_peak_tflops(counted, "bfloat16", name)[0] == \
        pytest.approx(989.0)
    assert tcosts.round_peak_tflops(dict(counted, step_flash_kernel=0.0),
                                    "float32", name) == (
        67.0, "default:h100:float32")
    monkeypatch.setenv("BENCH_PEAK_TFLOPS", "123")
    assert tcosts.resolve_peak_tflops("bfloat16", name) == (
        123.0, "env:BENCH_PEAK_TFLOPS")
    assert tcosts.round_peak_tflops(counted, "float32", name)[0] == 123.0
    assert set(tcosts.PROGRAM_FIELDS) == set(jcosts.PROGRAM_FIELDS)
    assert tcosts.PROGRAM_COSTS_SCHEMA == jcosts.PROGRAM_COSTS_SCHEMA


def _rows(run):
    _, rows, _ = jtel.load_jsonl(str(run / "metrics.jsonl"))
    return rows


def _events(run):
    _, events, _ = jtel.load_jsonl(str(run / "events.jsonl"))
    return events


def test_the_cli_rows_carry_the_gauges_and_a_resume_adopts(tmp_path):
    """The rows against the JAX CLI's (the same fields but the CUDA
    memory pair) are ``test_torch_telemetry.py``'s
    ``test_rows_match_the_jax_cli_s``; here the port's run alone."""
    port = tmp_path / "port"
    tcli.main(cli_argv(port, rounds=2, extra=[
        "--backend", "cpu", "--cost_capture_scan_rounds", "2"]))
    rows = _rows(port)
    assert len(rows) == 2
    for t in rows:
        assert MFU_GAUGES <= set(t) and not CUDA_GAUGES & set(t)
        jtel.validate_metrics_row(t)
    doc = json.load(open(port / "program_costs.json"))
    jcosts.validate_program_costs(doc)
    assert set(doc["programs"]) == {"round", "rounds_scan[2]"}
    assert doc["programs"]["rounds_scan[2]"]["flops"] == \
        2 * doc["programs"]["round"]["flops"]
    assert doc["backend"] == "cpu" and doc["run"]["card"] is None
    assert doc["programs"]["round"]["peak_hbm_bytes"] is None
    assert [e["ok"] for e in _events(port)
            if e["event"] == "cost.capture"] == [True]
    # a resumed run adopts the capture and goes on with the gauges
    tcli.main(cli_argv(port, rounds=3, extra=[
        "--backend", "cpu", "--resume", str(port)]))
    assert json.load(open(port / "program_costs.json")) == doc
    assert "adopted existing program_costs.json" in open(
        port / "record0").read()
    assert MFU_GAUGES <= set(_rows(port)[-1])
    assert [e["ok"] for e in _events(port)
            if e["event"] == "cost.capture"] == [True]


def test_a_failed_capture_turns_the_gauges_off_not_the_run(tmp_path,
                                                           monkeypatch):
    def broken(*a, **kw):
        raise RuntimeError("no count")
    monkeypatch.setattr(tcosts, "round_flops", broken)
    res = tcli.main(cli_argv(tmp_path / "run", rounds=2, extra=[
        "--backend", "cpu"]))
    assert res["rounds"] == 2
    assert not (tmp_path / "run" / "program_costs.json").exists()
    assert not [r for r in _rows(tmp_path / "run")
                if MFU_GAUGES & set(r)]
    assert [e["ok"] for e in _events(tmp_path / "run")
            if e["event"] == "cost.capture"] == [False]
    assert "counting failed (no count)" in open(
        tmp_path / "run" / "record0").read()
