"""The port's trace attribution (``fedtorch_tpu_torch/tools/
trace_attrib.py``) against the JAX package's, on the CPU.

* The JAX tests' synthetic event lists (``tests/test_device_observability
  .py``) and its fixture capture give equal attribution through both
  tools (exactly: the same arithmetic on the same numbers), and every
  XLA op name of its category table gets the same category.
* A table of CUDA kernel and torch op names checks each one's category;
  the hand kernels get their rows; the >= 95% invariant fires on a trace
  dominated by unknown names.
* A CPU ``capture_round_trace`` of a small round writes a trace that
  attributes at >= 95%, inside a ``profiler.capture`` span that carries
  its ``log_dir``.
* The in-memory entry (a card window's per-name sums) agrees with the
  file entry on the same CUDA records.
"""
import ast
import json
import os

import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401 (two torch threads a worker)
from fedtorch_tpu.tools import trace_attrib as jta
from fedtorch_tpu_torch import config as tcfg
from fedtorch_tpu_torch import telemetry as ttel
from fedtorch_tpu_torch.algorithms import make_algorithm
from fedtorch_tpu_torch.data.batching import stack_partitions
from fedtorch_tpu_torch.models import define_model
from fedtorch_tpu_torch.parallel import FederatedTrainer
from fedtorch_tpu_torch.tools import trace_attrib as tta
from fedtorch_tpu_torch.utils.tracing import (
    capture_round_trace, profile_window,
)
from torch_lifecycle import REPO

JAX_CASES = os.path.join(REPO, "tests", "test_device_observability.py")
FIXTURE_DIR = os.path.join(REPO, "tests", "data", "device_attrib")


def _jax_event_lists():
    """The ``evs = [...]`` literals of the JAX attribution tests."""
    out = []
    for node in ast.walk(ast.parse(open(JAX_CASES).read())):
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name) \
                and node.targets[0].id == "evs":
            # literals and arithmetic on them (``5e6 + 410``)
            out.append((node.lineno, eval(compile(
                ast.Expression(node.value), JAX_CASES, "eval"),
                {"__builtins__": {}})))
    return out


def _jax_category_names():
    """The (name, category) table of the JAX ``test_category_rules``."""
    for node in ast.walk(ast.parse(open(JAX_CASES).read())):
        if isinstance(node, ast.FunctionDef) \
                and node.name == "test_category_rules":
            for dec in node.decorator_list:
                return ast.literal_eval(dec.args[1])
    raise AssertionError("no category table")


EVENT_LISTS = _jax_event_lists()
_DOC_KEYS = ("cat_us", "cat_events", "op_us", "op_cat", "op_events",
             "span_us", "busy_us", "idle_us", "lanes", "events")


@pytest.mark.parametrize("line, evs", EVENT_LISTS,
                         ids=[f"line{n}" for n, _ in EVENT_LISTS])
def test_jax_event_lists_attribute_equally(line, evs, tmp_path):
    got, want = tta.attribute_events(evs), jta.attribute_events(evs)
    assert {k: got[k] for k in _DOC_KEYS} == {k: want[k] for k in _DOC_KEYS}
    p = tmp_path / "x.trace.json"
    p.write_text(json.dumps({"traceEvents": evs}))
    got, want = tta.attribute(str(p)), jta.attribute(str(p))
    for key in ("categories", "attributed_frac", "attributed_ok",
                "top_ops", "total_us", "device_events", "device_lanes"):
        assert got[key] == want[key], key


def test_the_jax_fixture_capture_attributes_equally():
    got, want = tta.attribute(FIXTURE_DIR), jta.attribute(FIXTURE_DIR)
    assert len(EVENT_LISTS) >= 4
    for key in ("categories", "attributed_frac", "attributed_ok", "top_ops",
                "total_us", "span_us", "busy_us", "device_events",
                "device_lanes", "trace_files"):
        assert got[key] == want[key], key
    assert got["hand_kernels"] == {}


@pytest.mark.parametrize("name, row", [
    ("void (anonymous namespace)::flash_fwd_tc_kernel<256>(CUtensorMap)",
     "flash_fwd_tc"),
    ("void (anonymous namespace)::flash_fwd_tf32_kernel<float, 256>("
     "float const*)", "flash_fwd_tf32"),
    ("void (anonymous namespace)::v_last_nonfinite_kernel<float>("
     "float const*)", "flash_prepass")])
def test_the_head_dim_256_instances_take_their_kernels_rows(name, row):
    """The instances past head dim 128 land in their kernel's row (and so
    in PERF.md's F column, or E for the pre-pass)."""
    assert tta.hand_kernel(name) == row


@pytest.mark.parametrize("name, cat", _jax_category_names())
def test_every_xla_name_gets_the_jax_category(name, cat):
    assert tta.categorize(name) == jta.categorize(name) == cat


@pytest.mark.parametrize("name, cat", [
    ("void flash_fwd_tc_kernel<64>(CUtensorMap, CUtensorMap, CUtensorMap, "
     "__nv_bfloat16*, float*, int const*, int, int, float, int)",
     "matmul_conv_mxu"),
    ("void flash_fwd_tf32_kernel<float, 64>(float const*, float const*)",
     "matmul_conv_mxu"),
    ("void (anonymous namespace)::flash_fwd_tc_kernel<256>(CUtensorMap, "
     "CUtensorMap, CUtensorMap, __nv_bfloat16*, float*, int const*, int, "
     "int, float, int)", "matmul_conv_mxu"),
    ("void (anonymous namespace)::flash_fwd_tf32_kernel<__nv_bfloat16, "
     "256>(__nv_bfloat16 const*)", "matmul_conv_mxu"),
    ("void qdq_ragged_stats_kernel(LeafTable, float*, long)", "elementwise"),
    ("void qdq_ragged_apply_kernel(LeafTable, float const*, long, int)",
     "elementwise"),
    ("void tiled_stats_kernel(float const*, float*, long, long)",
     "elementwise"),
    ("void v_last_nonfinite_kernel(__nv_bfloat16 const*, long)",
     "elementwise"),
    ("sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64",
     "matmul_conv_mxu"),
    ("void cutlass::Kernel2<cutlass_80_wmma_tensorop_s161616gemm_bf16>"
     "(Params)", "matmul_conv_mxu"),
    ("nvjet_tst_128x64_64x8_1x1_v_bz_coopA_TNN", "matmul_conv_mxu"),
    ("void cudnn::cnn::conv2d_grouped_direct_kernel<false, true>(int)",
     "matmul_conv_mxu"),
    ("void cudnn::engines_precompiled::nchwToNhwcKernel<__nv_bfloat16>()",
     "copy_reshape_transpose"),
    ("void cudnn::bn_fw_tr_1C11_kernel_NCHW<float, float, int, 512>()",
     "reduce"),
    ("void at::native::batch_norm_collect_statistics_kernel<float>()",
     "reduce"),
    ("void at::native::(anonymous namespace)::vectorized_layer_norm_kernel"
     "<float, float>()", "reduce"),
    ("void at::native::reduce_kernel<512, 1, at::native::ReduceOp<float>>"
     "(at::native::ReduceOp<float>)", "reduce"),
    ("void (anonymous namespace)::softmax_warp_forward<float, float>()",
     "reduce"),
    ("void at::native::vectorized_elementwise_kernel<4, "
     "at::native::CUDAFunctor_add<float>>(int)", "elementwise"),
    ("void at::native::elementwise_kernel<128, 2, "
     "at::native::gpu_kernel_impl_nocast<at::native::MulFunctor<float>>>()",
     "elementwise"),
    ("void at::native::(anonymous namespace)::"
     "distribution_elementwise_grid_stride_kernel<float, 4>()",
     "elementwise"),
    ("void at::native::index_elementwise_kernel<128, 4>(long)",
     "copy_reshape_transpose"),
    ("void at::native::(anonymous namespace)::CatArrayBatchedCopy<float>()",
     "copy_reshape_transpose"),
    ("void at::native::(anonymous namespace)::indexSelectLargeIndex<float>()",
     "copy_reshape_transpose"),
    ("ncclDevKernel_AllGather_RING_LL(ncclDevKernelArgsStorage<4096ul>)",
     "collective"),
    ("Memcpy HtoD (Pageable -> Device)", "infeed_outfeed_h2d"),
    ("Memcpy DtoH (Device -> Pinned)", "infeed_outfeed_h2d"),
    ("Memcpy DtoD (Device -> Device)", "copy_reshape_transpose"),
    ("Memset (Device)", "copy_reshape_transpose"),
    ("void at::native::(anonymous namespace)::max_pool_forward_nchw<float>()",
     "reduce"),
    ("aten::convolution_backward", "matmul_conv_mxu"),
    ("aten::addmm", "matmul_conv_mxu"),
    ("aten::native_batch_norm", "reduce"),
    ("aten::copy_", "copy_reshape_transpose"),
    ("aten::add_", "elementwise"),
    ("autograd::engine::evaluate_function: AddBackward0", "control_flow"),
    ("mystery_kernel_xyz", "other"),
])
def test_cuda_and_torch_names_get_their_category(name, cat):
    assert tta.categorize(name, torch_names=True) == cat


def _kernel(name, ts, dur, stream=7):
    return {"ph": "X", "cat": "kernel", "name": name, "pid": 0,
            "tid": stream, "ts": ts, "dur": dur}


def test_hand_kernel_rows_and_the_columns(tmp_path):
    evs = [_kernel("void qdq_ragged_stats_kernel(LeafTable)", 0, 10),
           _kernel("void qdq_ragged_apply_kernel(LeafTable)", 10, 20),
           _kernel("void flash_fwd_tc_kernel<64>(CUtensorMap)", 30, 100),
           _kernel("void v_last_nonfinite_kernel(int)", 130, 5),
           _kernel("sm90_xmma_gemm_bf16", 135, 40),
           _kernel("void cudnn::bn_fw_tr_1C11_kernel_NCHW<float>()", 175, 15),
           _kernel("void at::native::vectorized_elementwise_kernel<4>()",
                   200, 10),
           {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
            "pid": 11, "tid": 11, "ts": 0, "dur": 500},
           # a capture's edge padding (utils/tracing.py): not the work
           _kernel("void at::cuda::spin_kernel(long)", 230, 1)]
    p = tmp_path / "h.trace.json"
    p.write_text(json.dumps({"traceEvents": evs}))
    doc = tta.attribute(str(p))
    assert doc["device_events"] == 7 and doc["device_lanes"] == 1
    assert doc["hand_kernels"] == {
        "flash_fwd_tc": {"ms": 0.1, "launches": 1},
        "flash_prepass": {"ms": 0.005, "launches": 1},
        "qdq_ragged_apply": {"ms": 0.02, "launches": 1},
        "qdq_ragged_stats": {"ms": 0.01, "launches": 1}}
    assert doc["categories"]["idle_gap"]["time_us"] == 10.0
    cols = tta.columns(doc)
    assert cols == pytest.approx({"F": 0.1, "Q": 0.03, "N": 0.015,
                                  "M": 0.04, "E": 0.015})
    assert doc["attributed_ok"] and "hand kernels" in tta.render(doc)
    assert tta.device_ms(doc) == pytest.approx(0.2)
    summ = tta.summary(doc, wall_ms=0.4)
    assert summ["busy_share"] == pytest.approx(0.5)
    assert summ["kernel_launches"] == 7 and summ["top_runtime_calls"] == []
    assert summ["device_ms_by_column"] == pytest.approx(cols)
    assert summ["top_kernels"][0]["name"].startswith("flash_fwd_tc")


def test_the_invariant_fires_on_a_trace_of_unknown_names(tmp_path):
    evs = [_kernel("mystery_kernel_a", 0, 90), _kernel("sm90_gemm", 90, 10)]
    p = tmp_path / "u.trace.json"
    p.write_text(json.dumps({"traceEvents": evs}))
    doc = tta.attribute(str(p))
    assert doc["attributed_frac"] == pytest.approx(0.1)
    assert not doc["attributed_ok"]
    assert doc["other_ops"][0]["name"] == "mystery_kernel_a"
    assert "BELOW" in tta.render(doc)


def _small_trainer():
    cfg = tcfg.ExperimentConfig(
        data=tcfg.DataConfig(dataset="cifar10", batch_size=4,
                             augment=False),
        federated=tcfg.FederatedConfig(
            federated=True, num_clients=4, online_client_rate=0.5,
            sync_type="local_step", quantized=True),
        model=tcfg.ModelConfig(arch="resnet8"),
        optim=tcfg.OptimConfig(lr=0.1),
        train=tcfg.TrainConfig(local_step=1)).finalize()
    rng = np.random.RandomState(0)
    x = rng.randn(16, 32, 32, 3).astype(np.float32)
    y = rng.randint(0, 10, 16)
    parts = [np.arange(i * 4, i * 4 + 4) for i in range(4)]
    return FederatedTrainer(cfg, define_model(cfg, batch_size=4,
                                              device="cpu"),
                            make_algorithm(cfg),
                            stack_partitions(x, y, parts), device="cpu")


def test_a_cpu_round_capture_attributes_and_names_its_span(tmp_path):
    trainer = _small_trainer()
    server, clients = trainer.init_state(0)
    server, clients, _ = trainer.run_round(server, clients)
    cap = str(tmp_path / "cap")
    (tmp_path / "run").mkdir()
    tel = ttel.Telemetry(str(tmp_path / "run"), level="default").install()
    try:
        server, clients, metrics = capture_round_trace(
            cap, trainer.run_round, server, clients)
    finally:
        tel.close()
    assert int(server.round) == 2 and all(
        torch.isfinite(v).all() for v in server.params.values())
    doc = tta.attribute(cap)
    assert len(doc["trace_files"]) == 1 and doc["device_events"] > 1000
    assert doc["attributed_ok"] and doc["attributed_frac"] >= 0.95
    assert doc["categories"]["matmul_conv_mxu"]["time_us"] > 0
    trace = json.load(open(tmp_path / "run" / "trace.json"))
    spans = [e for e in trace["traceEvents"]
             if e.get("ph") == "X" and e["name"] == "profiler.capture"]
    assert len(spans) == 1 and spans[0]["args"]["log_dir"] == cap
    # a CPU capture's ops nest: the file entry attributes it, the
    # per-name sums (a card's kineto records) have no device record
    _, window = profile_window(trainer.run_round, server, clients,
                               log_dir=str(tmp_path / "cap2"))
    assert tta.attribute(str(tmp_path / "cap2"))["attributed_ok"]
    assert tta.attribute_sums(window)["device_events"] == 0
    assert tta.main([cap, "--out", str(tmp_path / "a.json")]) == 0
    assert json.load(open(tmp_path / "a.json"))["schema"] == \
        jta.TRACE_ATTRIB_SCHEMA


def test_the_sums_path_agrees_with_the_trace_file(tmp_path):
    """``attribute_sums`` (a card window's per-name sums, the in-memory
    entry) and ``attribute`` (the file entry, every record's start and
    lane) on the same CUDA records: the same categories' times, hand
    rows and norms; only the file has an ``idle_gap``."""
    from fedtorch_tpu_torch.utils.tracing import ProfileWindow
    from test_torch_tracing import _OldKinetoEvent
    names = ["void qdq_ragged_stats_kernel(LeafTable)",
             "void flash_fwd_tc_kernel<64>(CUtensorMap)",
             "sm90_xmma_gemm_bf16", "void cudnn::bn_fw_tr_1C11_kernel<f>()",
             "void at::native::vectorized_elementwise_kernel<4>()",
             "Memcpy DtoH (Device -> Pinned)"]
    evs, trace, t = [], [], 0.0
    for i in range(60):
        name, dur_ns = names[i % len(names)], 1000 * (1 + i % 4)
        evs.append(_OldKinetoEvent(name, "CUDA", t, dur_ns))
        evs.append(_OldKinetoEvent("cudaLaunchKernel", "CPU", t, 300, 0))
        trace.append(dict(ph="X", cat="gpu_memcpy" if "Memcpy" in name
                          else "kernel", name=name, pid=0, tid=7, ts=t,
                          dur=dur_ns / 1e3))
        trace.append(dict(ph="X", cat="cuda_runtime",
                          name="cudaLaunchKernel", pid=1, tid=1, ts=t,
                          dur=0.3))
        t += 6.0
    w = ProfileWindow(None)
    w._events = evs
    path = tmp_path / "h.1.trace.json"
    path.write_text(json.dumps({"traceEvents": trace}))
    disk, sums = tta.attribute(str(tmp_path)), tta.attribute_sums(w)
    assert "idle_gap" in disk["categories"]
    assert "idle_gap" not in sums["categories"]
    for cat, rec in sums["categories"].items():
        assert rec["time_us"] == pytest.approx(
            disk["categories"][cat]["time_us"]), cat
        assert rec["events"] == disk["categories"][cat]["events"]
    assert sums["hand_kernels"].keys() == disk["hand_kernels"].keys()
    for row, rec in sums["hand_kernels"].items():
        assert rec["launches"] == disk["hand_kernels"][row]["launches"]
        assert rec["ms"] == pytest.approx(disk["hand_kernels"][row]["ms"])
    assert sums["norm_kernels"] == pytest.approx(disk["norm_kernels"])
    assert tta.columns(sums) == pytest.approx(tta.columns(disk))
    assert tta.device_ms(sums) == pytest.approx(tta.device_ms(disk))
    # the file's records summed as read: the window's per-name sums
    raw = tta.event_sums(str(tmp_path))
    mem = {name: v for (dev, name), v in w.sums().items() if dev}
    assert raw.keys() == mem.keys()
    for name, (ms, n) in raw.items():
        assert (ms, n) == (pytest.approx(mem[name][0]), mem[name][1])
    assert sums["attributed_ok"] and sums["device_events"] == 60 \
        == disk["device_events"]
