"""The module map: every module of the JAX package and what the port
does with it.

``MODULE_MAP[path]`` is ``(status, detail)`` for each
``fedtorch_tpu/**/*.py``:

- ``"ported"``: ``detail`` is the port module that mirrors it;
- ``"queued"``: not ported yet; ``detail`` says which ROADMAP item ports
  it;
- ``"no port"``: ``detail`` says why it has no torch counterpart (it
  works on XLA programs, or it is a separate program that reads run
  directories and needs no import by the port).

``tests/test_torch_modules_map.py`` holds the map to the tree: a row for
every module, and every ported row names a port module that exists.
"""
from __future__ import annotations

_P = "fedtorch_tpu_torch/"


def _ported(*names: str) -> dict:
    """Modules ported under the same relative path."""
    return {f"fedtorch_tpu/{n}": ("ported", _P + n) for n in names}


def _rows(status: str, detail: str, *names: str) -> dict:
    return {f"fedtorch_tpu/{n}": (status, detail) for n in names}


MODULE_MAP = {
    **_ported(
        "__init__.py", "cli.py", "config.py",
        "algorithms/__init__.py", "algorithms/base.py",
        "algorithms/afl.py", "algorithms/apfl.py", "algorithms/drfa.py",
        "algorithms/fedavg.py", "algorithms/fedgate.py",
        "algorithms/perfedavg.py", "algorithms/perfedme.py",
        "algorithms/qffl.py", "algorithms/qsparse.py",
        "algorithms/scaffold.py",
        "core/__init__.py", "core/losses.py", "core/optim.py",
        "core/schedule.py", "core/state.py", "core/sync.py",
        "data/__init__.py", "data/batching.py", "data/datasets.py",
        "data/partition.py", "data/streaming.py", "data/synthetic.py",
        "models/__init__.py", "models/cnn.py", "models/common.py",
        "models/densenet.py", "models/linear.py", "models/mlp.py", "models/resnet.py",
        "models/rnn.py", "models/transformer.py", "models/wideresnet.py",
        "ops/__init__.py", "ops/attention_dispatch.py", "ops/augment.py",
        "ops/quantize.py", "ops/simplex.py", "ops/topk.py",
        "parallel/__init__.py", "parallel/evaluate.py",
        "parallel/federated.py", "parallel/local_sgd.py",
        "parallel/round_program.py",
        "robustness/__init__.py", "robustness/aggregators.py",
        "robustness/availability.py", "robustness/chaos.py",
        "robustness/guards.py", "robustness/privacy.py",
        "utils/__init__.py", "utils/logging.py", "utils/meters.py",
        "utils/platform.py"),
    # the Pallas kernels became hand-written Hopper kernels
    "fedtorch_tpu/ops/pallas/__init__.py":
        ("ported", _P + "ops/cuda/__init__.py"),
    "fedtorch_tpu/ops/pallas/flash_attention.py":
        ("ported", _P + "ops/cuda/flash_attention.py"),
    "fedtorch_tpu/ops/pallas/quant_kernel.py":
        ("ported", _P + "ops/cuda/quant_kernel.py"),
    # the host pipeline's gather, padding and prefetcher; the port's
    # gather is ATen's index_select, so native/pipeline.cpp (and its
    # seeded permutation and svmlight parser) has no counterpart.
    # round_program.collective_budget (the pod-scale FTP004 budget) waits
    # for multi-GPU runs and a program audit (ROADMAP A10, A12)
    **_ported("native/__init__.py", "native/host_pipeline.py"),
    # the run lifecycle and the telemetry writer (ROADMAP A7, first half)
    **_ported("robustness/harness.py", "robustness/host_chaos.py",
              "robustness/host_recovery.py", "robustness/preemption.py",
              "robustness/supervisor.py", "robustness/watchdog.py",
              "telemetry/__init__.py", "telemetry/faults.py",
              "telemetry/health.py", "telemetry/metrics.py",
              "telemetry/runtime.py", "telemetry/schema.py",
              "telemetry/spans.py", "utils/checkpoint.py",
              "utils/diagnostics.py"),
    **_rows("queued", "ROADMAP A7: its second half, the federation "
            "plane's observers",
            "telemetry/anomaly.py", "telemetry/critical_path.py",
            "telemetry/ledger.py"),
    **_rows("no port", "a separate program that reads run directories; "
            "the port writes the telemetry schema, so it reads port runs "
            "without the port importing it",
            "telemetry/runs.py", "tools/__init__.py", "tools/compare.py",
            "tools/plots.py", "tools/records.py", "tools/report.py",
            "tools/watch.py"),
    **_rows("no port", "reads XLA's cost analysis and XLA traces; a "
            "torch-profiler analog only if a later item needs one "
            "(ROADMAP A7)",
            "telemetry/costs.py", "tools/trace_attrib.py"),
    **_rows("queued", "ROADMAP A8: the async plane",
            "async_plane/__init__.py", "async_plane/commit.py",
            "async_plane/scheduler.py", "async_plane/staleness.py"),
    **_rows("queued", "ROADMAP A9: client fusion",
            "parallel/fusion.py"),
    **_rows("queued", "ROADMAP A10: multi-GPU on torch.distributed",
            "parallel/mesh.py", "parallel/podscale.py"),
    **_rows("queued", "ROADMAP A11: sequence, expert, tensor and pipeline "
            "parallelism",
            "parallel/sequence.py", "parallel/expert.py",
            "parallel/tensor.py", "parallel/pipeline.py"),
    **_rows("no port", "the JAX tracing-hazard lint (FTL rules) and the "
            "StableHLO program audit are JAX-specific; a torch analog (host "
            "syncs in the round) is ROADMAP A12",
            "lint/__init__.py", "lint/__main__.py", "lint/analyzer.py",
            "lint/cli.py", "lint/findings.py", "lint/rules.py",
            "lint/program_audit.py"),
    **_rows("no port", "a stdlib AST pass: run it over the port as a tool; "
            "the port does not import it (ROADMAP A12)",
            "lint/concurrency_audit.py", "lint/registry_audit.py"),
    **_rows("queued", "ROADMAP A12: comes with the host threads of A5 and "
            "A7",
            "utils/lock_sentinel.py"),
    **_rows("no port", "XLA's persistent compilation cache; eager torch "
            "compiles nothing to cache (ROADMAP A12)",
            "utils/compile_cache.py"),
    **_rows("queued", "ROADMAP A12: its profiler-trace capture; its "
            "recompilation sentinel has no eager-torch meaning",
            "utils/tracing.py"),
}
