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
    # round_program.collective_budget is ported (ROADMAP A10): the port
    # counts the collectives its client-shard seam issues
    # (podscale.collective_count), and at client_shards 0 on several
    # ranks its cohort gathers (collective_count('cohort'), one a round,
    # the JAX budget there), where the JAX package's program audit
    # (FTP004) certifies them
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
    # the federation plane's observers (ROADMAP A7, second half) and the
    # async plane (A8). async_plane/commit.py's lowered_cost_programs has
    # no port: it lowers the commit program for XLA's cost analysis
    # (telemetry/costs.py, no port below)
    **_ported("telemetry/anomaly.py", "telemetry/critical_path.py",
              "telemetry/ledger.py",
              "async_plane/__init__.py", "async_plane/commit.py",
              "async_plane/scheduler.py", "async_plane/staleness.py"),
    **_rows("no port", "a separate program that reads run directories; "
            "the port writes the telemetry schema, so it reads port runs "
            "without the port importing it",
            "telemetry/runs.py", "tools/__init__.py", "tools/compare.py",
            "tools/plots.py", "tools/records.py", "tools/report.py",
            "tools/watch.py"),
    # ROADMAP A12: the round's cost capture (torch.utils.flop_counter, the
    # CUDA allocator's peak) and the trace attribution over torch
    # profiler traces
    **_ported("telemetry/costs.py", "tools/trace_attrib.py"),
    # client fusion (ROADMAP A9); the fused layers and models sit in the
    # ported models/{common,resnet,cnn,__init__}.py, and remat (A11's
    # per-block rematerialization) in each model family's module
    **_ported("parallel/fusion.py"),
    # ROADMAP A10: pod-scale client sharding on torch.distributed (a
    # DeviceMesh over the ranks, the grouped sum's one all_gather), and
    # the JAX package's 1-D mesh at client_shards 0 (each rank's
    # ceil(k/W) rows of the cohort, one gather of them after the local
    # loops), local-SGD mode on it too
    **_ported("parallel/mesh.py", "parallel/podscale.py"),
    # ROADMAP A11: the model-parallel forwards on torch.distributed, a
    # DeviceMesh in place of jax.sharding.Mesh
    **_ported("parallel/sequence.py", "parallel/expert.py",
              "parallel/tensor.py", "parallel/pipeline.py"),
    # ROADMAP A12: the static analysis over the port (a host-sync lint in
    # the FTL ids whose meaning carries over, the concurrency audit's own
    # copy, the registry audit over the port's registries), the lock-order
    # sentinel, and tracing.py's capture, with SyncSentinel in place of
    # RecompilationSentinel: eager torch never retraces, so the JAX
    # module's RecompilationSentinel, instrument_trace, record_trace_event
    # and trace_counts have no meaning here
    **_ported("lint/__init__.py", "lint/__main__.py", "lint/analyzer.py",
              "lint/cli.py", "lint/findings.py", "lint/rules.py",
              "lint/concurrency_audit.py", "lint/registry_audit.py",
              "utils/lock_sentinel.py", "utils/tracing.py"),
    **_rows("no port", "lowers every round-program cell to XLA and checks "
            "the HLO; eager torch lowers no program. Runtime checks stand "
            "for its rules: FTP002 utils.tracing.SyncSentinel, FTP004 "
            "podscale.collective_count against "
            "round_program.collective_budget, FTP006 the "
            "hbm_program_peak_bytes gauge, FTP001 the models' refusal of "
            "compute dtypes other than float32 and bfloat16 "
            "(lint/rules.py PROGRAM_RULES)",
            "lint/program_audit.py"),
    **_rows("no port", "XLA's persistent compilation cache; eager torch "
            "compiles nothing to cache (the hand kernels' build keys its "
            "library by the sources' hash, ops/cuda/build.py)",
            "utils/compile_cache.py"),
}
