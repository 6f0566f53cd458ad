#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py [--seed N]

Run from the root of a checkout on a machine with a CUDA GPU, ``nvcc``
(``$CUDA_HOME`` or ``/usr/local/cuda``) and PyTorch. It imports nothing
of JAX or of the JAX package. Phases, each fatal on failure:

1. the card: ``nvidia-smi``'s name and power limit;
2. build: every kernel of the port from ``fedtorch_tpu_torch/csrc``;
3. kernels vs plain: the quantizer kernel against its plain PyTorch
   version on the card, at the 13 uplink ``[b*10, n]`` and 13 downlink
   ``[b, n]`` bucket shapes of a ResNet-20 payload, int8 and int16, plus
   edge rows (constant, NaN, inf, n = 1, n not a multiple of 256) —
   within one quantization step per element, bitwise on exact-sum
   inputs — and timed (CUDA graphs of back-to-back launches, CUDA
   events, median of repeats);
4. reference: a float32 ResNet-20 forward and one quantized ResNet-8
   round on the card against the same on the CPU (TF32 off), the CPU
   path being the one the tests hold against the JAX package;
5. main path: the north-star round at full width through the library
   entry points (``define_model`` -> ``make_algorithm`` ->
   ``FederatedTrainer`` -> ``init_state`` -> ``run_rounds``): quantized
   FedAvg, ResNet-20 in bfloat16, 100 clients x 250 CIFAR-10-shaped
   samples made from ``--seed``, k = 10, batch 50, 10 local steps, flip
   and crop augmentation; 1 warm-up round, then 3 timed rounds. The
   kernel's launch counter is set to 0 just before and must read 26
   per round after;
6. profile: one more main-path round under ``torch.profiler`` — the
   device's busy share and its time by kernel.

Prints a ``{"kernels": [...]}`` line, a ``{"main_path": {...}}`` line,
a ``{"profile": {...}}`` line and, last, ``{"ok": true, "device":
{...}}``. Exits non-zero, printing no result, without CUDA.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

# H100 SXM peaks (NVIDIA's data sheet): device memory, and float32
# outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# float32 operations per element of the round trip: min, max and add for
# the statistics; subtract, divide, add, round, two clips, subtract,
# multiply and add for the output
QDQ_OPS_PER_ELEM = 12
TPU_KERNEL = "fedtorch_tpu/ops/pallas/quant_kernel.py:76"
KERNEL_SOURCE = "fedtorch_tpu_torch/csrc/qdq_batch.cu"

# north-star sizes (bench.py)
NUM_CLIENTS, SAMPLES, BATCH, LOCAL_STEPS, ONLINE_RATE = 100, 250, 50, 10, 0.1
TIMED_ROUNDS = 3


def log(*a):
    print(*a, flush=True)


def phase(name):
    log(f"== {name}")


def card_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


def device_ms(fn, inner: int = 20, reps: int = 15) -> float:
    """Device time of one ``fn()`` call: ``inner`` calls captured in a
    CUDA graph, replayed ``reps`` times between CUDA events; median."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(inner):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def resnet20_buckets(cfg_mod, define_model):
    """(leaves, n) per distinct leaf size of a ResNet-20 payload."""
    cfg = cfg_mod.ExperimentConfig(
        data=cfg_mod.DataConfig(dataset="cifar10"),
        model=cfg_mod.ModelConfig(arch="resnet20")).finalize()
    params = define_model(cfg, device="cuda").init(torch.Generator())
    sizes = {}
    for v in params.values():
        sizes[v.numel()] = sizes.get(v.numel(), 0) + 1
    return sorted((b, n) for n, b in sizes.items())


def kernel_phase(qk, buckets, k_online):
    """Kernel vs plain on the card; returns the kernels-line fields."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    shapes = [(b * k_online, n) for b, n in buckets] \
        + [(b, n) for b, n in buckets]
    worst_steps, worst_abs = 0.0, 0.0

    def check(x, bits, bitwise=False):
        nonlocal worst_steps, worst_abs
        got = qk.qdq_batch(x, bits)
        want = qk.qdq_batch_ref(x, bits)
        torch.cuda.synchronize()
        if bitwise:
            if not torch.equal(got, want):
                raise AssertionError(f"kernel != plain bitwise at "
                                     f"{tuple(x.shape)} bits {bits}")
            return
        nan_got, nan_want = torch.isnan(got), torch.isnan(want)
        if not torch.equal(nan_got, nan_want):
            raise AssertionError(f"NaN pattern differs at {tuple(x.shape)}")
        qmin, qmax = qk.qrange(bits)
        fin = torch.where(torch.isfinite(x), x, torch.zeros_like(x))
        step = (fin.amax(1, keepdim=True) - fin.amin(1, keepdim=True)) \
            / (qmax - qmin)
        step = torch.where(step == 0, 1e-3, step)  # the scale floor
        diff = torch.where(nan_got, torch.zeros_like(got),
                           (got - want).abs())
        worst_steps = max(worst_steps, float((diff / step).max()))
        worst_abs = max(worst_abs, float(diff.max()))
        # one step, plus the float32 rounding of the dequantized value
        slack = step * (1 + 1e-5) + 1e-6 * want.abs().nan_to_num() + 1e-7
        if bool((diff > slack).any()):
            raise AssertionError(f"kernel off by more than one step at "
                                 f"{tuple(x.shape)} bits {bits}")

    for bits in (8, 16):
        for rows, n in shapes:
            x = torch.randn(rows, n, generator=gen, device="cuda") * 1e-3
            check(x, bits)
            # dyadic grid: every sum is exact and both divide IEEE, so
            # the statistics and each output bit must agree
            d = torch.randint(-64, 65, (rows, n), generator=gen,
                              device="cuda").float() / 16.0
            check(d, bits, bitwise=True)
        edge = torch.randn(6, 1000, generator=gen, device="cuda")
        edge[1] = 0.25                    # constant row: the scale floor
        edge[2, 17] = float("nan")
        edge[3, 5] = float("inf")
        edge[4, 999] = -float("inf")
        check(edge, bits)
        for n in (1, 255, 257, 4097):
            check(torch.randn(7, n, generator=gen, device="cuda"), bits)
    log(f"kernel vs plain: {2 * len(shapes)} bucket shapes + edge rows, "
        f"max error {worst_steps:.6f} steps ({worst_abs:.3e} abs)")

    # timing at the int8 main-path shapes: one round = all 26 launches
    kernel_ms = plain_ms = elems = 0.0
    for rows, n in shapes:
        x = torch.randn(rows, n, generator=gen, device="cuda") * 1e-3
        kernel_ms += device_ms(lambda: qk.qdq_batch(x, 8))
        plain_ms += device_ms(lambda: qk.qdq_batch_ref(x, 8))
        elems += x.numel()
    bytes_moved = 2 * 4 * elems  # float32, read once, written once
    bytes_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    ops_ms = QDQ_OPS_PER_ELEM * elems / FP32_OPS_PER_S * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    bound_by = "bytes" if bytes_ms >= ops_ms else "operations"
    log(f"per round ({len(shapes)} launches, int8): kernel {kernel_ms:.4f}"
        f" ms, plain {plain_ms:.4f} ms, bound {bound_ms:.5f} ms by "
        f"{bound_by} ({bytes_moved / 1e6:.2f} MB: {bytes_ms:.5f} ms; "
        f"{QDQ_OPS_PER_ELEM * elems / 1e6:.1f} M float32 ops: "
        f"{ops_ms:.5f} ms)")
    return dict(max_abs_err=worst_abs, max_err_steps=worst_steps,
                ms=kernel_ms, kernel_ms=kernel_ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by,
                bytes_per_round=bytes_moved, launches_per_round=len(shapes))


def reference_phase(tcfg, define_model, make_algorithm, stack_partitions,
                    FederatedTrainer, bridge):
    """float32 ResNet-20 logits and a quantized ResNet-8 round, card vs
    CPU on the same weights and plan."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = tcfg.ExperimentConfig(
        data=tcfg.DataConfig(dataset="cifar10"),
        model=tcfg.ModelConfig(arch="resnet20")).finalize()
    gpu, cpu = define_model(cfg, device="cuda"), define_model(cfg,
                                                              device="cpu")
    params = cpu.init(torch.Generator().manual_seed(1))
    x = torch.from_numpy(np.random.RandomState(1).randn(16, 32, 32, 3)
                         .astype(np.float32))
    with torch.no_grad():
        want = cpu.apply(params, x)
        got = gpu.apply({k: v.cuda() for k, v in params.items()},
                        x.cuda()).cpu()
    err = float((got - want).abs().max())
    if not torch.allclose(got, want, rtol=1e-4, atol=1e-4):
        raise AssertionError(f"ResNet-20 logits card vs CPU: {err}")
    log(f"ResNet-20 f32 logits, card vs CPU: max |diff| {err:.3e}")

    cfg = tcfg.ExperimentConfig(
        data=tcfg.DataConfig(dataset="cifar10", batch_size=8),
        federated=tcfg.FederatedConfig(
            federated=True, num_clients=4, online_client_rate=0.5,
            sync_type="local_step", quantized=True),
        model=tcfg.ModelConfig(arch="resnet8"),
        optim=tcfg.OptimConfig(lr=0.1, in_momentum=True),
        train=tcfg.TrainConfig(local_step=2)).finalize()
    rng = np.random.RandomState(2)
    data = stack_partitions(rng.randn(64, 32, 32, 3).astype(np.float32),
                            rng.randint(0, 10, 64),
                            [np.arange(16 * i, 16 * i + 16)
                             for i in range(4)])
    updates = {}
    for dev in ("cpu", "cuda"):
        tr = FederatedTrainer(cfg, define_model(cfg, 8, device=dev),
                              make_algorithm(cfg), data, device=dev)
        server, clients = tr.init_state(3)
        p0 = bridge.params_to_jax(server.params)
        server, clients, m = tr.round_fn(server, clients,
                                         tr.draw_plan(server))
        p1 = bridge.params_to_jax(server.params)
        updates[dev] = {k: p1[k] - p0[k] for k in p0}
    worst = 0.0
    for k, u in updates["cpu"].items():
        step = (u.max() - u.min()) / 255.0
        worst = max(worst, float(np.abs(updates["cuda"][k] - u).max()
                                 / max(step, 1e-12)))
    if worst > 2.0:
        raise AssertionError(f"quantized round card vs CPU: {worst} steps")
    log(f"quantized ResNet-8 round, card vs CPU: max {worst:.4f} "
        "downlink steps")
    torch.backends.cudnn.allow_tf32 = True


def main_path_phase(seed, tcfg, define_model, make_algorithm,
                    stack_partitions, FederatedTrainer, qk):
    cfg = tcfg.ExperimentConfig(
        data=tcfg.DataConfig(dataset="cifar10", batch_size=BATCH),
        federated=tcfg.FederatedConfig(
            federated=True, num_clients=NUM_CLIENTS,
            online_client_rate=ONLINE_RATE, algorithm="fedavg",
            sync_type="local_step", quantized=True),
        model=tcfg.ModelConfig(arch="resnet20"),
        optim=tcfg.OptimConfig(lr=0.1, in_momentum=True),
        train=tcfg.TrainConfig(local_step=LOCAL_STEPS),
        mesh=tcfg.MeshConfig(compute_dtype="bfloat16")).finalize()
    t0 = time.perf_counter()
    rng = np.random.RandomState(seed)
    feats = rng.randn(NUM_CLIENTS * SAMPLES, 32, 32, 3).astype(np.float32)
    labels = rng.randint(0, 10, NUM_CLIENTS * SAMPLES)
    parts = [np.arange(i * SAMPLES, (i + 1) * SAMPLES)
             for i in range(NUM_CLIENTS)]
    data = stack_partitions(feats, labels, parts)
    model = define_model(cfg, batch_size=BATCH)
    trainer = FederatedTrainer(cfg, model, make_algorithm(cfg), data)
    server, clients = trainer.init_state(seed)
    init = {k: v.clone() for k, v in server.params.items()}
    log(f"set-up {time.perf_counter() - t0:.2f} s (data, model, state; "
        f"{torch.cuda.memory_allocated() / 2**20:.0f} MiB on the card)")

    qk.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    server, clients, _ = trainer.run_rounds(server, clients, 1)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    server, clients, metrics = trainer.run_rounds(server, clients,
                                                  TIMED_ROUNDS)
    end.record()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    launches = qk.launches
    total_ms = start.elapsed_time(end)

    rounds = 1 + TIMED_ROUNDS
    per_round = launches / rounds
    if launches != 26 * rounds:
        raise AssertionError(f"quantizer launched {launches} times in "
                             f"{rounds} rounds, expected 26 per round")
    online = metrics.online_mask.bool()
    losses = metrics.train_loss[online]
    if losses.numel() != TIMED_ROUNDS * trainer.k_online \
            or not bool(torch.isfinite(losses).all()):
        raise AssertionError(f"bad losses {losses.tolist()}")
    if not all(bool(torch.isfinite(v).all())
               for v in server.params.values()):
        raise AssertionError("non-finite server params")
    moved = max(float((server.params[k] - init[k]).abs().max())
                for k in init)
    if not moved > 0.0:
        raise AssertionError("server params did not change")
    steps = TIMED_ROUNDS * trainer.k_online * trainer.local_steps
    round_ms = total_ms / TIMED_ROUNDS
    out = dict(round_ms=round_ms, local_steps_per_s=steps / (total_ms
                                                             / 1e3),
               timed_rounds=TIMED_ROUNDS, warmup_round_s=warm_s,
               host_wall_s=host_s, quantizer_launches=launches,
               launches_per_round=per_round,
               mean_loss=float(losses.mean()),
               max_param_change=moved,
               peak_mib=torch.cuda.max_memory_allocated() / 2**20)
    log(f"main path: {round_ms:.1f} ms/round, "
        f"{out['local_steps_per_s']:.1f} local-steps/s, "
        f"{launches} quantizer launches in {rounds} rounds")
    return out, trainer, server, clients


def _kind(name: str) -> str:
    n = name.lower()
    if "qdq_batch" in n:
        return "quantizer"
    if "norm" in n or "welford" in n:
        return "batch_norm"
    if any(t in n for t in ("conv", "gemm", "xmma", "cutlass", "cudnn",
                            "wgrad", "dgrad", "sm90", "nchw", "nhwc")):
        return "conv/matmul"
    return "elementwise/reduce/copy"


def profile_phase(trainer, server, clients):
    """One more main-path round under torch.profiler: the device's busy
    share of the round and where its time goes. The profiler's own host
    cost lengthens the round, so the busy share is a lower bound."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.run_rounds(server, clients, 1)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels, cpu_ops = [], []
    for e in prof.key_averages():
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(e, "self_cuda_time_total", 0)
        if "CUDA" in str(getattr(e, "device_type", "")) and dev_us > 0:
            kernels.append((dev_us / 1e3, e.key, e.count))
        elif e.self_cpu_time_total > 0:
            cpu_ops.append((e.self_cpu_time_total / 1e3, e.key, e.count))
    kernels.sort(reverse=True)
    cpu_ops.sort(reverse=True)
    device_ms = sum(k[0] for k in kernels)
    by_kind = {}
    for ms, name, _ in kernels:
        by_kind[_kind(name)] = by_kind.get(_kind(name), 0.0) + ms
    out = dict(round_wall_ms=wall_ms,
               device_ms=device_ms if kernels else None,
               busy_share=device_ms / wall_ms if kernels else None,
               kernel_launches=sum(k[2] for k in kernels),
               device_ms_by_kind=by_kind,
               top_kernels=[dict(name=n[:120], ms=ms, calls=c)
                            for ms, n, c in kernels[:8]],
               top_cpu_ops=[dict(name=n[:80], self_ms=ms, calls=c)
                            for ms, n, c in cpu_ops[:8]])
    if kernels:
        log(f"profiled round: {wall_ms:.1f} ms wall, device busy "
            f"{device_ms:.1f} ms ({100 * device_ms / wall_ms:.1f}%), "
            f"{out['kernel_launches']} kernel launches")
    else:
        log("profiled round: the profiler recorded no device time")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2

    from fedtorch_tpu_torch import bridge, config as tcfg
    from fedtorch_tpu_torch.algorithms import make_algorithm
    from fedtorch_tpu_torch.data.batching import stack_partitions
    from fedtorch_tpu_torch.models import define_model
    from fedtorch_tpu_torch.ops.cuda import build, quant_kernel as qk
    from fedtorch_tpu_torch.parallel import FederatedTrainer

    phase("card")
    card = card_line()
    log(card)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")

    phase("build")
    res = build.build()
    log(f"built {res.path.name} in {res.seconds:.2f} s with "
        f"{build.nvcc_path()}")
    if res.log.strip():
        log(res.log.strip())
    build.load_library()

    phase("kernels vs plain")
    buckets = resnet20_buckets(tcfg, define_model)
    k_online = max(int(ONLINE_RATE * NUM_CLIENTS), 1)
    fields = kernel_phase(qk, buckets, k_online)

    phase("reference")
    reference_phase(tcfg, define_model, make_algorithm, stack_partitions,
                    FederatedTrainer, bridge)

    phase("main path")
    main, trainer, server, clients = main_path_phase(
        args.seed, tcfg, define_model, make_algorithm, stack_partitions,
        FederatedTrainer, qk)

    phase("profile")
    prof = profile_phase(trainer, server, clients)

    kernel = dict(name="qdq_batch_f32", route="cuda", source=KERNEL_SOURCE,
                  replaces=TPU_KERNEL, launches=main["quantizer_launches"],
                  library_ms=None, **fields)
    print(json.dumps({"kernels": [kernel]}))
    print(json.dumps({"main_path": main, "card": card}))
    print(json.dumps({"profile": prof}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
