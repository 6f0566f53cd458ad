"""Time the flash forward kernels of the checkout this runs from, on one
CUDA card.

    python -m fedtorch_tpu_torch.tools.time_flash [--tag NAME]

Times each kernel through its wrapper's whole launch, causal, on strided
q, k, v views of one projection rotating over at least 128 MB (twice
the L2): the TF32 kernel (``flash_attention._launch_tf32``) in float32
and in bfloat16 at (8, 2048, 4, 64), in float32 at (8, 2048, 4, D), D in
{25, 256, 320, 384, 512} (past 256 its clusters, or the column blocks of
a checkout that has none), and in bfloat16 at (8, 2048, 4, 512); the
wgmma kernel (``_launch_tc``, its non-finite pre-pass included) in
bfloat16 at (8, 2048, 4, D), D in {64, 128, 256, 512}, and that pre-pass
alone where the checkout has one (a checkout whose kernels stop below a
head dim, as the ones before every head dim was taken did, reports None
there); and
``F.scaled_dot_product_attention(is_causal=True)`` in float32 (TF32
off) at (8, 2048, 4, 25), the TF32 kernel's yardstick at the default
transformer width, with the backend it takes. Each figure is the median
over 15 replays of a CUDA graph of 10 back-to-back calls, as
``chip_smoke.py`` times its kernels. Prints one JSON line with the card
and its power limit.

Two versions of a kernel are compared on one card by running this from
each checkout in alternation on one machine without a break (parent,
change, change, parent, ...): a card's clocks and power limit differ
from one machine or hour to the next, so figures taken apart are not
compared.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import math
import statistics
import subprocess

import torch

# (name, [B, T, H, D], dtype, what is timed)
SHAPES = (("float32_d64", (8, 2048, 4, 64), torch.float32, "tf32"),
          ("bfloat16_d64", (8, 2048, 4, 64), torch.bfloat16, "tf32"),
          ("float32_d25", (8, 2048, 4, 25), torch.float32, "tf32"),
          ("tc_bfloat16_d64", (8, 2048, 4, 64), torch.bfloat16, "tc"),
          ("tc_bfloat16_d128", (8, 2048, 4, 128), torch.bfloat16, "tc"),
          ("float32_d256", (8, 2048, 4, 256), torch.float32, "tf32"),
          ("tc_bfloat16_d256", (8, 2048, 4, 256), torch.bfloat16, "tc"),
          ("float32_d320", (8, 2048, 4, 320), torch.float32, "tf32"),
          ("float32_d384", (8, 2048, 4, 384), torch.float32, "tf32"),
          ("float32_d512", (8, 2048, 4, 512), torch.float32, "tf32"),
          ("bfloat16_d512", (8, 2048, 4, 512), torch.bfloat16, "tf32"),
          ("tc_bfloat16_d512", (8, 2048, 4, 512), torch.bfloat16, "tc"),
          ("tc_prepass_d64", (8, 2048, 4, 64), torch.bfloat16, "prepass"),
          ("tc_prepass_d128", (8, 2048, 4, 128), torch.bfloat16,
           "prepass"),
          ("tc_prepass_d256", (8, 2048, 4, 256), torch.bfloat16,
           "prepass"),
          ("tc_prepass_d512", (8, 2048, 4, 512), torch.bfloat16,
           "prepass"),
          ("sdpa_float32_d25", (8, 2048, 4, 25), torch.float32, "sdpa"))
ROTATE_BYTES = 128 * 2 ** 20


def graph_ms(fn, inner: int = 10, reps: int = 15) -> float:
    """Median device ms of one ``fn()``: ``inner`` calls captured in a
    CUDA graph, replayed ``reps`` times between CUDA events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
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


def _launcher(what, D):
    """``fn(q, k, v)`` for one of SHAPES' kinds, or None where this
    checkout lacks it (a parent without the pre-pass, or whose kernels
    stop below head dim D: those name their limit in ``MAX_HEAD_DIM``)."""
    import torch.nn.functional as F

    from fedtorch_tpu_torch.ops.cuda import build
    from fedtorch_tpu_torch.ops.cuda import flash_attention as fa
    scale = 1.0 / math.sqrt(D)
    if what != "sdpa" and (D > getattr(fa, "MAX_HEAD_DIM", D) or (
            what != "tf32" and D not in fa.TC_HEAD_DIMS)):
        return None
    if what == "tf32":
        return lambda q, k, v: fa._launch_tf32(q, k, v, scale, True)
    if what == "tc":
        return lambda q, k, v: fa._launch_tc(q, k, v, scale, True)
    if what == "sdpa":
        return lambda q, k, v: F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            is_causal=True)
    lib = build.load_library()
    if not hasattr(lib, "flash_tc_last_nonfinite"):
        return None
    fn = lib.flash_tc_last_nonfinite
    fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int64] * 7 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def prepass(q, k, v):
        B, T, H, _ = v.shape
        last = torch.empty(B * H * D, dtype=torch.int32, device=v.device)
        if fn(v.data_ptr(), last.data_ptr(), B, T, H, D,
              *fa._tc_strides(v),
              torch.cuda.current_stream().cuda_stream) != 0:
            raise RuntimeError("flash_tc_last_nonfinite failed")
    return prepass


def time_one(shape, dtype, what, gen):
    """Median device ms of one call of ``what`` at ``shape``, or None."""
    B, T, H, D = shape
    launch = _launcher(what, D)
    if launch is None:
        return None
    elem = torch.finfo(dtype).bits // 8
    views = []
    for _ in range(max(1, math.ceil(ROTATE_BYTES
                                    / (3 * B * T * H * D * elem)))):
        x = torch.randn(B, T, 3 * H * D, generator=gen,
                        device="cuda").to(dtype)
        views.append(tuple(c.view(B, T, H, D) for c in x.chunk(3, dim=-1)))
    calls = iter(range(1 << 62))

    def one():
        launch(*views[next(calls) % len(views)])

    return graph_ms(one)


def sdpa_backend(shape, dtype) -> str:
    """The kernel SDPA launches at ``shape`` (its name in a CUDA trace,
    as ``chip_smoke.sdpa_backend`` reads it)."""
    import torch.nn.functional as F
    from torch.profiler import ProfilerActivity, profile
    B, T, H, D = shape
    q = torch.randn(B, H, T, D, device="cuda", dtype=dtype)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        F.scaled_dot_product_attention(q, q, q, is_causal=True)
        torch.cuda.synchronize()
    names = [e.key for e in prof.key_averages()
             if getattr(e, "self_device_time_total",
                        getattr(e, "self_cuda_time_total", 0)) > 0
             and not e.key.startswith("Memset")]
    return "; ".join(n[:100] for n in names) or "not recorded"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tag", default="", help="a name for this checkout")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("time_flash: needs a CUDA card")
    from fedtorch_tpu_torch.ops.cuda import build
    build.load_library()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    gen = torch.Generator(device="cuda").manual_seed(3)
    out = {"tag": args.tag, "card": card}
    torch.backends.cuda.matmul.allow_tf32 = False
    for name, shape, dtype, what in SHAPES:
        out[f"{name}_ms"] = time_one(shape, dtype, what, gen)
        torch.cuda.empty_cache()
    out["sdpa_float32_d25_backend"] = sdpa_backend(SHAPES[-1][1],
                                                   torch.float32)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
