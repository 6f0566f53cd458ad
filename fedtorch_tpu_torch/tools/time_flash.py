"""Time the TF32 flash forward of the checkout this runs from, on one
CUDA card.

    python -m fedtorch_tpu_torch.tools.time_flash [--tag NAME]

Times ``flash_attention._launch_tf32`` (its wrapper's whole launch) in
float32 and in bfloat16 at (8, 2048, 4, 64) and in float32 at (8, 2048,
4, 25), causal, on strided q, k, v views of one projection rotating over
at least 128 MB (twice the L2): each figure is the median over 15
replays of a CUDA graph of 10 back-to-back launches, as
``chip_smoke.py`` times its kernels. Prints one JSON line with the card
and its power limit.

Two versions of the kernel are compared on one card by running this
from each checkout in alternation on one machine without a break
(parent, change, change, parent, ...): a card's clocks and power limit
differ from one machine or hour to the next, so figures taken apart
are not compared.
"""
from __future__ import annotations

import argparse
import json
import math
import statistics
import subprocess

import torch

SHAPES = (("float32_d64", (8, 2048, 4, 64), torch.float32),
          ("bfloat16_d64", (8, 2048, 4, 64), torch.bfloat16),
          ("float32_d25", (8, 2048, 4, 25), torch.float32))
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


def time_tf32(shape, dtype, gen) -> float:
    from fedtorch_tpu_torch.ops.cuda import flash_attention as fa
    B, T, H, D = shape
    elem = torch.finfo(dtype).bits // 8
    views = []
    for _ in range(max(1, math.ceil(ROTATE_BYTES
                                    / (3 * B * T * H * D * elem)))):
        x = torch.randn(B, T, 3 * H * D, generator=gen,
                        device="cuda").to(dtype)
        views.append(tuple(c.view(B, T, H, D) for c in x.chunk(3, dim=-1)))
    calls = iter(range(1 << 62))
    scale = 1.0 / math.sqrt(D)

    def one():
        q, k, v = views[next(calls) % len(views)]
        fa._launch_tf32(q, k, v, scale, True)

    return graph_ms(one)


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
    for name, shape, dtype in SHAPES:
        out[f"{name}_ms"] = time_tf32(shape, dtype, gen)
        torch.cuda.empty_cache()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
