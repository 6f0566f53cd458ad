"""Per-row adaptive quantize -> dequantize: the Hopper kernel, its plain
PyTorch version and the bucketing tree function.

Port of ``fedtorch_tpu/ops/pallas/quant_kernel.py``'s client-grid path
(``_qdq_batch_kernel``, ``fused_quantize_dequantize_tree``). The kernel
is ``csrc/qdq_batch.cu`` (its header says what bounds it and why it is
built the way it is), bound through ``ctypes`` (``build.py``).

:func:`qdq_batch` takes a contiguous float32 ``[rows, n]`` tensor and
gives each row its own statistics. On a CPU tensor it runs the plain
version :func:`qdq_batch_ref`; on a CUDA tensor it launches the kernel
or raises — there is no fallback. Each launch adds one to ``launches``,
so a run can show that its main path went through the kernel.
"""
from __future__ import annotations

import torch

from fedtorch_tpu_torch.ops.cuda.build import load_library

# kernel launches so far (reset it to 0 before the run it should count)
launches = 0

_MAX_ROWS = 2 ** 31 - 1  # gridDim.x


def qrange(num_bits: int):
    """(qmin, qmax) of the symmetric signed integer range."""
    return -(2.0 ** (num_bits - 1)), 2.0 ** (num_bits - 1) - 1.0


def _affine_roundtrip(x, mn, mx, mean, num_bits: int):
    """The scheme given precomputed (broadcastable) stats, literally as
    the JAX package's ``_affine_roundtrip`` (quant_kernel.py:43-54).
    Every division has a tensor divisor: PyTorch's CUDA division by a
    Python scalar multiplies by its rounded reciprocal instead, which
    would not be the IEEE quotient the kernel computes."""
    qmin, qmax = qrange(num_bits)
    scale = (mx - mn) / torch.full_like(mx, qmax - qmin)
    scale = torch.where(scale == 0.0, 0.001, scale)
    zp = torch.trunc(torch.clamp(qmin - (mn - mean) / scale, qmin, qmax))
    q = torch.clamp(torch.round(zp + (x - mean) / scale), qmin, qmax)
    return scale * (q - zp) + mean


def qdq_batch_ref(x: torch.Tensor, num_bits: int = 8) -> torch.Tensor:
    """Plain version: per-row min, max and mean, then the round trip."""
    n = x.shape[1]
    mn = x.amin(dim=1, keepdim=True)
    mx = x.amax(dim=1, keepdim=True)
    mean = x.sum(dim=1, keepdim=True) / torch.full_like(mn, n)
    return _affine_roundtrip(x, mn, mx, mean, num_bits)


def _check(x: torch.Tensor, num_bits: int) -> None:
    if num_bits not in (8, 16):
        raise ValueError(f"num_bits must be 8 or 16, got {num_bits}")
    if x.dtype != torch.float32:
        raise ValueError(f"qdq_batch takes float32, got {x.dtype}")
    if x.dim() != 2:
        raise ValueError(f"qdq_batch takes a 2-D [rows, n] tensor, got "
                         f"shape {tuple(x.shape)}")
    rows, n = x.shape
    if n < 1 or not 1 <= rows <= _MAX_ROWS:
        raise ValueError(f"qdq_batch needs 1 <= rows <= {_MAX_ROWS} and "
                         f"n >= 1, got shape {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("qdq_batch takes a contiguous tensor")


def qdq_batch(x: torch.Tensor, num_bits: int = 8) -> torch.Tensor:
    """Per-row quantize -> dequantize of a float32 ``[rows, n]`` tensor:
    the kernel on CUDA, the plain version on the CPU."""
    global launches
    _check(x, num_bits)
    if x.device.type == "cpu":
        return qdq_batch_ref(x, num_bits)
    if x.device.type != "cuda":
        raise ValueError(f"qdq_batch runs on cuda or cpu, got {x.device}")
    fn = load_library().qdq_batch_f32
    out = torch.empty_like(x)
    rows, n = x.shape
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(x.data_ptr(), out.data_ptr(), rows, n, num_bits, stream)
    if err != 0:
        raise RuntimeError(f"qdq_batch_f32 launch failed: CUDA error {err}")
    launches += 1
    return out


def fused_quantize_dequantize_tree(tree: dict, num_bits: int = 8,
                                   leading_batch: bool = False) -> dict:
    """Per-tensor quantize -> dequantize over a dict of tensors, bucketed
    by size: leaves of one size are stacked and served by ONE
    :func:`qdq_batch` launch (per-row stats keep exact per-tensor
    semantics). A ResNet-20 payload has 65 leaves of 13 sizes, so 13
    launches.

    ``leading_batch=True`` is the uplink layout: each leaf carries a
    leading ``[k]`` client axis, buckets key on (k, per-client size) and
    stack to ``[b*k, n]`` so stats stay per (tensor, client)."""
    buckets = {}
    for name, x in tree.items():
        k = x.shape[0] if leading_batch else 1
        buckets.setdefault((k, x.numel() // k), []).append(name)
    out = {}
    for (k, n), names in buckets.items():
        stacked = torch.stack([tree[m].reshape(k, n) for m in names])
        q = qdq_batch(stacked.reshape(-1, n).to(torch.float32), num_bits)
        q = q.reshape(len(names), k, n)
        for j, m in enumerate(names):
            out[m] = q[j].reshape(tree[m].shape).to(tree[m].dtype)
    return {m: out[m] for m in tree}
