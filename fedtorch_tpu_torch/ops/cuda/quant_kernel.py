"""Adaptive quantize -> dequantize: the Hopper kernels, their plain
PyTorch versions, the single-tensor entry and the bucketing tree
function.

Port of ``fedtorch_tpu/ops/pallas/quant_kernel.py``. Two kernel files,
bound through ``ctypes`` (``build.py``); their headers say what bounds
them and why they are built the way they are:

* ``csrc/qdq_batch.cu`` (``_qdq_batch_kernel``, and ``_qdq_kernel`` as
  its one-row case): :func:`qdq_batch`, one block per row of a float32
  ``[rows, n]`` tensor, for rows of at most ``_MAX_ROW_ELEMS`` elements;
* ``csrc/qdq_tiled.cu`` (``_tiled_stats_kernel`` + ``_tiled_apply_kernel``):
  :func:`qdq_tiled`, a stats launch that writes per-chunk partial
  ``[min, max, sum]`` and an apply launch that folds them and writes the
  round trip, many blocks per row, for longer rows.

Each row gets its own statistics. On a CPU tensor a wrapper runs its
plain version; on a CUDA tensor it launches the kernel or raises — there
is no fallback. Each launch adds one to its kernel's counter
(``launches``, ``stats_launches``, ``apply_launches``), so a run can
show which kernels its path went through.
"""
from __future__ import annotations

import torch

from fedtorch_tpu_torch.ops.cuda.build import load_library

# kernel launches so far (reset them to 0 before the run they should count)
launches = 0         # qdq_batch_f32
stats_launches = 0   # qdq_tiled_stats_f32
apply_launches = 0   # qdq_tiled_apply_f32

# Rows longer than this take the multi-block pair; the JAX package's
# single-block ceiling (_MAX_VMEM_ELEMS), kept so both packages route a
# tensor the same way.
_MAX_ROW_ELEMS = 512 * 1024
# Elements per block of the multi-block pair (csrc/qdq_tiled.cu says why).
_CHUNK = 8192
_MAX_ROWS = 2 ** 31 - 1       # gridDim.x of the row kernel
_MAX_TILED_ROWS = 65535       # gridDim.y of the pair


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


def _check_bits(num_bits: int) -> None:
    if num_bits not in (8, 16):
        raise ValueError(f"num_bits must be 8 or 16, got {num_bits}")


def _check(x: torch.Tensor, name: str, max_rows: int) -> None:
    if x.dtype != torch.float32:
        raise ValueError(f"{name} takes float32, got {x.dtype}")
    if x.dim() != 2:
        raise ValueError(f"{name} takes a 2-D [rows, n] tensor, got "
                         f"shape {tuple(x.shape)}")
    rows, n = x.shape
    if n < 1 or not 1 <= rows <= max_rows:
        raise ValueError(f"{name} needs 1 <= rows <= {max_rows} and "
                         f"n >= 1, got shape {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} takes a contiguous tensor")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cuda or cpu, got {x.device}")


def _launch(fn, name: str, *args) -> None:
    """Call a C entry point on the current stream of the tensors'
    device and raise on the launch error it returns."""
    err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")


def qdq_batch(x: torch.Tensor, num_bits: int = 8) -> torch.Tensor:
    """Per-row quantize -> dequantize of a float32 ``[rows, n]`` tensor:
    the kernel on CUDA, the plain version on the CPU."""
    global launches
    _check_bits(num_bits)
    _check(x, "qdq_batch", _MAX_ROWS)
    if x.device.type == "cpu":
        return qdq_batch_ref(x, num_bits)
    out = torch.empty_like(x)
    rows, n = x.shape
    with torch.cuda.device(x.device):
        _launch(load_library().qdq_batch_f32, "qdq_batch_f32",
                x.data_ptr(), out.data_ptr(), rows, n, num_bits)
    launches += 1
    return out


# -- the multi-block pair ----------------------------------------------------

def qdq_tiled_stats_ref(x: torch.Tensor) -> torch.Tensor:
    """Plain version of the stats pass: ``[rows, nchunks, 3]`` partial
    ``[min, max, sum]`` of each ``_CHUNK`` elements of each row (the last
    chunk ragged)."""
    rows, n = x.shape
    chunk = _CHUNK
    full = n // chunk
    parts = []
    if full:
        body = x.unfold(1, chunk, chunk)  # [rows, full, chunk], a view
        parts.append(torch.stack([body.amin(2), body.amax(2),
                                  body.sum(2)], dim=2))
    if n % chunk:
        tail = x[:, full * chunk:]
        parts.append(torch.stack([tail.amin(1), tail.amax(1),
                                  tail.sum(1)], dim=1)[:, None])
    return torch.cat(parts, dim=1)


def qdq_tiled_apply_ref(x: torch.Tensor, partials: torch.Tensor,
                        num_bits: int = 8) -> torch.Tensor:
    """Plain version of the apply pass: fold each row's partials, then
    the round trip."""
    mn = partials[:, :, 0].amin(dim=1, keepdim=True)
    mx = partials[:, :, 1].amax(dim=1, keepdim=True)
    total = partials[:, :, 2].sum(dim=1, keepdim=True)
    mean = total / torch.full_like(total, x.shape[1])
    return _affine_roundtrip(x, mn, mx, mean, num_bits)


def qdq_tiled_ref(x: torch.Tensor, num_bits: int = 8) -> torch.Tensor:
    """Plain version of :func:`qdq_tiled`."""
    return qdq_tiled_apply_ref(x, qdq_tiled_stats_ref(x), num_bits)


def _nchunks(n: int) -> int:
    if -(-n // _CHUNK) > 2 ** 31 - 1:  # gridDim.x of the pair
        raise ValueError(f"n = {n} splits into more than 2^31 - 1 chunks "
                         f"of {_CHUNK}")
    return -(-n // _CHUNK)


def qdq_tiled_stats(x: torch.Tensor) -> torch.Tensor:
    """Stats pass of the pair on a float32 ``[rows, n]`` tensor: the
    ``[rows, nchunks, 3]`` partials. Kernel on CUDA, plain on the CPU."""
    global stats_launches
    _check(x, "qdq_tiled_stats", _MAX_TILED_ROWS)
    rows, n = x.shape
    nchunks = _nchunks(n)
    if x.device.type == "cpu":
        return qdq_tiled_stats_ref(x)
    partials = torch.empty((rows, nchunks, 3), dtype=torch.float32,
                           device=x.device)
    with torch.cuda.device(x.device):
        _launch(load_library().qdq_tiled_stats_f32, "qdq_tiled_stats_f32",
                x.data_ptr(), partials.data_ptr(), rows, n, _CHUNK)
    stats_launches += 1
    return partials


def qdq_tiled_apply(x: torch.Tensor, partials: torch.Tensor,
                    num_bits: int = 8) -> torch.Tensor:
    """Apply pass of the pair: the round trip of each row of ``x`` with
    the statistics folded from its ``partials`` (as :func:`qdq_tiled_stats`
    wrote them). Kernel on CUDA, plain on the CPU."""
    global apply_launches
    _check_bits(num_bits)
    _check(x, "qdq_tiled_apply", _MAX_TILED_ROWS)
    rows, n = x.shape
    want = (rows, _nchunks(n), 3)
    if (tuple(partials.shape) != want or partials.dtype != torch.float32
            or not partials.is_contiguous()
            or partials.device != x.device):
        raise ValueError(f"qdq_tiled_apply needs contiguous float32 "
                         f"partials of shape {want} on {x.device}, got "
                         f"{partials.dtype} {tuple(partials.shape)} on "
                         f"{partials.device}")
    if x.device.type == "cpu":
        return qdq_tiled_apply_ref(x, partials, num_bits)
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        _launch(load_library().qdq_tiled_apply_f32, "qdq_tiled_apply_f32",
                x.data_ptr(), partials.data_ptr(), out.data_ptr(), rows, n,
                _CHUNK, num_bits)
    apply_launches += 1
    return out


def qdq_tiled(x: torch.Tensor, num_bits: int = 8) -> torch.Tensor:
    """Per-row quantize -> dequantize of a float32 ``[rows, n]`` tensor
    through the multi-block pair: one stats and one apply launch."""
    return qdq_tiled_apply(x, qdq_tiled_stats(x), num_bits)


# -- entry points ------------------------------------------------------------

def fused_quantize_dequantize(x: torch.Tensor,
                              num_bits: int = 8) -> torch.Tensor:
    """Quantize -> dequantize of one tensor of any shape with its own
    statistics; same shape and dtype out. Routed as the JAX package's
    function of this name (quant_kernel.py:331-358): at most
    ``_MAX_ROW_ELEMS`` elements go through the row kernel as one row,
    longer tensors through the multi-block pair."""
    flat = x.reshape(1, -1).to(torch.float32).contiguous()
    if flat.shape[1] > _MAX_ROW_ELEMS:
        out = qdq_tiled(flat, num_bits)
    else:
        out = qdq_batch(flat, num_bits)
    return out.reshape(x.shape).to(x.dtype)


def fused_quantize_dequantize_tree(tree: dict, num_bits: int = 8,
                                   leading_batch: bool = False) -> dict:
    """Per-tensor quantize -> dequantize over a dict of tensors, bucketed
    by size: leaves of one size are stacked and served by ONE
    :func:`qdq_batch` launch, or, past ``_MAX_ROW_ELEMS`` elements, by one
    :func:`qdq_tiled` stats and one apply launch (per-row stats keep exact
    per-tensor semantics). A ResNet-20 payload has 65 leaves of 13 sizes,
    so 13 row launches; a WideResNet-28-10 payload has 80 leaves of 16
    sizes, 3 of them past the threshold, so 13 row launches and 3 of each
    of the pair.

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
        stacked = stacked.reshape(-1, n).to(torch.float32)
        if n > _MAX_ROW_ELEMS:
            q = qdq_tiled(stacked, num_bits)
        else:
            q = qdq_batch(stacked, num_bits)
        q = q.reshape(len(names), k, n)
        for j, m in enumerate(names):
            out[m] = q[j].reshape(tree[m].shape).to(tree[m].dtype)
    return {m: out[m] for m in tree}
