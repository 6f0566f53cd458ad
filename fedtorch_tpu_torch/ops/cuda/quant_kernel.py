"""Adaptive quantize -> dequantize: the Hopper kernels, their plain
PyTorch versions, the single-tensor entry and the tree function.

Port of ``fedtorch_tpu/ops/pallas/quant_kernel.py``. Two kernel files,
bound through ``ctypes`` (``build.py``); their headers say what bounds
them and why they are built the way they are:

* ``csrc/qdq_ragged.cu`` (``_qdq_batch_kernel``, and ``_qdq_kernel`` as
  its one-row case): :func:`qdq_ragged`, a stats launch that writes
  per-chunk partial ``[min, max, sum]`` and an apply launch that folds
  them and writes the round trip, over every row of a list of float32
  ``[rows, n]`` leaves of at most ``_MAX_ROW_ELEMS`` elements per row,
  read in place; :func:`qdq_batch` is its one-leaf call;
* ``csrc/qdq_tiled.cu`` (``_tiled_stats_kernel`` + ``_tiled_apply_kernel``):
  :func:`qdq_tiled`, the same two passes over one ``[rows, n]`` tensor of
  longer rows.

Each row gets its own statistics. On a CPU tensor a wrapper runs its
plain version; on a CUDA tensor it launches the kernel or raises — there
is no fallback. Each launch adds one to its kernel's counter
(``ragged_stats_launches``, ``ragged_apply_launches``, ``stats_launches``,
``apply_launches``; ``launches`` counts the ragged pair's launches, one
per stats + apply), so a run can show which kernels its path went
through.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from fedtorch_tpu_torch.ops.cuda.build import load_library

# kernel launches so far (reset them to 0 before the run they should count)
launches = 0               # the ragged pair (one per stats + apply launch)
ragged_stats_launches = 0  # qdq_ragged_stats_f32
ragged_apply_launches = 0  # qdq_ragged_apply_f32
stats_launches = 0         # qdq_tiled_stats_f32
apply_launches = 0         # qdq_tiled_apply_f32

# Rows longer than this take the multi-block pair qdq_tiled; the JAX
# package's single-block ceiling (_MAX_VMEM_ELEMS), kept so both packages
# route a tensor the same way.
_MAX_ROW_ELEMS = 512 * 1024
# Elements per block of both pairs (csrc/qdq_tiled.cu says why).
_CHUNK = 8192
_MAX_ROWS = 2 ** 31 - 1       # gridDim.x of the ragged pair
_MAX_TILED_ROWS = 65535       # gridDim.y of qdq_tiled
# Leaves per launch of the ragged pair: its table's capacity
# (kMaxLeaves in csrc/qdq_ragged.cu).
_TABLE_LEAVES = 1000


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
    the ragged pair on CUDA (one leaf), the plain version on the CPU."""
    _check_bits(num_bits)
    _check(x, "qdq_batch", _MAX_ROWS)
    if x.device.type == "cpu":
        return qdq_batch_ref(x, num_bits)
    return qdq_ragged([x], num_bits)[0]


# -- the ragged pair ---------------------------------------------------------

def qdq_ragged_stats_ref(leaves) -> torch.Tensor:
    """Plain version of the ragged stats pass: the ``[total_chunks, 3]``
    partial ``[min, max, sum]`` of each ``_CHUNK`` elements of each row of
    each leaf (the last chunk of a row ragged), leaf by leaf, row by row,
    as the kernel's grid lays them out."""
    return torch.cat([qdq_tiled_stats_ref(x).reshape(-1, 3) for x in leaves])


def qdq_ragged_apply_ref(leaves, partials: torch.Tensor,
                         num_bits: int = 8) -> list:
    """Plain version of the ragged apply pass: each row's partials folded
    in a fixed order, then the round trip."""
    out, base = [], 0
    for x in leaves:
        rows, n = x.shape
        m = rows * _nchunks(n)
        out.append(qdq_tiled_apply_ref(
            x, partials[base:base + m].reshape(rows, -1, 3), num_bits))
        base += m
    return out


def qdq_ragged_ref(leaves, num_bits: int = 8) -> list:
    """Plain version of :func:`qdq_ragged`."""
    return qdq_ragged_apply_ref(leaves, qdq_ragged_stats_ref(leaves),
                                num_bits)


def _check_leaves(leaves, name: str) -> None:
    for x in leaves:
        _check(x, name, _MAX_ROWS)
        if x.device != leaves[0].device:
            raise ValueError(f"{name} takes leaves on one device, got "
                             f"{leaves[0].device} and {x.device}")


def ragged_launches(shapes) -> list:
    """The ragged pair's launches for leaves of ``shapes`` ``[(rows, n)]``:
    for each launch, the indices of its leaves and each leaf's first
    chunk in the launch's grid. A launch takes at most ``_TABLE_LEAVES``
    leaves and ``_MAX_ROWS`` chunks."""
    out, cur, base = [], [], 0
    for i, (rows, n) in enumerate(shapes):
        m = rows * _nchunks(n)
        if m > _MAX_ROWS:
            raise ValueError(f"a [{rows}, {n}] leaf splits into more than "
                             f"2^31 - 1 chunks of {_CHUNK}")
        if cur and (len(cur) == _TABLE_LEAVES or base + m > _MAX_ROWS):
            out.append(cur)
            cur, base = [], 0
        cur.append((i, base))
        base += m
    return out + [cur] if cur else out


@functools.lru_cache(maxsize=256)
def _structure(shapes: tuple, table_leaves: int, max_rows: int,
               chunk: int) -> tuple:
    """The ragged pair's launches for leaves of ``shapes``, built once
    per tree structure (and capacity): for each launch, its leaves'
    indices, its table's int64 records with the n and first-chunk
    columns filled, and its chunk count."""
    out = []
    for launch in ragged_launches(shapes):
        rec = np.zeros((len(launch), 4), np.int64)
        rec[:, 2] = [shapes[i][1] for i, _ in launch]
        rec[:, 3] = [base for _, base in launch]
        i, base = launch[-1]
        out.append(([i for i, _ in launch], rec,
                    base + shapes[i][0] * _nchunks(shapes[i][1])))
    return tuple(out)


def _launches(leaves) -> tuple:
    return _structure(tuple(tuple(x.shape) for x in leaves), _TABLE_LEAVES,
                      _MAX_ROWS, _CHUNK)


def _table(rec: np.ndarray, leaves, outs, idx) -> int:
    """One launch's leaf table (4 int64 per leaf: input pointer, output
    pointer, n, first chunk) in host memory: the structure's records
    with this call's pointers. Returns its address; ``rec`` must live
    through the launch."""
    rec[:, 0] = [leaves[i].data_ptr() for i in idx]
    rec[:, 1] = [outs[i].data_ptr() for i in idx]
    return rec.ctypes.data


def qdq_ragged_stats(leaves) -> torch.Tensor:
    """Stats pass of the ragged pair over a list of float32 ``[rows, n]``
    leaves: the ``[total_chunks, 3]`` partials. Kernel on CUDA, plain on
    the CPU."""
    global ragged_stats_launches
    _check_leaves(leaves, "qdq_ragged_stats")
    plan = _launches(leaves)
    if not leaves or leaves[0].device.type == "cpu":
        return qdq_ragged_stats_ref(leaves) if leaves \
            else torch.empty((0, 3))
    partials = torch.empty((sum(m for _, _, m in plan), 3),
                           dtype=torch.float32, device=leaves[0].device)
    lib = load_library()
    with torch.cuda.device(partials.device):
        base = 0
        for idx, rec, m in plan:
            # the stats pass writes no output: its table's output pointers
            # are the inputs'
            rec = rec.copy()
            _launch(lib.qdq_ragged_stats_f32, "qdq_ragged_stats_f32",
                    _table(rec, leaves, leaves, idx), len(idx),
                    partials[base:].data_ptr(), m, _CHUNK)
            ragged_stats_launches += 1
            base += m
    return partials


def qdq_ragged_apply(leaves, partials: torch.Tensor,
                     num_bits: int = 8) -> list:
    """Apply pass of the ragged pair: the round trip of each row of each
    leaf with the statistics folded from its ``partials`` (as
    :func:`qdq_ragged_stats` wrote them). Kernel on CUDA, plain on the
    CPU. On CUDA the outputs are views of one buffer, each starting on a
    16-byte boundary."""
    global ragged_apply_launches, launches
    _check_bits(num_bits)
    _check_leaves(leaves, "qdq_ragged_apply")
    plan = _launches(leaves)
    want = (sum(x.shape[0] * _nchunks(x.shape[1]) for x in leaves), 3)
    dev = leaves[0].device if leaves else partials.device
    if (tuple(partials.shape) != want or partials.dtype != torch.float32
            or not partials.is_contiguous() or partials.device != dev):
        raise ValueError(f"qdq_ragged_apply needs contiguous float32 "
                         f"partials of shape {want} on {dev}, got "
                         f"{partials.dtype} {tuple(partials.shape)} on "
                         f"{partials.device}")
    if not leaves or dev.type == "cpu":
        return qdq_ragged_apply_ref(leaves, partials, num_bits)
    offsets, total = [], 0
    for x in leaves:
        offsets.append(total)
        total += -(-x.numel() // 4) * 4
    buf = torch.empty(total, dtype=torch.float32, device=dev)
    outs = [buf[o:o + x.numel()].view(x.shape)
            for o, x in zip(offsets, leaves)]
    lib = load_library()
    with torch.cuda.device(dev):
        base = 0
        for idx, rec, m in plan:
            rec = rec.copy()
            _launch(lib.qdq_ragged_apply_f32, "qdq_ragged_apply_f32",
                    _table(rec, leaves, outs, idx), len(idx),
                    partials[base:].data_ptr(), m, _CHUNK, num_bits)
            ragged_apply_launches += 1
            launches += 1
            base += m
    return outs


def qdq_ragged(leaves, num_bits: int = 8) -> list:
    """Per-row quantize -> dequantize of every row of a list of
    contiguous float32 ``[rows, n]`` leaves on one device, each row with
    its own statistics: one stats and one apply launch on CUDA (more past
    ``_TABLE_LEAVES`` leaves), the plain version on the CPU."""
    return qdq_ragged_apply(leaves, qdq_ragged_stats(leaves), num_bits)


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
    ``_MAX_ROW_ELEMS`` elements go through the ragged pair as one row,
    longer tensors through the multi-block pair."""
    flat = x.reshape(1, -1).to(torch.float32).contiguous()
    if flat.shape[1] > _MAX_ROW_ELEMS:
        out = qdq_tiled(flat, num_bits)
    else:
        out = qdq_batch(flat, num_bits)
    return out.reshape(x.shape).to(x.dtype)


def fused_quantize_dequantize_tree(tree: dict, num_bits: int = 8,
                                   leading_batch: bool = False) -> dict:
    """Per-tensor quantize -> dequantize over a dict of tensors. Every
    leaf of at most ``_MAX_ROW_ELEMS`` elements (per client) goes into
    ONE :func:`qdq_ragged` call, read in place; leaves past it are
    bucketed by size, stacked and served by one :func:`qdq_tiled` stats
    and one apply launch per bucket. Per-row stats keep exact per-tensor
    semantics. A ResNet-20 payload has 65 leaves, all on the ragged pair;
    a WideResNet-28-10 payload 80, 65 on the ragged pair and 15 in 3
    buckets of the tiled pair.

    ``leading_batch=True`` is the uplink layout: each leaf carries a
    leading ``[k]`` client axis and is read as ``[k, n]`` (buckets of the
    tiled pair key on (k, per-client size) and stack to ``[b*k, n]``), so
    stats stay per (tensor, client)."""
    rows_path, buckets = [], {}
    for name, x in tree.items():
        k = x.shape[0] if leading_batch else 1
        n = x.numel() // k
        if n > _MAX_ROW_ELEMS:
            buckets.setdefault((k, n), []).append(name)
        else:
            rows_path.append((name, k, n))
    out = {}
    if rows_path:
        leaves = [tree[m].reshape(k, n).to(torch.float32).contiguous()
                  for m, k, n in rows_path]
        for (m, _, _), q in zip(rows_path, qdq_ragged(leaves, num_bits)):
            out[m] = q.reshape(tree[m].shape).to(tree[m].dtype)
    for (k, n), names in buckets.items():
        stacked = torch.stack([tree[m].reshape(k, n) for m in names])
        q = qdq_tiled(stacked.reshape(-1, n).to(torch.float32), num_bits)
        q = q.reshape(len(names), k, n)
        for j, m in enumerate(names):
            out[m] = q[j].reshape(tree[m].shape).to(tree[m].dtype)
    return {m: out[m] for m in tree}
