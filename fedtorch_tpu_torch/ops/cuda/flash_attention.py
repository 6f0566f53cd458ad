"""Flash attention: the Hopper forward kernels, their plain PyTorch
version, the chunked backward and the public differentiable functions.

Port of ``fedtorch_tpu/ops/pallas/flash_attention.py``. The forward
(``_fwd_kernel``) has two hand-written kernels, bound through ``ctypes``
(``build.py``); each source's header says what bounds it and how it is
built. :func:`flash_fwd` picks one by :func:`_route`, from the inputs
alone:

- ``"tc"``, ``csrc/flash_fwd_sm90.cu`` (``flash_fwd_tc``): bfloat16 with
  head dim 64, 128, 192, 256 or 512, base pointers 16-byte aligned and
  the b, t and h strides multiples of 8 elements (what its TMA loads
  need). bf16 ``wgmma`` on the tensor cores, p split in two bf16 halves
  for P V; 64-key tiles up to head dim 128, 32-key tiles past it; at 512
  a cluster of two CTAs, each holding 256 of the columns, sums S's two
  partials through distributed shared memory.
- ``"tf32"``, ``csrc/flash_fwd_tf32.cuh`` (``flash_fwd_tf32``, whose
  entry is ``csrc/flash_fwd_tf32.cu``):
  everything else: float32 at any head dim, bfloat16 at the other head
  dims, misaligned or oddly strided views. ``mma.sync`` TF32 on the
  tensor cores with the 3xTF32 split, which keeps the float32 bar (one
  TF32 product would break it); 32-key tiles up to head dim 128, 16-key
  tiles past it. From 257 to 2048 a cluster of ceil(D / 256) CTAs (8 at
  most, the portable cluster size), each holding 256 of the columns,
  sums S's partials in rank order; past 2048 the chunked kernel gives each
  CTA a block of 256 of O's columns and sums S over the head dim in
  64-column chunks. :func:`cluster_plan` reads a cluster launch's plan
  on the card.

Each launch counts in ``flash_launches``, and in ``flash_tc_launches``
or ``flash_tf32_launches`` by its kernel. No head dim is refused: the
JAX package's kernel takes any, and so do the port's routes together.
What is refused by name: a dtype other than float32 and bfloat16, mixed
dtypes, a last-dim stride other than 1, and T past the route's grid
(:func:`_max_t`). On CPU tensors :func:`flash_fwd` runs
:func:`flash_fwd_ref`, the port of the JAX package's dense oracle
``_fwd_xla``. There is no fallback: a CUDA tensor goes to its route's
kernel or raises, and a failed launch is never retried on the other.

The backward is the JAX package's ``_bwd_chunked``: the probabilities
are recomputed from the saved logsumexp one ``block_q`` chunk of query
rows at a time, in float32 torch ops (it is plain XLA in the JAX
package, with no Pallas kernel), with the ``g_lse`` term when the
caller consumed the logsumexp. ``block_q`` follows the JAX package's
``_default_blocks`` and ``_divisor_block``, so the recompute sums in the
same chunks; the forward kernels' own tiles need not follow them, and
since they take any T the JAX package's route of oversized blocks to the
dense oracle (a VMEM limit) has no counterpart here.

Layouts are the JAX package's: q, k, v and o ``[B, T, H, D]``, the public
logsumexp ``[B, T, H]``; inside, the logsumexp is ``[B, H, T]`` float32.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from fedtorch_tpu_torch.ops.cuda.build import load_library

# kernel launches so far: both routes, then each route's own (reset to 0
# before the run they should count)
flash_launches = 0
flash_tc_launches = 0
flash_tf32_launches = 0

TC_HEAD_DIMS = (64, 128, 192, 256, 512)  # the bf16 wgmma kernel's instances
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _max_t(route: str, D: int) -> int:
    """The longest T a route's grid takes: gridDim.y counts query tiles of
    128 rows in every kernel and instance (the wgmma kernel's D-512
    instance too, since its cluster of two CTAs holds 128 rows)."""
    return 65535 * 128


def _default_blocks(T: int):
    """The JAX package's default (block_q, block_k) for a sequence
    length (flash_attention.py:368-383)."""
    return (128, 128) if T <= 2048 else (512, 512)


def _divisor_block(T: int, block: int) -> int:
    """Largest usable block that divides T, at most ``block``; divisors
    below 16 round up to one block of T (flash_attention.py:348-365)."""
    if T <= block:
        return T
    if T % block == 0:
        return block
    d = math.gcd(T, block)
    return d if d >= 16 else T


def _prep(q, k, v, scale: Optional[float], block_q: Optional[int]):
    """Check ``[B, T, H, D]`` q, k, v; the scale (default
    ``1/sqrt(D)``) and the backward's query chunk."""
    if q.dim() != 4:
        raise ValueError(f"flash attention takes [B, T, H, D] tensors, got "
                         f"q of shape {tuple(q.shape)}")
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(
            "flash attention requires q, k, v of identical shape "
            f"[B, T, H, D]; got q={tuple(q.shape)}, k={tuple(k.shape)}, "
            f"v={tuple(v.shape)}. For disjoint K/V partitions, run the "
            "kernel per equal-size block and merge with the returned "
            "logsumexp.")
    T, D = q.shape[1], q.shape[3]
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    if block_q is None:
        block_q = _default_blocks(T)[0]
    return scale, _divisor_block(T, block_q)


# -- the forward: plain version and kernel -----------------------------------

def _scores(q3, k3, scale: float, causal: bool, row0: int = 0):
    """float32 scores of query rows ``row0..`` against every key, masked
    to -inf past each row when causal. q3, k3: ``[BH, *, D]``."""
    s = torch.einsum("bqd,bkd->bqk", q3, k3) * scale
    if causal:
        q_pos = torch.arange(row0, row0 + q3.shape[1], device=q3.device)
        k_pos = torch.arange(k3.shape[1], device=q3.device)
        s = s.masked_fill(q_pos[:, None] < k_pos[None, :], -math.inf)
    return s


def _to_bh(t: torch.Tensor) -> torch.Tensor:
    """``[B, T, H, D]`` -> float32 ``[B*H, T, D]``."""
    B, T, H, D = t.shape
    return t.to(torch.float32).transpose(1, 2).reshape(B * H, T, D)


def flash_fwd_ref(q, k, v, scale: float, causal: bool):
    """Plain version of the forward (the JAX package's ``_fwd_xla``):
    ``(o [B, T, H, D] in q's dtype, lse [B, H, T] float32)``."""
    B, T, H, D = q.shape
    s = _scores(_to_bh(q), _to_bh(k), scale, causal)
    m = s.amax(dim=-1, keepdim=True)          # keeps NaN, as jnp.max
    m_safe = torch.where(torch.isfinite(m), m, 0.0)
    p = torch.exp(s - m_safe)
    p = torch.where(torch.isfinite(s), p, 0.0)
    l_safe = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)  # keeps NaN
    o = torch.einsum("bqk,bkd->bqd", p / l_safe, _to_bh(v))
    lse = (m_safe + torch.log(l_safe))[..., 0]
    o = o.reshape(B, H, T, D).transpose(1, 2).to(q.dtype)
    return o, lse.reshape(B, H, T)


def _check_inputs(q, k, v) -> None:
    """What the kernels take, on any device: one dtype of float32 or
    bfloat16, any head dim >= 1, a last-dim stride of 1, 1 <= T <= the
    route's :func:`_max_t` and at least one (batch, head) pair."""
    B, T, H, D = q.shape
    if q.dtype not in _DTYPES:
        raise ValueError(f"flash_fwd takes float32 or bfloat16, got "
                         f"{q.dtype}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_fwd needs one dtype, got q {q.dtype}, k "
                         f"{k.dtype}, v {v.dtype}")
    if D < 1:
        raise ValueError(f"flash_fwd needs a head dim >= 1, got {D}")
    if any(t.stride(3) != 1 for t in (q, k, v)):
        raise ValueError("flash_fwd needs a last-dim stride of 1")
    route = _route(q, k, v)
    if not 1 <= T <= _max_t(route, D) or B * H < 1:
        raise ValueError(f"flash_fwd needs 1 <= T <= {_max_t(route, D)} "
                         f"(route {route!r}) and B*H >= 1, got shape "
                         f"{tuple(q.shape)}")


def _check_kernel_inputs(q, k, v) -> None:
    if q.device.type != "cuda":
        raise ValueError(f"flash_fwd runs on cuda or cpu, got {q.device}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("flash_fwd needs q, k, v on one device")
    _check_inputs(q, k, v)


def _tc_strides(t):
    """b, t and h element strides for the tensor-core kernel's TMA maps:
    a dimension of size 1 is never stepped, so its stride is replaced by
    the contiguous one."""
    B, T, H, D = t.shape
    dense = (T * H * D, H * D, D)
    return tuple(d if n == 1 else st
                 for n, st, d in zip((B, T, H), t.stride()[:3], dense))


def _route(q, k, v) -> str:
    """``"tc"`` for bfloat16 q, k, v with a head dim of ``TC_HEAD_DIMS``
    whose base pointers are 16-byte aligned and whose b, t, h strides are
    multiples of 8 elements (sizes of 1 excepted); ``"tf32"`` for anything
    else. Depends on dtype, head dim and alignment only."""
    if q.dtype != torch.bfloat16 or q.shape[3] not in TC_HEAD_DIMS \
            or any(t.dtype != torch.bfloat16 for t in (k, v)):
        return "tf32"
    aligned = all(t.data_ptr() % 16 == 0
                  and all(st % 8 == 0 for st in _tc_strides(t))
                  for t in (q, k, v))
    return "tc" if aligned else "tf32"


def _outputs(q):
    B, T, H, D = q.shape
    return (torch.empty((B, T, H, D), dtype=q.dtype, device=q.device),
            torch.empty((B, H, T), dtype=torch.float32, device=q.device))


def _load_mode(q, k, v) -> int:
    """How the TF32 kernel copies q, k and v into shared memory: 2 for
    16-byte ``cp.async`` (every base pointer, b/t/h stride and row of D
    elements on 16-byte boundaries), 1 for 4-byte ``cp.async`` (always
    for float32; bfloat16 needs 4-byte pointers and even strides and D),
    0 for element loads (the misaligned bfloat16 views)."""
    el = q.element_size()

    def fits(nbytes):
        return (q.shape[3] * el) % nbytes == 0 and all(
            t.data_ptr() % nbytes == 0
            and all(st * el % nbytes == 0 for st in t.stride()[:3])
            for t in (q, k, v))
    return 2 if fits(16) else 1 if fits(4) else 0


def fwd_ops(B: int, T: int, H: int, D: int, causal: bool) -> float:
    """The forward's operations: q K^T and P V, 2 x D each per (query,
    key) pair, over T(T+1)/2 pairs a (batch, head) when causal, T^2
    otherwise (17.2 GFLOP at (8, 2048, 4, 64), causal)."""
    pairs = T * (T + 1) / 2 if causal else T * T
    return 4.0 * B * H * D * pairs


def cluster_plan(route: str, dtype: torch.dtype, D: int):
    """A route's cluster launch at head dim D on the current card, as its
    kernel reports it: ``(CTAs a cluster, a CTA's dynamic shared memory in
    bytes, cudaOccupancyMaxActiveClusters)``, or None where the route
    launches no cluster at D (the wgmma kernel but at 512; the TF32
    kernel up to 256 and past 2048), as the kernel says (-1)."""
    lib = load_library()
    out = (ctypes.c_int * 3)()
    err = lib.flash_tc_cluster_info(D, out) if route == "tc" \
        else lib.flash_tf32_cluster_info(D, _DTYPES[dtype], out)
    if err == -1:
        return None
    if err != 0:
        raise RuntimeError(f"flash {route} cluster query failed: error {err}")
    return tuple(out)


def _launch_tf32(q, k, v, scale: float, causal: bool):
    """``csrc/flash_fwd_tf32.cuh`` on checked CUDA inputs."""
    global flash_launches, flash_tf32_launches
    B, T, H, D = q.shape
    o, lse = _outputs(q)
    # the pre-pass's last non-finite v key of each (b*h, column), then of
    # each b*h
    last = torch.empty(B * H * (D + 1), dtype=torch.int32, device=q.device)
    with torch.cuda.device(q.device):
        err = load_library().flash_fwd_tf32(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), last.data_ptr(), B, T, H, D, *q.stride()[:3],
            *k.stride()[:3], *v.stride()[:3], scale, int(causal),
            _DTYPES[q.dtype],
            _load_mode(q, k, v), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_fwd_tf32 launch failed: error {err} "
                           "(-1: a head dim below 1, else a CUDA error, "
                           "such as a cluster that cannot be placed)")
    flash_launches += 1
    flash_tf32_launches += 1
    return o, lse


def _launch_tc(q, k, v, scale: float, causal: bool):
    """``csrc/flash_fwd_sm90.cu`` on checked CUDA inputs that
    :func:`_route` sends to ``"tc"``."""
    global flash_launches, flash_tc_launches
    B, T, H, D = q.shape
    o, lse = _outputs(q)
    # the pre-pass's last non-finite v key of each (b*h, column)
    last = torch.empty(B * H * D, dtype=torch.int32, device=q.device)
    with torch.cuda.device(q.device):
        err = load_library().flash_fwd_tc(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), last.data_ptr(), B, T, H, D, *_tc_strides(q),
            *_tc_strides(k),
            *_tc_strides(v), scale, int(causal),
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_fwd_tc launch failed: error {err} (-2: "
                           "no tensor-map encoder, -3: a map refused, "
                           "-1: a head dim it does not take, else a CUDA "
                           "error)")
    flash_launches += 1
    flash_tc_launches += 1
    return o, lse


def flash_fwd(q, k, v, scale: float, causal: bool):
    """The forward on ``[B, T, H, D]`` q, k, v (any strides with a
    last-dim stride of 1): ``(o [B, T, H, D], lse [B, H, T] float32)``.
    On CUDA tensors the kernel :func:`_route` picks (a dtype, layout or
    length that no kernel takes raises); the plain version on CPU
    tensors."""
    if q.device.type == "cpu":
        return flash_fwd_ref(q, k, v, scale, causal)
    _check_kernel_inputs(q, k, v)
    launch = _launch_tc if _route(q, k, v) == "tc" else _launch_tf32
    return launch(q, k, v, scale, causal)


# -- the backward ------------------------------------------------------------

def _bwd_chunked(q, k, v, o, lse, g, g_lse, scale: float, causal: bool,
                 block_q: int):
    """The JAX package's ``_bwd_chunked``: q, k, v, o, g ``[B, T, H,
    D]``, lse and g_lse (or None) ``[B, H, T]``; returns dq, dk, dv in
    the inputs' dtypes. float32 inside; live memory O(T * block_q)."""
    B, T, H, D = q.shape
    q3, k3, v3, o3, g3 = (_to_bh(t) for t in (q, k, v, o, g))
    lse3 = lse.reshape(B * H, T)
    gl3 = None if g_lse is None else g_lse.to(torch.float32).reshape(B * H,
                                                                      T)
    delta = (g3 * o3).sum(dim=-1)                # rowsum(do * o), [BH, T]
    dq = torch.empty_like(q3)
    dk, dv = torch.zeros_like(k3), torch.zeros_like(v3)
    for r0 in range(0, T, block_q):
        rows = slice(r0, r0 + block_q)
        q_i, g_i = q3[:, rows], g3[:, rows]
        s = _scores(q_i, k3, scale, causal, r0)  # [BH, bq, T]
        p = torch.exp(s - lse3[:, rows, None])
        p = torch.where(torch.isfinite(s), p, 0.0)
        dv += torch.einsum("bqk,bqd->bkd", p, g_i)
        dp = torch.einsum("bqd,bkd->bqk", g_i, v3)
        dp = dp - delta[:, rows, None]
        if gl3 is not None:
            dp = dp + gl3[:, rows, None]
        ds = p * dp * scale
        dq[:, rows] = torch.einsum("bqk,bkd->bqd", ds, k3)
        dk += torch.einsum("bqk,bqd->bkd", ds, q_i)

    def back(t, like):
        return t.reshape(B, H, T, D).transpose(1, 2).to(like.dtype)

    return back(dq, q), back(dk, k), back(dv, v)


class _Flash(torch.autograd.Function):
    """The forward through :func:`flash_fwd`, the backward through
    :func:`_bwd_chunked`; outputs ``(o, lse [B, H, T])``, both
    differentiable."""

    @staticmethod
    def forward(ctx, q, k, v, scale, causal, block_q):
        o, lse = flash_fwd(q, k, v, scale, causal)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.args = (scale, causal, block_q)
        ctx.set_materialize_grads(False)
        return o, lse

    @staticmethod
    def backward(ctx, g_o, g_lse):
        q, k, v, o, lse = ctx.saved_tensors
        if g_o is None:
            g_o = torch.zeros_like(o)
        dq, dk, dv = _bwd_chunked(q, k, v, o, lse, g_o, g_lse, *ctx.args)
        return dq, dk, dv, None, None, None


def flash_attention_with_lse(q, k, v, causal: bool = False,
                             scale: Optional[float] = None,
                             block_q: Optional[int] = None):
    """Exact attention, ``[B, T, H, D]`` in and out, and its logsumexp
    ``[B, T, H]`` float32 — the statistic that merges attention over
    disjoint K/V blocks. Differentiable in both outputs. ``block_q`` is
    the backward's query chunk (default: the JAX package's). Where no
    gradient is recorded (evaluation under ``torch.inference_mode``) the
    forward runs alone and saves nothing for a backward."""
    scale, block_q = _prep(q, k, v, scale, block_q)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        o, lse = _Flash.apply(q, k, v, scale, causal, block_q)
    else:
        o, lse = flash_fwd(q, k, v, scale, causal)
    return o, lse.transpose(1, 2)


def flash_attention(q, k, v, causal: bool = False,
                    scale: Optional[float] = None,
                    block_q: Optional[int] = None):
    """Exact attention, ``[B, T, H, D]`` in and out, differentiable; the
    kernel on CUDA tensors, the plain version on CPU tensors."""
    return flash_attention_with_lse(q, k, v, causal, scale, block_q)[0]
