"""The TF32 flash forward (``csrc/flash_fwd_tf32.cuh``) on the CPU: why its
products are 3xTF32, by emulation against the JAX package's oracle.

The kernel runs only on the card (``tests/test_torch_cuda.py`` and
``chip_smoke.py`` hold it against the plain version there). Here
:func:`_emulate` repeats its arithmetic in float32 torch ops on the same
numpy inputs as the JAX package's ``_fwd_xla``: TF32 rounding emulated by
bit operations (round to nearest on 10 mantissa bits, ties away from
zero, as ``cvt.rna.tf32.f32``), the split x = hi + lo with hi = tf32(x)
and lo = x - hi, which the tensor cores read truncated to TF32 (its low
13 bits dropped), each product a_hi b_hi + a_hi b_lo + a_lo b_hi (TF32
products are exact in float32), 32-key tiles (16 past head dim 128) with
the online softmax, l summed from p before its split; past head dim 256
the cluster's layout (up to 2048): each CTA's partial S over its 256
columns, the hi and the cross products apart, summed over the CTAs in
rank order before the cross products are added, and P V on each CTA's
256 columns; past 2048 the chunked kernel's: S summed over 64-column
chunks of D and P V in blocks of 256 of O's columns. The bar is the
card's: o and lse within atol = rtol = 2e-5 (bfloat16 o: one bfloat16
spacing past that).

What the CPU cannot show is the tensor cores' own accumulation (its order
and rounding inside an ``mma.sync``); only the card checks that, in the
tests and ``chip_smoke.py`` named above.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

import torch_threads  # noqa: F401 (two torch threads a worker)
from fedtorch_tpu.ops.pallas.flash_attention import _fwd_xla
from fedtorch_tpu_torch.ops.cuda import flash_attention as fa

def _bk(D):
    """The kernel's keys per tile at head dim D (``Layout::kBK``, and
    ``Wide::kBK`` past 256)."""
    return 16 if D > 128 else 32


MAX_CLUSTER = 8  # ``kMaxCluster``: the cluster kernel up to 8 x 256


def _layout(D):
    """(columns of a partial of S's sum over D, columns of O a CTA owns):
    the whole head dim up to 256; a cluster CTA's 256 columns up to
    ``MAX_CLUSTER`` x 256; past it ``Chunked::kDC`` and ``Chunked::kDV``."""
    if D <= 256:
        return D, D
    return (256, 256) if D <= 256 * MAX_CLUSTER else (64, 256)


def _tf32(x):
    """float32 -> the nearest TF32 value (10 mantissa bits), ties away
    from zero; +-inf stay as they are."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _truncate(x):
    """float32 -> TF32 by dropping the low 13 mantissa bits, as the tensor
    cores read a float32 operand."""
    return (x.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def _split(x):
    hi = _tf32(x)
    return hi, _truncate(x - hi)


def _product(eq, a, b, split, guard=False, b_guard=False, chunk=None):
    """einsum of TF32 operands: three products of the split, or one of
    the rounded values. ``guard``: the cross products are added only
    where the hi products' sum is finite, as the kernel's q K^T adds
    them. ``b_guard``: a non-finite element of b enters only the hi
    product (its hi and lo are 0 in the cross products), as the kernel's
    P V takes v. ``chunk``: the contraction (a's and b's last dim, as in
    q K^T) in partials over ``chunk`` columns, summed in their order (the
    cluster's rank order), the hi and the cross products each in their
    own sum."""
    if not split:
        return torch.einsum(eq, _tf32(a), _tf32(b))
    (ah, al), (bh, bl) = _split(a), _split(b)
    bhx, blx = bh, bl  # the cross products' b
    if b_guard:
        fin = b.isfinite()
        bhx, blx = torch.where(fin, bh, 0.0), torch.where(fin, bl, 0.0)
    hi = cross = 0.0
    for c0 in range(0, a.shape[-1], chunk or a.shape[-1]):
        c = slice(c0, c0 + chunk) if chunk else slice(None)
        hi = hi + torch.einsum(eq, ah[..., c], bh[..., c])
        cross = cross + (torch.einsum(eq, al[..., c], bhx[..., c])
                         + torch.einsum(eq, ah[..., c], blx[..., c]))
    return torch.where(hi.isfinite(), hi + cross, hi) if guard \
        else cross + hi


def _emulate(q, k, v, scale, causal, split=True, guard=True,
             v_guard=True):
    """The kernel's arithmetic on float32 [BH, T, D] tensors: o, lse
    (``guard`` for q K^T and ``v_guard`` for P V: see :func:`_product`),
    in the layout of :func:`_layout`. It computes every tile, the masked
    ones too: where the kernel skips a tile past a warp's rows, its
    pre-pass reproduces what a masked tile gives (a non-finite v there
    makes the column NaN)."""
    BH, T, D = q.shape
    BK, (DC, DV) = _bk(D), _layout(D)
    rows = torch.arange(T)
    m = torch.full((BH, T), -np.inf)
    l = torch.zeros(BH, T)
    acc = torch.zeros(BH, T, D)
    for k0 in range(0, T, BK):
        kt, vt = k[:, k0:k0 + BK], v[:, k0:k0 + BK]
        s = _product("bqd,bkd->bqk", q, kt, split, guard, chunk=DC) * scale
        if causal:
            keys = torch.arange(k0, k0 + kt.shape[1])
            s = s.masked_fill(keys[None, :] > rows[:, None], -np.inf)
        m_new = torch.maximum(m, s.amax(dim=-1))
        m_safe = torch.where(m_new.isfinite(), m_new, 0.0)
        corr = torch.where(m.isfinite(), torch.exp(m - m_safe),
                           torch.where(m == -np.inf, 0.0, 1.0))
        p = torch.where(s.isfinite(), torch.exp(s - m_safe[..., None]), 0.0)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.cat([
            _product("bqk,bkd->bqd", p, vt[..., c0:c0 + DV], split,
                     b_guard=v_guard) for c0 in range(0, D, DV)], dim=-1)
        m = m_new
    l_safe = torch.where(l.isnan(), l, l.clamp_min(1e-30))
    lse = torch.where(m.isfinite(), m, 0.0) + torch.log(l_safe)
    return acc / l_safe[..., None], lse


def _excess(got, want):
    """Largest |got - want| past the bar 2e-5 + 2e-5 |want| (<= 0
    passes)."""
    return float(((got - want).abs() - 2e-5 - 2e-5 * want.abs()).max())


def test_tf32_rounding_is_round_to_nearest_on_ten_bits():
    x = torch.tensor([1.0, 1.0 + 2.0 ** -11, 1.0 + 3 * 2.0 ** -12,
                      -(1.0 + 2.0 ** -11), 1.0 + 2.0 ** -11 - 2.0 ** -23,
                      3.0e-3])
    want = torch.tensor([1.0, 1.0 + 2.0 ** -10, 1.0 + 2.0 ** -10,
                         -(1.0 + 2.0 ** -10), 1.0,
                         float(np.float32(3.0e-3))])
    got = _tf32(x)
    assert torch.equal(got[:5], want[:5])
    # 10 mantissa bits: the low 13 of 23 are zero, within half a spacing
    assert int(got[5:].view(torch.int32) & 0x1FFF) == 0
    assert abs(float(got[5]) - 3.0e-3) <= 2.0 ** -9 * 2.0 ** -11


@pytest.mark.parametrize("D", [64, 128])
def test_3xtf32_holds_the_bar_where_one_tf32_product_breaks_it(D):
    """At T 2048 (the transformer path's length), causal: the 3xTF32
    split of Q K^T and P V stays within 2e-5 of the oracle in o and lse;
    one TF32 product of each lands past it."""
    rng = np.random.RandomState(21 + D)
    q, k, v = (torch.from_numpy(rng.randn(1, 2048, D).astype(np.float32))
               for _ in range(3))
    scale = D ** -0.5
    jo, jl = _fwd_xla(*(jnp.asarray(t.numpy()) for t in (q, k, v)), scale,
                      True)
    want_o = torch.from_numpy(np.array(jo))
    want_l = torch.from_numpy(np.array(jl))
    o3, l3 = _emulate(q, k, v, scale, True)
    o1, l1 = _emulate(q, k, v, scale, True, split=False)
    three = max(_excess(o3, want_o), _excess(l3, want_l))
    one = max(_excess(o1, want_o), _excess(l1, want_l))
    print(f"D {D}, T 2048 causal: 3xTF32 worst excess over the bar "
          f"{three:.3e}, one TF32 product {one:.3e}")
    assert three <= 0.0 < one


def test_a_nonfinite_input_enters_only_the_hi_products():
    """A -inf k element under q elements > 0: float32 scores -inf there
    (p = 0, the running max unmoved). Its split is hi = -inf, lo = NaN,
    so its cross products are NaN. Summed into the score, they make it
    NaN, the max with it, and key 5's scores (>= 125) then overflow exp;
    added only where the hi products' sum is finite, as the kernel adds
    them, o and lse hold the bar and stay finite."""
    rng = np.random.RandomState(5)
    q, k, v = (torch.from_numpy(rng.randn(1, 257, 64).astype(np.float32))
               for _ in range(3))
    q[0, :, 0] = q[0, :, 0].abs() + 1
    k[0, 3, 0] = -np.inf
    k[0, 5] = 0.0
    k[0, 5, 0] = 1000.0
    jo, jl = _fwd_xla(*(jnp.asarray(t.numpy()) for t in (q, k, v)), 0.125,
                      True)
    want_o = torch.from_numpy(np.array(jo))
    want_l = torch.from_numpy(np.array(jl))
    o, lse = _emulate(q, k, v, 0.125, True)
    assert bool(o.isfinite().all()) and bool(lse.isfinite().all())
    assert max(_excess(o, want_o), _excess(lse, want_l)) <= 0.0
    o, lse = _emulate(q, k, v, 0.125, True, guard=False)
    assert not bool(lse[0, 5:].isfinite().any())


def _hold_nonfinite(got, want):
    """The same NaN and +-inf pattern, the finite elements within the
    bar."""
    assert torch.equal(got.isnan(), want.isnan())
    assert torch.equal(got.isinf(), want.isinf())
    assert torch.equal(got[got.isinf()], want[want.isinf()])
    fin = want.isfinite()
    assert _excess(got[fin], want[fin]) <= 0.0


def test_an_infinite_v_enters_only_the_hi_product():
    """+inf and -inf v elements, causal: the oracle's o is +-inf in the
    column where the row's p > 0 meets them, NaN where +inf and -inf
    meet, and NaN in the rows before the key, whose p = 0 multiplies
    them (0 inf). With the cross products taking 0 for a non-finite v,
    the split matches that pattern and holds the bar elsewhere; with the
    split as it was (lo = inf - inf = NaN, and p_lo inf NaN where p_lo =
    0 or of the other sign), a column whose rows see an infinity is NaN
    throughout."""
    rng = np.random.RandomState(6)
    q, k, v = (torch.from_numpy(rng.randn(1, 257, 64).astype(np.float32))
               for _ in range(3))
    v[0, 0, 11] = np.inf
    v[0, 40, 3] = np.inf
    v[0, 100, 3] = -np.inf
    v[0, 100, 7] = -np.inf
    v[0, 200, 9] = np.inf
    jo, jl = _fwd_xla(*(jnp.asarray(t.numpy()) for t in (q, k, v)), 0.125,
                      True)
    want_o = torch.from_numpy(np.array(jo))
    want_l = torch.from_numpy(np.array(jl))
    # the oracle's pattern: NaN before the key (p = 0), +-inf from it on,
    # NaN where +inf and -inf meet
    assert bool((want_o[0, :, 11] == np.inf).all())
    assert bool(want_o[0, :, 3].isnan().all())
    assert bool(want_o[0, :100, 7].isnan().all())
    assert bool((want_o[0, 100:, 7] == -np.inf).all())
    assert bool(want_o[0, :200, 9].isnan().all())
    assert bool((want_o[0, 200:, 9] == np.inf).all())
    assert bool(want_o[0, :, [0, 1, 2, 4]].isfinite().all())
    o, lse = _emulate(q, k, v, 0.125, True)
    _hold_nonfinite(o, want_o)
    assert _excess(lse, want_l) <= 0.0
    o, _ = _emulate(q, k, v, 0.125, True, v_guard=False)
    assert bool(o[0, :, 11].isnan().any())
    assert bool(o[0, 200:, 9].isnan().any())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("D", [136, 200, 256, 257, 384, 512, 1024])
def test_wide_instances_hold_the_bar(D, causal, dtype):
    """The padded widths 192 and 256 (16-key tiles) and, past 256, the
    clusters' partials of S over 256-column blocks, at BH 2, T 130: 3xTF32
    in float32; in bfloat16 (values exact in TF32) one product for
    q K^T and the two of the p split for P V, o within one bfloat16
    spacing past the float32 bar."""
    rng = np.random.RandomState(D)
    q, k, v = (torch.from_numpy(rng.randn(2, 130, D).astype(np.float32))
               for _ in range(3))
    if dtype == "bfloat16":
        q, k, v = (t.to(torch.bfloat16).float() for t in (q, k, v))
    scale = D ** -0.5
    jo, jl = _fwd_xla(*(jnp.asarray(t.numpy(), dtype) for t in (q, k, v)),
                      scale, causal)
    want_o = torch.from_numpy(np.array(jo, np.float32))
    o, lse = _emulate(q, k, v, scale, causal)
    assert _excess(lse, torch.from_numpy(np.array(jl))) <= 0.0
    if dtype == "float32":
        assert _excess(o, want_o) <= 0.0
    else:
        got = o.to(torch.bfloat16).float()
        spacing = torch.exp2(torch.floor(torch.log2(torch.maximum(
            got.abs(), want_o.abs()).clamp_min(2.0 ** -126))) - 7)
        excess = ((got - want_o).abs() - 2e-5 - 2e-5 * want_o.abs())
        assert float((excess / spacing).max()) <= 1.0


def test_an_infinite_v_at_head_dim_256():
    """The infinite-v rule in 16-key tiles: the oracle's +-inf and NaN
    pattern, the finite elements within the bar."""
    rng = np.random.RandomState(7)
    q, k, v = (torch.from_numpy(rng.randn(1, 130, 256).astype(np.float32))
               for _ in range(3))
    v[0, 0, 11] = np.inf
    v[0, 40, 255] = np.inf
    v[0, 100, 255] = -np.inf
    v[0, 70, 200] = -np.inf
    jo, jl = _fwd_xla(*(jnp.asarray(t.numpy()) for t in (q, k, v)),
                      256 ** -0.5, True)
    want_o = torch.from_numpy(np.array(jo))
    assert bool((want_o[0, :, 11] == np.inf).all())
    assert bool(want_o[0, :, 255].isnan().all())
    assert bool(want_o[0, :70, 200].isnan().all())
    assert bool((want_o[0, 70:, 200] == -np.inf).all())
    o, lse = _emulate(q, k, v, 256 ** -0.5, True)
    _hold_nonfinite(o, want_o)
    assert _excess(lse, torch.from_numpy(np.array(jl))) <= 0.0


def test_an_infinite_v_past_head_dim_256():
    """The infinite-v rule in the column blocks at head dim 512: +-inf
    v elements in the second block (columns 256..511) and one in the
    first, causal; the oracle's +-inf and NaN pattern, the finite
    elements within the bar, lse within it; without the rule (the cross
    products on the infinite v) the second block's columns go NaN."""
    rng = np.random.RandomState(8)
    q, k, v = (torch.from_numpy(rng.randn(1, 130, 512).astype(np.float32))
               for _ in range(3))
    v[0, 0, 11] = np.inf
    v[0, 0, 300] = np.inf
    v[0, 40, 511] = np.inf
    v[0, 100, 511] = -np.inf
    v[0, 70, 400] = -np.inf
    jo, jl = _fwd_xla(*(jnp.asarray(t.numpy()) for t in (q, k, v)),
                      512 ** -0.5, True)
    want_o = torch.from_numpy(np.array(jo))
    assert bool((want_o[0, :, 300] == np.inf).all())
    assert bool(want_o[0, :, 511].isnan().all())
    assert bool(want_o[0, :70, 400].isnan().all())
    assert bool((want_o[0, 70:, 400] == -np.inf).all())
    o, lse = _emulate(q, k, v, 512 ** -0.5, True)
    _hold_nonfinite(o, want_o)
    assert _excess(lse, torch.from_numpy(np.array(jl))) <= 0.0
    o, _ = _emulate(q, k, v, 512 ** -0.5, True, v_guard=False)
    assert bool(o[0, :, 300].isnan().any())


def _oracles(q, k, v, scale, causal, dtype):
    """(o, lse) of the JAX package's ``_fwd_xla`` and of the port's plain
    version ``flash_fwd_ref`` on the same [BH, T, D] values as [B, T, H,
    D] (one head), both as float32."""
    jo, jl = _fwd_xla(*(jnp.asarray(t.numpy(), dtype) for t in (q, k, v)),
                      scale, causal)
    ro, rl = fa.flash_fwd_ref(*(t.to(getattr(torch, dtype))[:, :, None]
                                for t in (q, k, v)), scale, causal)
    return ((torch.from_numpy(np.array(jo, np.float32)),
             torch.from_numpy(np.array(jl))),
            (ro[:, :, 0].float(), rl[:, 0]))


def _hold_bar(o, lse, want_o, want_l, dtype):
    """lse and float32 o within 2e-5; bfloat16 o within one bfloat16
    spacing past that."""
    assert _excess(lse, want_l) <= 0.0
    if dtype == "float32":
        assert _excess(o, want_o) <= 0.0
    else:
        got = o.to(torch.bfloat16).float()
        spacing = torch.exp2(torch.floor(torch.log2(torch.maximum(
            got.abs(), want_o.abs()).clamp_min(2.0 ** -126))) - 7)
        excess = ((got - want_o).abs() - 2e-5 - 2e-5 * want_o.abs())
        assert float((excess / spacing).max()) <= 1.0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("D", [257, 320, 384, 512, 576, 1024])
def test_cluster_sum_holds_the_bar_against_both_oracles(D, causal, dtype):
    """The cluster of ceil(D / 256) CTAs: each CTA's partial S over its
    256 columns (the last CTA's 1 to 256), the hi and the cross products
    apart, summed over the CTAs in rank order, then the cross products
    added where the hi sum is finite; at BH 2, T 130 against the JAX
    package's ``_fwd_xla`` and the port's ``flash_fwd_ref``."""
    assert _layout(D) == (256, 256)
    rng = np.random.RandomState(100 + D)
    q, k, v = (torch.from_numpy(rng.randn(2, 130, D).astype(np.float32))
               for _ in range(3))
    if dtype == "bfloat16":
        q, k, v = (t.to(torch.bfloat16).float() for t in (q, k, v))
    scale = D ** -0.5
    o, lse = _emulate(q, k, v, scale, causal)
    for want_o, want_l in _oracles(q, k, v, scale, causal, dtype):
        _hold_bar(o, lse, want_o, want_l, dtype)


@pytest.mark.parametrize("D", [512, 576])
def test_cluster_sum_keeps_the_nonfinite_rules_across_partials(D):
    """Non-finite inputs in different CTAs' columns, causal: an infinite
    q element in the last CTA's columns (its row scores +-inf: o 0), a
    NaN q element in rank 0's (its row NaN throughout: o 0), a -inf k
    element under q elements > 0 in rank 1's columns (p = 0, the max
    unmoved, so key 5's large scores do not overflow exp), and, in
    another (batch, head), infinite v elements in rank 1's and the last
    CTA's columns, one at a key past the causal tiles of the earlier rows
    (NaN there, as the plain version's 0 inf). The partials' rank-order
    sum keeps the oracles' +-inf and NaN pattern and the bar
    elsewhere."""
    rng = np.random.RandomState(9)
    q, k, v = (torch.from_numpy(rng.randn(2, 130, D).astype(np.float32))
               for _ in range(3))
    q[0, 20, D - 1] = np.inf
    q[0, 9, 20] = np.nan
    q[0, :, 300] = q[0, :, 300].abs() + 1
    k[0, 3, 300] = -np.inf
    k[0, 5] = 0.0
    k[0, 5, 300] = 1000.0
    v[1, 120, 450] = np.inf
    v[1, 40, D - 2] = -np.inf
    scale = D ** -0.5
    o, lse = _emulate(q, k, v, scale, True)
    for want_o, want_l in _oracles(q, k, v, scale, True, "float32"):
        assert bool(want_o[1, :120, 450].isnan().all())
        assert bool((want_o[1, 120:, 450] == np.inf).all())
        assert float(want_o[0, 20].abs().max()) == 0.0
        assert float(want_o[0, 9].abs().max()) == 0.0
        assert bool(want_o[0, 21:].isfinite().all())
        _hold_nonfinite(o, want_o)
        _hold_nonfinite(lse, want_l)


def _tf32_smem(dtype, D):
    """A mirror of the TF32 kernels' shared memory at head dim D
    (``flash_fwd_tf32.cuh``): the narrow kernel's ``Layout`` at D's
    padded width, a cluster CTA's ``Cluster`` (the layout at 256 and the
    exchange's float4 slots), the chunked kernel's ``Chunked``."""
    el = 4 if dtype == "float32" else 2
    kthreads = 256

    def layout(dp):
        bk = 16 if dp > 128 else 32
        vs = dp + 4 if el == 4 else dp + 8
        return 128 * (dp + 8) * 4 + 2 * bk * ((dp + 8) + vs) * el
    if D <= 256:
        dp = next(w for w in (16, 32, 64, 128, 192, 256) if D <= w)
        return layout(dp)
    if D <= 256 * MAX_CLUSTER:
        vecs = (2 if el == 4 else 1) * 8 // 4
        return layout(256) + vecs * kthreads * 16
    return 2 * (128 + 16) * 72 * el + 2 * 16 * (260 if el == 4 else 264) * el


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cluster_shared_memory_fits_at_every_cluster_size(dtype):
    """Each CTA of a cluster holds the D-256 layout and the exchange's
    slots, whatever the cluster size: 218,624 B in float32 and 177,152 B
    in bfloat16, within the 232,448 B a block may take, for every head
    dim the route sends to a cluster (2 to 8 CTAs); a double-buffered
    exchange would not fit in float32."""
    sizes = {}
    for D in range(257, 256 * MAX_CLUSTER + 1):
        n = -(-D // 256)
        sizes.setdefault(n, set()).add(_tf32_smem(dtype, D))
    assert sorted(sizes) == list(range(2, MAX_CLUSTER + 1))
    want = 218624 if dtype == "float32" else 177152
    assert all(v == {want} for v in sizes.values())
    assert want <= 232448
    assert _tf32_smem(dtype, 256) + 2 * (want - _tf32_smem(dtype, 256)) \
        > 232448 or dtype == "bfloat16"
    assert _tf32_smem(dtype, 256 * MAX_CLUSTER + 1) <= 232448


def _cta_tiles(block_y, grid_y, T, causal):
    """The tiles a CTA of the TF32 kernel loads and every thread of it
    steps through (so crosses the cluster barriers of), as the kernel
    computes them: from its query tile (blockIdx.y) alone."""
    q0 = (grid_y - 1 - block_y) * 128
    k_end = min(q0 + 128, T) if causal else T
    return -(-k_end // 16)


@pytest.mark.parametrize("causal", [False, True])
def test_cluster_ctas_step_through_equal_tile_counts(causal):
    """The cluster's CTAs lie side by side on x and share blockIdx.y, so
    every CTA of a cluster steps through the same tiles (and crosses the
    same cluster barriers: three a tile and one after), for every T; the
    chunked kernel's grid gives no CTA fewer than one tile."""
    for T in range(1, 700):
        grid_y = -(-T // 128)
        for n in (2, 3, 8):
            for y in range(grid_y):
                counts = {_cta_tiles(y, grid_y, T, causal)
                          for _ in range(n)}  # one per rank
                assert len(counts) == 1 and min(counts) >= 1
