"""The bf16 tensor-core flash forward (``csrc/flash_fwd_sm90.cu``) on the
CPU: the routes and input checks of both forward kernels, and the bf16
kernel's arithmetic against the JAX package's oracle.

The kernels run only on the card (``tests/test_torch_cuda.py`` and
``chip_smoke.py`` hold them against the plain version there). Here
:func:`_route` and :func:`_check_inputs` are checked on CPU tensors laid
out as the model makes them,
and :func:`_emulate` repeats the kernel's arithmetic in float32 torch ops
(64-key tiles up to head dim 128 and 32-key tiles past it, 64-row
warpgroups; at head dim 512 a cluster of two CTAs, S as their partials
over 256 columns each summed in rank order, each CTA's P V on its 256
columns; online softmax, p split into bf16 hi + lo for P V, float32 sums)
on the same numpy inputs as the JAX package's ``_fwd_xla``. The bar
is the card's: lse within 2e-5 (abs and rel), bfloat16 o within the
float32 bar plus one bfloat16 spacing, the same NaN pattern.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

import torch_threads  # noqa: F401 (two torch threads a worker)
from fedtorch_tpu.ops.pallas.flash_attention import _fwd_xla
from fedtorch_tpu_torch.ops.cuda import flash_attention as fa

WG = 64  # query rows of a consumer warpgroup


def _bk(D):
    """The instance's keys per tile (``Cfg::kBK``)."""
    return 32 if D > 128 else 64


def _dv(D):
    """The columns of S's partials, of V and of O a CTA holds
    (``Cfg::kDC``): all of them, or at head dim 512 (a cluster of
    ``Cfg::kCluster`` = 2 CTAs) its half."""
    return D // 2 if D > 256 else D


def _qkv_views(B, T, H, D, dtype, offset=0, seed=0):
    """Strided [B, T, H, D] thirds of one projection, as the model makes
    them (``offset`` > 0 shifts them off 16-byte alignment)."""
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.randn(B, T, 3 * H * D + offset).astype(
        np.float32)).to(dtype)[..., offset:]
    return tuple(c.view(B, T, H, D) for c in x.chunk(3, dim=-1))


def test_route_sends_strided_bf16_head_dim_64_to_the_tensor_cores():
    q, k, v = _qkv_views(2, 300, 4, 64, torch.bfloat16)
    assert q.stride() == (300 * 768, 768, 64, 1)
    assert fa._route(q, k, v) == "tc"
    # contiguous inputs and a size-1 batch with an odd stride too
    c = tuple(t.contiguous() for t in (q, k, v))
    assert fa._route(*c) == "tc"
    one = tuple(t[:1] for t in (q, k, v))
    odd = tuple(torch.as_strided(t, t.shape, (7,) + t.stride()[1:])
                for t in one)
    assert fa._route(*odd) == "tc"
    assert fa._tc_strides(odd[0]) == (300 * 4 * 64, 768, 64)


@pytest.mark.parametrize("dtype, D, offset", [
    (torch.float32, 64, 0), (torch.bfloat16, 16, 0), (torch.bfloat16, 32, 0),
    (torch.bfloat16, 128, 0), (torch.bfloat16, 64, 1),
    (torch.float32, 64, 1)])
def test_route_sends_everything_else_to_the_simt_kernel(dtype, D, offset):
    """Everything but aligned bf16 at head dim 64 or 128 takes the TF32
    kernel, which replaced the SIMT one (the name is the test's first)."""
    q, k, v = _qkv_views(2, 129, 4, D, dtype, offset)
    tc = dtype == torch.bfloat16 and D in fa.TC_HEAD_DIMS and offset == 0
    assert fa._route(q, k, v) == ("tc" if tc else "tf32")


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [136, 192, 256])
def test_route_past_head_dim_128(D, dtype, offset):
    """Aligned bf16 at 192 and 256 takes the wgmma kernel's wide
    instances; float32, bf16 at 136 and misaligned views the TF32
    kernel."""
    q, k, v = _qkv_views(2, 129, 4, D, dtype, offset)
    fa._check_inputs(q, k, v)
    tc = dtype == torch.bfloat16 and D in (192, 256) and offset == 0
    assert fa._route(q, k, v) == ("tc" if tc else "tf32")


def test_route_needs_strides_of_eight_elements():
    x = torch.zeros(2, 40, 3 * 4 * 64 + 4, dtype=torch.bfloat16)[..., :768]
    q, k, v = (c.view(2, 40, 4, 64) for c in x.chunk(3, dim=-1))
    assert q.stride()[1] == 772 and fa._route(q, k, v) == "tf32"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [1, 8, 24, 25, 50, 100, 128])
def test_every_head_dim_up_to_128_takes_a_kernel(D, dtype):
    """The default transformer (rnn_hidden_size 50: 4 heads of 25) and
    every other head dim up to 128 pass the kernels' input check and take
    a route, as the JAX package takes any head dim."""
    for offset in (0, 1):
        q, k, v = _qkv_views(2, 33, 4, D, dtype, offset)
        fa._check_inputs(q, k, v)
        want = "tc" if dtype == torch.bfloat16 and D in fa.TC_HEAD_DIMS \
            and offset == 0 else "tf32"
        assert fa._route(q, k, v) == want


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_every_head_dim_up_to_256_takes_a_kernel(dtype):
    """Past 128: the TF32 kernel's padded widths 192 and 256 and the
    wgmma kernel's instances at 192 and 256."""
    for D in (129, 136, 192, 200, 255, 256):
        for offset in (0, 1):
            q, k, v = _qkv_views(1, 9, 2, D, dtype, offset)
            fa._check_inputs(q, k, v)
            want = "tc" if dtype == torch.bfloat16 and D in (192, 256) \
                and offset == 0 else "tf32"
            assert fa._route(q, k, v) == want


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [257, 320, 384, 512, 1024])
def test_route_past_head_dim_256(D, dtype, offset):
    """Aligned bf16 at 512 takes the wgmma kernel's D-512 instance;
    float32, bf16 at 257, 320, 384 and 1024, and misaligned views the
    TF32 kernel's clusters."""
    q, k, v = _qkv_views(1, 9, 2, D, dtype, offset)
    fa._check_inputs(q, k, v)
    tc = dtype == torch.bfloat16 and D == 512 and offset == 0
    assert fa._route(q, k, v) == ("tc" if tc else "tf32")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_no_head_dim_is_refused(dtype):
    """The JAX package's kernel takes any head dim, and so do the port's
    routes: 257, 512 and 1024 pass the input check as 136 and 256 do.
    What stays refused by name: float16, mixed dtypes, and T past the
    route's grid (65,535 query tiles of 128 rows on both routes, the
    wgmma kernel's D-512 cluster too: 8,388,480 rows)."""
    for D in (136, 256, 257, 512, 1024):
        fa._check_inputs(*_qkv_views(1, 8, 2, D, dtype))
    half = _qkv_views(1, 8, 2, 512, torch.float16)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        fa._check_inputs(*half)
    q, k, v = _qkv_views(1, 8, 2, 512, dtype)
    with pytest.raises(ValueError, match="one dtype"):
        fa._check_inputs(q, k.to(torch.float16), v)
    T = 65535 * 128 + 1  # zero-stride views: no memory behind the rows
    big = torch.zeros(1, 1, 1, 512, dtype=dtype).expand(1, T, 1, 512)
    route = "tc" if dtype == torch.bfloat16 else "tf32"
    assert fa._route(big, big, big) == route
    with pytest.raises(ValueError, match=f"8388480 .route '{route}'"):
        fa._check_inputs(big, big, big)
    fa._check_inputs(*(t[:, :T - 1] for t in (big, big, big)))


def test_load_mode_follows_the_alignment():
    """16-byte copies for the model's float32 views at D 64, 4-byte ones
    at D 25 (rows of 100 bytes) and for even-aligned bf16, element loads
    for bf16 views off 4-byte alignment."""
    assert fa._load_mode(*_qkv_views(2, 9, 4, 64, torch.float32)) == 2
    assert fa._load_mode(*_qkv_views(2, 9, 4, 25, torch.float32)) == 1
    assert fa._load_mode(*_qkv_views(2, 9, 4, 64, torch.float32, 1)) == 1
    assert fa._load_mode(*_qkv_views(2, 9, 4, 64, torch.bfloat16, 2)) == 1
    assert fa._load_mode(*_qkv_views(2, 9, 4, 64, torch.bfloat16, 1)) == 0
    assert fa._load_mode(*_qkv_views(2, 9, 4, 25, torch.bfloat16)) == 0


def _emulate(q, k, v, scale, causal, split=True, sanitize=True):
    """The kernel's arithmetic on float32 [BH, T, D] tensors holding
    bf16 values, in the instance's key tiles (:func:`_bk`): o (float32,
    before its bf16 rounding) and lse. S is the CTAs' partials over
    their columns (:func:`_dv`: at head dim 512 the cluster's two),
    summed in rank order. Causal, the rows of each 64-row warpgroup (and
    of its peer in the other CTA) take no tile wholly past their last
    row; P V runs on each CTA's columns. ``sanitize``: the
    non-finite v rule (the p_lo product reads the warpgroup's columns of
    the tile with non-finite elements 0, and a causal column is NaN in
    the rows of a warpgroup whose skipped tiles hold a non-finite v);
    without it, the kernel before that rule."""
    BH, T, D = q.shape
    BK, DV = _bk(D), _dv(D)
    rows = torch.arange(T)
    # each row's warpgroup's last row: its last tile is that row's
    wg_tile = (rows // WG * WG + WG - 1) // BK
    m = torch.full((BH, T), -np.inf)
    l = torch.zeros(BH, T)
    acc = torch.zeros(BH, T, D)
    for k0 in range(0, T, BK):
        kt, vt = k[:, k0:k0 + BK], v[:, k0:k0 + BK]
        s = 0.0
        for c0 in range(0, D, DV):  # each CTA's partial, in rank order
            s = s + torch.einsum("bqd,bkd->bqk", q[..., c0:c0 + DV],
                                 kt[..., c0:c0 + DV])
        s = s * scale
        if causal:
            keys = torch.arange(k0, k0 + kt.shape[1])
            s = s.masked_fill(keys[None, :] > rows[:, None], -np.inf)
        m_new = torch.maximum(m, s.amax(dim=-1))      # both keep NaN
        m_safe = torch.where(m_new.isfinite(), m_new, 0.0)
        corr = torch.where(m.isfinite(), torch.exp(m - m_safe),
                           torch.where(m == -np.inf, 0.0, 1.0))
        p = torch.where(s.isfinite(), torch.exp(s - m_safe[..., None]), 0.0)
        hi = p.to(torch.bfloat16).float()
        halves = []
        for c0 in range(0, D, DV):  # each CTA's columns
            vc = vt[..., c0:c0 + DV]
            pv = hi @ vc
            if split:
                v_lo = torch.where(vc.isfinite(), vc, 0.0) if sanitize \
                    else vc
                pv = pv + (p - hi).to(torch.bfloat16).float() @ v_lo
            halves.append(pv)
        pv = torch.cat(halves, dim=-1)
        take = (wg_tile >= k0 // BK) if causal \
            else torch.ones(T, dtype=torch.bool)
        l = torch.where(take, l * corr + p.sum(dim=-1), l)
        acc = torch.where(take[:, None], acc * corr[..., None] + pv, acc)
        m = torch.where(take, m_new, m)
    l_safe = torch.where(l.isnan(), l, l.clamp_min(1e-30))
    lse = torch.where(m.isfinite(), m, 0.0) + torch.log(l_safe)
    o = acc / l_safe[..., None]
    if causal and sanitize:
        # the pre-pass: each column's last non-finite key; the first key
        # a row's warpgroup skips
        bad = ~v.isfinite()
        last = torch.where(bad, torch.arange(T)[None, :, None], -1).amax(1)
        kc = (wg_tile + 1) * BK
        o = torch.where(last[:, None, :] >= kc[None, :, None], np.nan, o)
    return o, lse


def _bf16_excess(got, want):
    """Largest excess of |got - want| over the float32 bar (2e-5 abs +
    2e-5 rel), in bfloat16 spacings at the larger magnitude; NaN against
    NaN counts 0. At most 1 passes."""
    mag = torch.maximum(got.abs(), want.abs()).nan_to_num(0.0, 0.0, 0.0)
    spacing = torch.exp2(torch.floor(torch.log2(mag.clamp_min(2.0 ** -126)))
                         - 7)
    excess = ((got - want).abs() - 2e-5 - 2e-5 * want.abs()).clamp_min(0.0)
    same = (got == want) | (got.isnan() & want.isnan())
    return float(torch.where(same, 0.0, excess / spacing).max())


def _inputs(nonfinite, B=2, T=300, H=2, D=64):
    rng = np.random.RandomState(11)
    q, k, v = (rng.randn(B * H, T, D).astype(np.float32) for _ in range(3))
    if nonfinite:
        q[1, 5] = np.nan
        k[2, 3] = np.inf
    # bf16 values, as the kernel reads them
    return tuple(torch.from_numpy(a).to(torch.bfloat16).float()
                 for a in (q, k, v))


@pytest.mark.parametrize("nonfinite", [False, True])
@pytest.mark.parametrize("causal", [False, True])
def test_emulated_kernel_holds_the_bf16_bar_against_the_oracle(causal,
                                                               nonfinite):
    q, k, v = _inputs(nonfinite)
    scale = 0.125
    jo, jl = _fwd_xla(*(jnp.asarray(t.numpy(), jnp.bfloat16)
                        for t in (q, k, v)), scale, causal)
    want = torch.from_numpy(np.array(jo, np.float32))
    want_lse = torch.from_numpy(np.array(jl))
    o, lse = _emulate(q, k, v, scale, causal)
    got = o.to(torch.bfloat16).float()
    assert torch.equal(got.isnan(), want.isnan())
    assert torch.equal(lse.isnan(), want_lse.isnan())
    torch.testing.assert_close(lse, want_lse, rtol=2e-5, atol=2e-5,
                               equal_nan=True)
    assert _bf16_excess(got, want) <= 1.0
    if nonfinite:  # the NaN q row attends to nothing: o = 0
        assert float(got[1, 5].abs().max()) == 0.0

    # one bf16 rounding of p instead of the split: the reason for it
    o1, _ = _emulate(q, k, v, scale, causal, split=False)
    print(f"causal={causal} nonfinite={nonfinite}: split p "
          f"{_bf16_excess(got, want):.3f}, single bf16 p "
          f"{_bf16_excess(o1.to(torch.bfloat16).float(), want):.3f} bf16 "
          f"spacings past the float32 bar")


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("D", [192, 256, 512])
def test_emulated_wide_instances_hold_the_bf16_bar(D, causal):
    """The instances past head dim 128 (32-key tiles, P V over two or
    three of V's atoms; at 512 each CTA's P V over the four atoms of its
    half) at BH 2, T 130: lse within 2e-5, o within one bf16 spacing
    past the float32 bar of the oracle."""
    q, k, v = _inputs(False, B=1, T=130, H=2, D=D)
    scale = D ** -0.5
    jo, jl = _fwd_xla(*(jnp.asarray(t.numpy(), jnp.bfloat16)
                        for t in (q, k, v)), scale, causal)
    o, lse = _emulate(q, k, v, scale, causal)
    torch.testing.assert_close(lse, torch.from_numpy(np.array(jl)),
                               rtol=2e-5, atol=2e-5)
    assert _bf16_excess(o.to(torch.bfloat16).float(),
                        torch.from_numpy(np.array(jo, np.float32))) <= 1.0


def test_emulated_single_bf16_p_breaks_the_bar_at_the_main_path_length():
    """At T 2048 (the transformer path's length) one bf16 rounding of p
    lands outputs several bf16 spacings past the bar; the split stays
    within it."""
    q, k, v = _inputs(False, B=1, T=2048, H=1)
    jo, _ = _fwd_xla(*(jnp.asarray(t.numpy(), jnp.bfloat16)
                       for t in (q, k, v)), 0.125, True)
    want = torch.from_numpy(np.array(jo, np.float32))
    split = _bf16_excess(_emulate(q, k, v, 0.125, True)[0].to(
        torch.bfloat16).float(), want)
    single = _bf16_excess(_emulate(q, k, v, 0.125, True, split=False)[0].to(
        torch.bfloat16).float(), want)
    print(f"T 2048 causal: split p {split:.3f}, single bf16 p {single:.3f} "
          f"bf16 spacings past the float32 bar")
    assert split <= 1.0 < single



def _infinite_v(D, B=2, T=300, H=2):
    q, k, v = _inputs(False, B=B, T=T, H=H, D=D)
    v[1, 0, 11] = np.inf
    v[1, 40, 3] = np.inf
    v[1, 100, 3] = -np.inf
    v[1, 100, 7] = -np.inf
    v[2, 200, 9] = np.inf
    v[3, 299, 0] = -np.inf
    v[0, 150, D - 1] = np.inf
    return q, k, v


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("D", [64, 128, 256, 512])
def test_emulated_kernel_follows_the_infinite_v_rule(D, causal):
    """+inf and -inf v elements: with the p_lo product on the sanitized
    tile and the pre-pass's NaN columns, the kernel's arithmetic has the
    oracle's +-inf and NaN pattern and holds the bf16 bar elsewhere;
    without them (the kernel before the rule) p_lo beside an infinite v
    makes NaN where the oracle has +-inf, and the rows whose warpgroup
    skips the key's tile miss the oracle's NaN. At 512 the column D - 1
    lies in the second CTA's half."""
    q, k, v = _infinite_v(D)
    scale = D ** -0.5
    jo, jl = _fwd_xla(*(jnp.asarray(t.numpy(), jnp.bfloat16)
                        for t in (q, k, v)), scale, causal)
    want = torch.from_numpy(np.array(jo, np.float32))
    o, lse = _emulate(q, k, v, scale, causal)
    got = o.to(torch.bfloat16).float()
    torch.testing.assert_close(lse, torch.from_numpy(np.array(jl)),
                               rtol=2e-5, atol=2e-5)
    assert torch.equal(got.isnan(), want.isnan())
    assert torch.equal(got.isinf(), want.isinf())
    assert torch.equal(got[got.isinf()], want[want.isinf()])
    fin = want.isfinite()
    assert _bf16_excess(got[fin], want[fin]) <= 1.0
    assert bool((got[1, :, 11] == np.inf).all())
    assert bool(got[3, :299, 0].isnan().all()) == causal
    assert bool(got[0, :150, D - 1].isnan().all()) == causal

    old = _emulate(q, k, v, scale, causal, sanitize=False)[0].to(
        torch.bfloat16).float()
    assert not torch.equal(old.isnan(), want.isnan())


def test_max_t_at_head_dim_512():
    """The wgmma kernel's D-512 cluster holds 128 query rows, as every
    other instance and the TF32 kernel do: 65,535 query tiles of 128
    rows on both routes."""
    assert fa._max_t("tc", 512) == fa._max_t("tf32", 512) == 65535 * 128
    assert all(fa._max_t(r, d) == 65535 * 128
               for r in ("tc", "tf32") for d in (64, 256, 512, 1024))


def _oracles(q, k, v, scale, causal):
    """(o, lse) as float32 of the JAX package's ``_fwd_xla`` and of the
    port's ``flash_fwd_ref`` on the same bf16 [BH, T, D] values as [B,
    T, H, D] (one head)."""
    jo, jl = _fwd_xla(*(jnp.asarray(t.numpy(), jnp.bfloat16)
                        for t in (q, k, v)), scale, causal)
    ro, rl = fa.flash_fwd_ref(*(t.to(torch.bfloat16)[:, :, None]
                                for t in (q, k, v)), scale, causal)
    return ((torch.from_numpy(np.array(jo, np.float32)),
             torch.from_numpy(np.array(jl))),
            (ro[:, :, 0].float(), rl[:, 0]))


@pytest.mark.parametrize("T", [63, 130])
@pytest.mark.parametrize("causal", [False, True])
def test_emulated_cluster_holds_the_bf16_bar_against_both_oracles(causal,
                                                                  T):
    """The D-512 cluster: the two CTAs' partial S over 256 columns each,
    summed in rank order, and each CTA's P V on its columns, against
    the JAX package's ``_fwd_xla`` and the port's ``flash_fwd_ref``:
    lse within 2e-5, o within one bf16 spacing past the float32 bar."""
    q, k, v = _inputs(False, B=1, T=T, H=2, D=512)
    scale = 512 ** -0.5
    o, lse = _emulate(q, k, v, scale, causal)
    got = o.to(torch.bfloat16).float()
    for want_o, want_l in _oracles(q, k, v, scale, causal):
        torch.testing.assert_close(lse, want_l, rtol=2e-5, atol=2e-5)
        assert _bf16_excess(got, want_o) <= 1.0


def test_emulated_cluster_keeps_the_nonfinite_rules_across_partials():
    """Non-finite inputs in the two CTAs' columns at head dim 512,
    causal: a NaN q element in rank 0's columns (the row attends to
    nothing: o 0), a +inf k row element in rank 1's (the key scores NaN
    or +-inf), a -inf k element under q elements > 0 in rank 1's (p = 0,
    the max unmoved, so key 5's large scores do not overflow exp), and
    an infinite v in rank 1's columns at a key past the causal tiles of
    the earlier warpgroups' rows (NaN there). The rank-order sum keeps
    the oracles' NaN and +-inf pattern and the bar elsewhere."""
    q, k, v = _inputs(False, B=2, T=300, H=2, D=512)
    q[0, 9, 100] = np.nan
    k[1, 3, 400] = np.inf
    q[2, :, 300] = q[2, :, 300].abs() + 1
    k[2, 3, 300] = -np.inf
    k[2, 5] = 0.0
    k[2, 5, 300] = 1000.0
    v[3, 200, 450] = np.inf
    # bf16 values, as the kernel reads them
    q, k, v = (t.to(torch.bfloat16).float() for t in (q, k, v))
    o, lse = _emulate(q, k, v, 512 ** -0.5, True)
    got = o.to(torch.bfloat16).float()
    for want_o, want_l in _oracles(q, k, v, 512 ** -0.5, True):
        assert float(want_o[0, 9].abs().max()) == 0.0
        assert bool(want_o[3, :200, 450].isnan().all())
        assert bool((want_o[3, 200:, 450] == np.inf).all())
        assert bool(want_o[2].isfinite().all())
        assert torch.equal(lse.isnan(), want_l.isnan())
        fin = want_l.isfinite()
        torch.testing.assert_close(lse[fin], want_l[fin], rtol=2e-5,
                                   atol=2e-5)
        assert torch.equal(got.isnan(), want_o.isnan())
        assert torch.equal(got.isinf(), want_o.isinf())
        assert torch.equal(got[got.isinf()], want_o[want_o.isinf()])
        ok = want_o.isfinite()
        assert _bf16_excess(got[ok], want_o[ok]) <= 1.0


def _cfg_smem(D):
    """A mirror of ``Cfg<D>::kSmemBytes`` (``flash_fwd_sm90.cu``): Q, the
    K and V ring, the two sanitized V tiles, at D 512 (a cluster of two
    CTAs, 256 columns each) the two buffers of the peer's partial S for
    each consumer warpgroup, and 1 KB of alignment."""
    cluster = 2 if D > 256 else 1
    dc = D // cluster
    bk = 32 if D > 128 else 64
    stages = 3 if cluster > 1 else 4
    atoms = dc // 64
    q_bytes, kv_bytes = atoms * 128 * 128, atoms * bk * 128
    x_bytes = 64 * bk * 4 if cluster > 1 else 0
    return q_bytes + 2 * stages * kv_bytes + 2 * kv_bytes + 4 * x_bytes \
        + 1024


def test_cluster_instance_shared_memory_fits():
    """Every instance within the 232,448 B a block may take less the
    static barriers (128 B); D 256 at 230,400 B as before, and the D-512
    cluster's CTA (D 256's layout with a 3-stage ring and the exchange's
    buffers) at 230,400 B too; a 4-stage ring would not fit beside
    them."""
    sizes = {d: _cfg_smem(d) for d in fa.TC_HEAD_DIMS}
    assert all(v <= 232448 - 128 for v in sizes.values())
    assert sizes[256] == sizes[512] == 230400
    assert sizes[512] + 2 * 256 // 64 * 32 * 128 > 232448 - 128


def _wg_tiles(T, causal, block_y, grid_y, wg):
    """The tiles a consumer warpgroup of the wgmma kernel scores (n_wg),
    as the kernel computes them: from its CTA's query tile (blockIdx.y)
    and its warpgroup index, not the CTA's rank."""
    q0 = (grid_y - 1 - block_y) * 128
    k_end = min(q0 + 128, T) if causal else T
    n_tiles = -(-k_end // 32)
    last = q0 + 64 * wg + 63
    return min(n_tiles, last // 32 + 1) if causal else n_tiles


@pytest.mark.parametrize("causal", [False, True])
def test_cluster_warpgroup_pairs_exchange_equal_tile_counts(causal):
    """Each warpgroup of a D-512 CTA exchanges one partial a tile with
    the warpgroup of the same rows in the other CTA of its cluster, which
    shares its blockIdx.y: the pair scores the same tiles for every T,
    while the two warpgroups of one CTA may not (so the handshake is per
    pair, never CTA- or cluster-wide per tile)."""
    unequal = 0
    for T in range(1, 700):
        grid_y = -(-T // 128)
        for y in range(grid_y):
            for wg in (0, 1):
                pair = {_wg_tiles(T, causal, y, grid_y, wg)
                        for _rank in (0, 1)}
                assert len(pair) == 1 and min(pair) >= 1
            unequal += _wg_tiles(T, causal, y, grid_y, 0) \
                != _wg_tiles(T, causal, y, grid_y, 1)
    assert (unequal > 0) == causal
