"""The port's multi-block quantizer pair, its single-tensor entry and the
tree function's routing, against the JAX package's.

``qdq_tiled`` runs its plain version (``qdq_tiled_stats_ref`` then
``qdq_tiled_apply_ref``, the twins of ``csrc/qdq_tiled.cu``) on CPU
tensors. It is held against ``_pallas_qdq_tiled`` (the
``_tiled_stats_kernel`` + ``_tiled_apply_kernel`` pair) in interpret
mode, as tests/test_pallas.py runs it, on the same numpy inputs.

Tolerances, and why. The Pallas pair sums (512, 128) tiles in sequence,
the port sums chunks of 8192 and then the chunk partials, so the means
differ in their last bits: every output moves by that difference and an
element on a rounding boundary flips by one step. The bar is one
quantization step of the row per element. Bitwise equality holds where
ROADMAP C says the reference allows it: against the Pallas pair on
exact-sum rows whose scale is exact too (the interpret-mode program
multiplies by the rounded 1/(qmax - qmin) and contracts the last line
into an FMA, neither of which changes a bit there); against the op-by-op
XLA quantizer on exact-sum rows of power-of-two length; and between the
port's own two plain versions on any exact-sum row.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import torch_threads  # noqa: F401 (two torch threads a worker)
import fedtorch_tpu.ops.pallas.quant_kernel as jqk
from fedtorch_tpu.ops.quantize import quantize_dequantize
from fedtorch_tpu_torch.ops.cuda import quant_kernel as qk


def _pallas_tiled(x, bits):
    """``_pallas_qdq_tiled`` in interpret mode on each row of ``x``,
    padded as ``fused_quantize_dequantize`` pads it."""
    out = []
    for row in x:
        n = row.size
        rows = -(-n // jqk._LANE)
        rows = -(-rows // jqk._TILE_ROWS) * jqk._TILE_ROWS
        padded = jnp.zeros((rows * jqk._LANE,), jnp.float32).at[:n].set(
            jnp.asarray(row))
        q = jqk._pallas_qdq_tiled(padded.reshape(rows, jqk._LANE),
                                  jnp.asarray([n], jnp.int32), bits,
                                  interpret=True)
        out.append(np.asarray(q).reshape(-1)[:n])
    return np.stack(out)


def _assert_within_one_step(got, want, x, bits):
    """Per element: one step of its row, plus the float32 rounding of the
    dequantized value."""
    qmin, qmax = qk.qrange(bits)
    step = (x.max(-1, keepdims=True) - x.min(-1, keepdims=True)) \
        / (qmax - qmin)
    step = np.where(step == 0, 1e-3, step)  # the scale floor
    err = np.abs(got - want) - step * (1 + 1e-5)
    assert np.all(err <= 1e-6 * np.abs(want) + 1e-7), float(err.max())


def _tiled(x, bits):
    t = torch.from_numpy(x)
    return qk.qdq_tiled_apply(t, qk.qdq_tiled_stats(t), bits).numpy()


@pytest.mark.parametrize("n, bits, chunk", [
    (600_000, 8, qk._CHUNK), (600_000, 16, qk._CHUNK),
    (524_289, 8, qk._CHUNK), (70_001, 16, 1000), (8193, 8, 4096),
    (1, 8, qk._CHUNK)])
def test_pair_matches_pallas_tiled(monkeypatch, n, bits, chunk):
    monkeypatch.setattr(qk, "_CHUNK", chunk)
    rng = np.random.RandomState(n % 1000 + bits)
    # distinct per-row scales and offsets: shared stats would show
    x = (rng.randn(3, n) * np.array([[0.01], [1.0], [40.0]])
         + np.array([[0.0], [3.0], [-7.0]])).astype(np.float32)
    _assert_within_one_step(_tiled(x, bits), _pallas_tiled(x, bits), x,
                            bits)


@pytest.mark.parametrize("n, bits", [(600_000, 8), (600_001, 8),
                                     (131_072, 16)])
def test_exact_scale_is_bitwise_against_pallas_tiled(n, bits):
    """Rows k/16 that hold both ends of the integer range: exact sums,
    scale exactly 1/16."""
    half = 2 ** (bits - 1)
    rng = np.random.RandomState(n + bits)
    k = rng.randint(-half, half, size=(2, n))
    k[:, 0], k[:, -1] = -half, half - 1
    x = (k / 16.0).astype(np.float32)
    np.testing.assert_array_equal(_tiled(x, bits), _pallas_tiled(x, bits))


@pytest.mark.parametrize("bits", [8, 16])
def test_dyadic_grid_is_bitwise_against_xla_and_the_row_kernel(bits):
    """k/16 with |k| <= 64 over 2^20 elements: every partial sum stays
    below 2^20 in magnitude and so is exact in any order, so the pair,
    the row kernel's plain version and (at a power-of-two length, where
    ``jnp.mean``'s 1/n is exact) the op-by-op XLA quantizer agree bit for
    bit."""
    rng = np.random.RandomState(bits)
    x = (rng.randint(-64, 65, size=(2, 2 ** 20)) / 16.0).astype(np.float32)
    x[1] += 0.5  # a row with a non-zero mean
    got = _tiled(x, bits)
    want = np.asarray(jax.vmap(lambda v: quantize_dequantize(v, bits))(
        jnp.asarray(x)))
    np.testing.assert_array_equal(got, want)
    ragged = np.ascontiguousarray(x[:, :600_001])
    np.testing.assert_array_equal(
        _tiled(ragged, bits),
        qk.qdq_batch_ref(torch.from_numpy(ragged), bits).numpy())


@pytest.mark.parametrize("bits", [8, 16])
def test_nan_inf_and_constant_rows(bits):
    """A NaN in chunk 0 survives the fold of the partials; an inf in a
    middle chunk and a -inf in the ragged last chunk poison only their
    own rows; a constant row takes the scale floor and comes back
    unchanged."""
    rng = np.random.RandomState(bits)
    n = 3 * 8192 + 100
    x = rng.randn(5, n).astype(np.float32)
    x[1, 5] = np.nan
    x[2, 8192 + 17] = np.inf
    x[3, n - 1] = -np.inf
    x[4] = 0.75
    got = _tiled(x, bits)
    want = _pallas_tiled(x, bits)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    assert np.isnan(got[1:4]).all() and not np.isnan(got[[0, 4]]).any()
    np.testing.assert_array_equal(got[4], x[4])
    np.testing.assert_array_equal(got[4], want[4])
    _assert_within_one_step(got[:1], want[:1], x[:1], bits)


def test_stats_partials_are_per_row_and_per_chunk(monkeypatch):
    """Each row's partials come only from its own chunks, including the
    ragged last one."""
    monkeypatch.setattr(qk, "_CHUNK", 4)
    x = np.arange(2 * 10, dtype=np.float32).reshape(2, 10)
    p = qk.qdq_tiled_stats(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(p[0], [[0, 3, 6], [4, 7, 22], [8, 9, 17]])
    np.testing.assert_array_equal(p[1], [[10, 13, 46], [14, 17, 62],
                                         [18, 19, 37]])


@pytest.mark.parametrize("shape, bits", [
    ((1,), 8), ((4097,), 16), ((64, 3, 3, 16), 8), ((524_288,), 8),
    ((524_289,), 8), ((3, 3, 160, 160), 16)])
def test_single_tensor_entry_matches_jax(shape, bits):
    """``fused_quantize_dequantize`` on both sides of 524,288 elements:
    the one-row kernel against ``_qdq_kernel``, the pair against the
    tiled Pallas pair (both in interpret mode); same shape and dtype
    out."""
    rng = np.random.RandomState(sum(shape) + bits)
    x = (rng.randn(*shape) * 0.05 + 0.01).astype(np.float32)
    want = np.asarray(jqk.fused_quantize_dequantize(
        jnp.asarray(x), bits, force_pallas=True, interpret=True))
    got = qk.fused_quantize_dequantize(torch.from_numpy(x), bits)
    assert got.shape == shape and got.dtype == torch.float32
    flat = x.reshape(1, -1)
    _assert_within_one_step(got.numpy().reshape(flat.shape),
                            want.reshape(flat.shape), flat, bits)


def test_single_tensor_entry_routes_by_size(monkeypatch):
    calls = []
    for name in ("qdq_batch", "qdq_tiled_stats", "qdq_tiled_apply"):
        real = getattr(qk, name)
        monkeypatch.setattr(qk, name, lambda *a, _n=name, _f=real, **kw:
                            calls.append(_n) or _f(*a, **kw))
    x = torch.ones(2, qk._MAX_ROW_ELEMS // 2, dtype=torch.bfloat16)
    out = qk.fused_quantize_dequantize(x, 8)
    assert calls == ["qdq_batch"] and out.dtype == torch.bfloat16
    calls.clear()
    qk.fused_quantize_dequantize(torch.ones(qk._MAX_ROW_ELEMS + 1), 8)
    assert calls == ["qdq_tiled_stats", "qdq_tiled_apply"]


def _leaves(rng, k):
    """Mixed leaf sizes: under both shrunk thresholds (200), over them
    (700, two leaves in one bucket, and 1500)."""
    lead = (k,) if k else ()
    shapes = {"a": (200,), "b": (10, 20), "big1": (700,),
              "big2": (7, 100), "huge": (3, 500)}
    return {name: (rng.randn(*lead, *s) * (i + 1)).astype(np.float32)
            for i, (name, s) in enumerate(shapes.items())}


@pytest.mark.parametrize("leading_batch", [True, False],
                         ids=["uplink", "downlink"])
def test_tree_routes_large_buckets_through_the_pair(monkeypatch,
                                                    leading_batch):
    """Both packages' thresholds shrunk to 256 elements: the JAX tree
    serves each oversize slice with the tiled Pallas pair, the port each
    oversize bucket with ONE stats and ONE apply call, and every leaf
    under the threshold with ONE ragged call; the values agree within one
    step per (tensor, client)."""
    monkeypatch.setattr(jqk, "_MAX_VMEM_ELEMS", 256)
    monkeypatch.setattr(qk, "_MAX_ROW_ELEMS", 256)
    calls = []
    for name in ("qdq_tiled_stats", "qdq_tiled_apply"):
        real = getattr(qk, name)
        monkeypatch.setattr(qk, name, lambda x, *a, _n=name, _f=real:
                            calls.append((_n, tuple(x.shape)))
                            or _f(x, *a))
    real_ragged = qk.qdq_ragged
    monkeypatch.setattr(qk, "qdq_ragged", lambda leaves, b: calls.append(
        ("qdq_ragged", tuple(tuple(x.shape) for x in leaves)))
        or real_ragged(leaves, b))
    k, bits = 3, 8
    flat = _leaves(np.random.RandomState(9), k if leading_batch else 0)
    want = jqk.fused_quantize_dequantize_tree(
        {n: jnp.asarray(v) for n, v in flat.items()}, bits,
        leading_batch=leading_batch, force_pallas=True, interpret=True)
    got = qk.fused_quantize_dequantize_tree(
        {n: torch.from_numpy(v) for n, v in flat.items()}, bits,
        leading_batch)
    rows = k if leading_batch else 1
    assert sorted(calls) == [
        ("qdq_ragged", ((rows, 200), (rows, 200))),
        ("qdq_tiled_apply", (rows, 1500)),
        ("qdq_tiled_apply", (2 * rows, 700)),
        ("qdq_tiled_stats", (rows, 1500)),
        ("qdq_tiled_stats", (2 * rows, 700))]
    assert list(got) == list(flat)
    for name, x in flat.items():
        assert got[name].shape == x.shape
        r = x.reshape(rows, -1)
        _assert_within_one_step(got[name].numpy().reshape(r.shape),
                                np.asarray(want[name]).reshape(r.shape),
                                r, bits)


def test_cpu_pair_counts_no_launch():
    x = torch.from_numpy(np.random.RandomState(3).randn(4, 20_000)
                         .astype(np.float32))
    before = (qk.launches, qk.stats_launches, qk.apply_launches)
    np.testing.assert_array_equal(qk.qdq_tiled(x, 8).numpy(),
                                  qk.qdq_tiled_ref(x, 8).numpy())
    qk.fused_quantize_dequantize(x[0], 8)
    assert (qk.launches, qk.stats_launches, qk.apply_launches) == before


@pytest.mark.parametrize("bad, partials, match", [
    (torch.ones(65536, 2), None, "rows"),
    (torch.ones(2, 10, dtype=torch.float64), None, "float32"),
    (torch.ones(3, 2).t(), None, "contiguous"),
    (torch.ones(2, 10), torch.zeros(2, 1, 3), "partials"),
    (torch.ones(2, 10), torch.zeros(2, 2, 3, dtype=torch.float64),
     "partials"),
    (torch.ones(2, 10, device="meta"), None, "cuda or cpu"),
], ids=["rows", "f64", "strided", "nchunks", "partials-f64", "meta"])
def test_pair_refuses_what_the_kernels_do_not_take(monkeypatch, bad,
                                                    partials, match):
    monkeypatch.setattr(qk, "_CHUNK", 8)
    with pytest.raises(ValueError, match=match):
        if partials is None:
            qk.qdq_tiled(bad, 8)
        else:
            qk.qdq_tiled_apply(bad, partials, 8)
