"""The port's ragged quantizer pair (``qdq_ragged``: one stats and one
apply launch over every row of a list of leaves) against the JAX
package's tree quantizer.

On CPU tensors ``qdq_ragged`` runs its plain version
(``qdq_ragged_stats_ref`` then ``qdq_ragged_apply_ref``, the twins of
``csrc/qdq_ragged.cu``). It is held against the JAX package's
``fused_quantize_dequantize_tree(..., force_pallas=True,
interpret=True)``, whose ``_qdq_batch_kernel`` runs in interpret mode as
tests/test_pallas.py runs it, on the same numpy inputs.

Tolerances, and why (ROADMAP C). The Pallas kernel sums a padded row in
one reduction, the port sums chunks of ``_CHUNK`` and then the chunk
partials, and the interpret-mode program multiplies by the rounded
1/(qmax - qmin) and contracts the last line into an FMA. So the means
differ in their last bits and an element on a rounding boundary flips by
one step: the bar is one quantization step of its (tensor, client) row
per element. Bitwise equality holds against the op-by-op XLA quantizer
on exact-sum rows of power-of-two length, and against the port's other
plain versions on any exact-sum row.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import torch_threads  # noqa: F401 (two torch threads a worker)
import fedtorch_tpu.ops.pallas.quant_kernel as jqk
from fedtorch_tpu.ops.quantize import quantize_dequantize
from fedtorch_tpu_torch.bridge import params_from_jax, params_to_jax
from fedtorch_tpu_torch.ops.cuda import quant_kernel as qk


def _assert_within_one_step(got, want, x, bits):
    """Per element: one step of its row, plus the float32 rounding of the
    dequantized value."""
    qmin, qmax = qk.qrange(bits)
    step = (x.max(-1, keepdims=True) - x.min(-1, keepdims=True)) \
        / (qmax - qmin)
    step = np.where(step == 0, 1e-3, step)  # the scale floor
    err = np.abs(got - want) - step * (1 + 1e-5)
    assert np.all(err <= 1e-6 * np.abs(want) + 1e-7), float(err.max())


def _jax_tree(flat, bits, k):
    """The JAX package's tree quantizer on ``flat`` (leaves [k, ...] on
    the uplink, k = 0 for the downlink), Pallas kernels in interpret
    mode."""
    out = jqk.fused_quantize_dequantize_tree(
        {n: jnp.asarray(v) for n, v in flat.items()}, bits,
        leading_batch=bool(k), force_pallas=True, interpret=True)
    return {n: np.asarray(v) for n, v in out.items()}


def _rows(flat, k):
    return [np.ascontiguousarray(v.reshape(k or 1, -1))
            for v in flat.values()]


def _ragged(rows, bits):
    return [q.numpy() for q in qk.qdq_ragged(
        [torch.from_numpy(r) for r in rows], bits)]


def _resnet8_shapes():
    from fedtorch_tpu.config import (
        DataConfig, ExperimentConfig, ModelConfig)
    from fedtorch_tpu.models import define_model
    cfg = ExperimentConfig(data=DataConfig(dataset="cifar10"),
                           model=ModelConfig(arch="resnet8")).finalize()
    shapes = jax.eval_shape(define_model(cfg, batch_size=2).init,
                            jax.random.key(1))
    return {"/".join(k.key for k in path): v.shape for path, v in
            jax.tree_util.tree_flatten_with_path(shapes)[0]}


# a transformer-shaped leaf set: the vocabulary (86), d_model-wide
# vectors, a matrix, and sizes that are not multiples of 4, so that later
# rows of a leaf start off 16-byte alignment
_LM_SHAPES = {"head_bias": (86,), "ln_scale": (256,), "mlp_bias": (1024,),
              "odd_a": (10,), "odd_b": (3, 7), "embed": (86, 16),
              "w": (64, 48)}


@pytest.mark.parametrize("k", [3, 0], ids=["uplink", "downlink"])
@pytest.mark.parametrize("bits", [8, 16])
@pytest.mark.parametrize("shapes", ["resnet8", "transformer"])
def test_ragged_matches_the_jax_tree(shapes, bits, k):
    """Every row of a ResNet-8 payload or of a transformer-shaped leaf
    set in one ragged call, against the JAX package's tree quantizer:
    within one step per (tensor, client)."""
    shapes = _resnet8_shapes() if shapes == "resnet8" else _LM_SHAPES
    rng = np.random.RandomState(bits + k)
    lead = (k,) if k else ()
    flat = {n: (rng.randn(*lead, *s) * 10.0 ** rng.randint(-3, 1)
                + rng.randn()).astype(np.float32)
            for n, s in shapes.items()}
    want = _jax_tree(flat, bits, k)
    rows = _rows(flat, k)
    for got, r, name in zip(_ragged(rows, bits), rows, flat):
        assert got.shape == r.shape
        _assert_within_one_step(got, want[name].reshape(r.shape), r, bits)


@pytest.mark.parametrize("bits", [8, 16])
def test_ragged_is_bitwise_against_xla_on_a_dyadic_grid(bits):
    """k/16 with |k| <= 64 over power-of-two rows spanning several
    chunks: every partial sum is exact in any order, and so is the mean
    (XLA's ``jnp.mean`` multiplies by the rounded 1/n, exact at a power
    of two), so the ragged pair, the op-by-op XLA quantizer and the row
    kernel's plain version agree bit for bit."""
    rng = np.random.RandomState(bits)
    rows = [(rng.randint(-64, 65, size=(r, n)) / 16.0).astype(np.float32)
            for r, n in ((3, 16), (1, 256), (2, 4096), (2, 32768))]
    rows[1] += 2.0  # a row with a non-zero mean
    for got, x in zip(_ragged(rows, bits), rows):
        want = np.asarray(jax.vmap(lambda v: quantize_dequantize(v, bits))(
            jnp.asarray(x)))
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(
            got, qk.qdq_batch_ref(torch.from_numpy(x), bits).numpy())


@pytest.mark.parametrize("bits", [8, 16])
def test_nan_inf_and_constant_rows_poison_only_their_own_row(monkeypatch,
                                                             bits):
    """With chunks of 64: a NaN in a row's first chunk survives the
    fold, a +inf in a middle chunk and a -inf in a ragged last chunk
    poison only their own (tensor, client) rows, a constant row takes the
    scale floor and comes back unchanged, and the other rows of the same
    leaves stay within one step of the JAX tree."""
    monkeypatch.setattr(qk, "_CHUNK", 64)
    rng = np.random.RandomState(bits)
    flat = {"a": rng.randn(3, 3 * 64 + 5).astype(np.float32),
            "b": rng.randn(3, 10).astype(np.float32),
            "c": rng.randn(3, 200).astype(np.float32)}
    flat["a"][0, 5] = np.nan
    flat["a"][1, 64 + 17] = np.inf
    flat["c"][2, 199] = -np.inf
    flat["b"][1] = 0.75
    want = _jax_tree(flat, bits, 3)
    got = dict(zip(flat, _ragged(_rows(flat, 3), bits)))
    bad = {("a", 0), ("a", 1), ("c", 2)}
    for name, x in flat.items():
        np.testing.assert_array_equal(np.isnan(got[name]),
                                      np.isnan(want[name]))
        for r in range(3):
            assert np.isnan(got[name][r]).all() == ((name, r) in bad)
            if (name, r) not in bad:
                _assert_within_one_step(got[name][r:r + 1],
                                        want[name][r:r + 1], x[r:r + 1],
                                        bits)
    np.testing.assert_array_equal(got["b"][1], flat["b"][1])


@pytest.mark.parametrize("chunk", [4, 12, 1000])
def test_small_chunks_span_many_with_a_ragged_last_one(monkeypatch, chunk):
    """``_CHUNK`` shrunk so that rows span many chunks, the last ragged:
    within one step of the JAX tree, and bitwise equal to the one-row
    plain version on exact-sum rows."""
    monkeypatch.setattr(qk, "_CHUNK", chunk)
    rng = np.random.RandomState(chunk)
    flat = {"a": (rng.randn(2, 3001) * 0.1 + 1.0).astype(np.float32),
            "b": rng.randn(2, 1, 86).astype(np.float32),
            "c": rng.randn(2, 7).astype(np.float32)}
    want = _jax_tree(flat, 8, 2)
    rows = _rows(flat, 2)
    for got, r, name in zip(_ragged(rows, 8), rows, flat):
        _assert_within_one_step(got, want[name].reshape(r.shape), r, 8)
    dyadic = [(rng.randint(-64, 65, size=(2, n)) / 16.0).astype(np.float32)
              for n in (3001, 86, 7)]
    for got, x in zip(_ragged(dyadic, 8), dyadic):
        np.testing.assert_array_equal(
            got, qk.qdq_batch_ref(torch.from_numpy(x), 8).numpy())


def test_partials_follow_the_grid_leaf_by_leaf_and_row_by_row(monkeypatch):
    """The stats pass's partials lie in the kernel's grid order: each
    leaf's rows, each row's chunks, the last one ragged."""
    monkeypatch.setattr(qk, "_CHUNK", 4)
    a = torch.arange(2 * 6, dtype=torch.float32).reshape(2, 6)
    b = torch.arange(3, dtype=torch.float32).reshape(1, 3) + 100
    p = qk.qdq_ragged_stats([a, b]).numpy()
    np.testing.assert_array_equal(p, [[0, 3, 6], [4, 5, 9], [6, 9, 30],
                                      [10, 11, 21], [100, 102, 303]])


def test_launches_split_at_the_table_capacity(monkeypatch):
    """A launch takes at most ``_TABLE_LEAVES`` leaves; each leaf's first
    chunk counts from 0 in its own launch."""
    monkeypatch.setattr(qk, "_CHUNK", 8)
    monkeypatch.setattr(qk, "_TABLE_LEAVES", 3)
    shapes = [(2, 8), (1, 9), (3, 1), (1, 20), (4, 17)]
    assert qk.ragged_launches(shapes) == [
        [(0, 0), (1, 2), (2, 4)], [(3, 0), (4, 3)]]
    assert qk.ragged_launches([]) == []


def test_tree_puts_every_row_path_leaf_into_one_ragged_call(monkeypatch):
    """The tree function hands every leaf at or below ``_MAX_ROW_ELEMS``
    per client to ONE ``qdq_ragged`` call, as ``[k, n]`` views in tree
    order, and the values match the JAX tree on a bridged ResNet-8
    uplink payload."""
    calls = []
    real = qk.qdq_ragged
    monkeypatch.setattr(qk, "qdq_ragged", lambda leaves, b: calls.append(
        [tuple(x.shape) for x in leaves]) or real(leaves, b))
    k, bits = 3, 8
    rng = np.random.RandomState(2)
    flat = {p: (rng.randn(k, *s) * 1e-2).astype(np.float32)
            for p, s in _resnet8_shapes().items()}
    want = _jax_tree(flat, bits, k)
    per_client = [params_from_jax({p: v[c] for p, v in flat.items()})
                  for c in range(k)]
    tree = {n: torch.stack([pc[n] for pc in per_client])
            for n in per_client[0]}
    got = qk.fused_quantize_dequantize_tree(tree, bits, leading_batch=True)
    assert calls == [[(k, v[0].numel()) for v in tree.values()]]
    assert list(got) == list(tree)
    gots = [params_to_jax({n: v[c] for n, v in got.items()})
            for c in range(k)]
    for p, x in flat.items():
        rows = x.reshape(k, -1)
        _assert_within_one_step(np.stack([g[p] for g in gots]).reshape(
            rows.shape), want[p].reshape(rows.shape), rows, bits)


def test_cpu_leaves_count_no_launch():
    rows = [torch.from_numpy(np.random.RandomState(3).randn(4, n)
                             .astype(np.float32)) for n in (5, 9000)]
    before = (qk.launches, qk.ragged_stats_launches,
              qk.ragged_apply_launches)
    got = qk.qdq_ragged(rows, 8)
    for g, w in zip(got, qk.qdq_ragged_ref(rows, 8)):
        np.testing.assert_array_equal(g.numpy(), w.numpy())
    assert (qk.launches, qk.ragged_stats_launches,
            qk.ragged_apply_launches) == before
    assert qk.qdq_ragged([], 8) == []


@pytest.mark.parametrize("leaves, partials, bits, match", [
    ([torch.ones(2, 3, dtype=torch.float64)], None, 8, "float32"),
    ([torch.ones(2, 3), torch.ones(2, 3, 4)], None, 8, "2-D"),
    ([torch.ones(3, 2).t()], None, 8, "contiguous"),
    ([torch.ones(2, 0)], None, 8, "n >= 1"),
    ([torch.ones(0, 3)], None, 8, "rows"),
    ([torch.ones(2, 3)], None, 4, "num_bits"),
    ([torch.ones(2, 3, device="meta")], None, 8, "cuda or cpu"),
    ([torch.ones(2, 3)], torch.zeros(3, 3), 8, "partials"),
    ([torch.ones(2, 3)], torch.zeros(2, 3, dtype=torch.float64), 8,
     "partials"),
], ids=["f64", "3d", "strided", "empty-row", "no-rows", "bits4", "meta",
        "partials-shape", "partials-f64"])
def test_ragged_refuses_what_the_kernels_do_not_take(leaves, partials, bits,
                                                     match):
    with pytest.raises(ValueError, match=match):
        if partials is None:
            qk.qdq_ragged(leaves, bits)
        else:
            qk.qdq_ragged_apply(leaves, partials, bits)
