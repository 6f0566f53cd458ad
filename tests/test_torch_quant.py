"""The port's quantizer against the JAX package's.

``qdq_batch_ref`` (the plain twin of the Hopper kernel, which the
wrapper runs on CPU tensors) is held against the Pallas kernel in
interpret mode and against the vmapped XLA ``quantize_dequantize``, on
the same numpy inputs. Sums run in another order in each, so the means
may differ in their last bit: every element must agree to within one
quantization step of its row, and bitwise where the inputs lie on a
dyadic grid (all sums exact) — against the Pallas kernel only where the
scale is exact too (see test_dyadic_grid_is_bitwise for why).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import torch_threads  # noqa: F401 (two torch threads a worker)
from fedtorch_tpu.ops.pallas.quant_kernel import (
    fused_quantize_dequantize_batch, fused_quantize_dequantize_tree as
    jax_tree,
)
from fedtorch_tpu.ops.quantize import quantize_dequantize
from fedtorch_tpu_torch.bridge import params_from_jax, params_to_jax
from fedtorch_tpu_torch.ops import quantize as port_quantize
from fedtorch_tpu_torch.ops.cuda import quant_kernel as qk


def _pallas(x, bits):
    return np.asarray(fused_quantize_dequantize_batch(
        jnp.asarray(x), bits, force_pallas=True, interpret=True))


def _xla(x, bits):
    return np.asarray(jax.vmap(lambda v: quantize_dequantize(v, bits))(
        jnp.asarray(x)))


def _port(x, bits):
    return qk.qdq_batch(torch.from_numpy(x), bits).numpy()


def _row_step(x, bits):
    """One quantization step of each row, [rows, 1]."""
    qmin, qmax = qk.qrange(bits)
    return (x.max(1, keepdims=True) - x.min(1, keepdims=True)) \
        / (qmax - qmin)


def _assert_within_one_step(got, want, x, bits):
    step = _row_step(x, bits)
    step = np.where(step == 0, 1e-3, step)  # the scale floor
    # one step, plus the float32 rounding of the dequantized value
    err = np.abs(got - want) - step * (1 + 1e-5)
    assert np.all(err <= 1e-6 * np.abs(want) + 1e-7), float(err.max())


@pytest.mark.parametrize("bits", [8, 16])
@pytest.mark.parametrize("n", [1, 10, 127, 2304, 36864])
def test_ref_matches_pallas_and_xla(n, bits):
    rng = np.random.RandomState(n + bits)
    # distinct per-row scales and offsets: shared stats would show
    x = (rng.randn(3, n) * np.array([[0.01], [1.0], [40.0]])
         + np.array([[0.0], [3.0], [-7.0]])).astype(np.float32)
    got = _port(x, bits)
    _assert_within_one_step(got, _pallas(x, bits), x, bits)
    _assert_within_one_step(got, _xla(x, bits), x, bits)
    # and the port's plain single-tensor reference agrees per row
    for r in range(3):
        one = port_quantize.quantize_dequantize(torch.from_numpy(x[r]),
                                                bits).numpy()
        _assert_within_one_step(got[r:r + 1], one[None], x[r:r + 1], bits)


@pytest.mark.parametrize("bits", [8, 16])
@pytest.mark.parametrize("n", [16, 64, 512, 2048, 32768])
def test_dyadic_grid_is_bitwise(n, bits):
    """Inputs k/16 with |k| <= 64 and a power-of-two row length: every
    partial sum is exact in float32 whatever the order, and so is the
    mean however it is divided (XLA's ``jnp.mean`` multiplies by the
    rounded 1/n, which is exact only for powers of two), so the
    statistics agree exactly and so must every output bit of the formula
    as written — the XLA quantizer runs it op by op. The Pallas kernel
    in interpret mode is one fused XLA CPU program, in which the
    compiler turns ``/ (qmax - qmin)`` into a multiplication by the
    rounded reciprocal and contracts the last line into an FMA
    (measured: with exactly those two rewrites a numpy replay matches it
    bit for bit). Those are last-bit differences, so against it the bar
    stays one step."""
    rng = np.random.RandomState(7 * n + bits)
    x = (rng.randint(-64, 65, size=(4, n)) / 16.0).astype(np.float32)
    x[1] += 2.0  # a row with a non-zero mean
    got = _port(x, bits)
    np.testing.assert_array_equal(got, _xla(x, bits))
    _assert_within_one_step(got, _pallas(x, bits), x, bits)


@pytest.mark.parametrize("bits, n", [(8, 16), (8, 512), (8, 2048),
                                     (16, 16), (16, 256)])
def test_exact_scale_is_bitwise_against_pallas_too(bits, n):
    """Rows k/16 that hold both ends of the integer range: the scale is
    exactly 1/16, so neither the reciprocal rewrite nor the FMA of the
    fused Pallas program changes a bit, and the sums stay exact. Here
    all three implementations must agree bit for bit."""
    half = 2 ** (bits - 1)
    rng = np.random.RandomState(n + bits)
    k = rng.randint(-half, half, size=(4, n))
    k[:, 0], k[:, 1] = -half, half - 1
    x = (k / 16.0).astype(np.float32)
    got = _port(x, bits)
    np.testing.assert_array_equal(got, _pallas(x, bits))
    np.testing.assert_array_equal(got, _xla(x, bits))


@pytest.mark.parametrize("bits", [8, 16])
def test_constant_row_takes_the_scale_floor(bits):
    x = np.full((2, 300), 2.5, np.float32)
    x[1] = -0.75
    got = _port(x, bits)
    np.testing.assert_array_equal(got, x)
    np.testing.assert_array_equal(got, _pallas(x, bits))


@pytest.mark.parametrize("bits", [8, 16])
def test_nan_and_inf_rows_follow_the_formula(bits):
    """A NaN (or inf) poisons its own row's statistics exactly as the
    Pallas kernel's min/max/sum do, and no other row's."""
    rng = np.random.RandomState(bits)
    x = rng.randn(4, 257).astype(np.float32)
    x[1, 100] = np.nan
    x[2, 3] = np.inf
    x[3, 7] = -np.inf
    got = _port(x, bits)
    want = _pallas(x, bits)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    assert np.isnan(got[1]).all() and np.isnan(got[2:]).all()
    _assert_within_one_step(got[:1], want[:1], x[:1], bits)


def _resnet8_params():
    from fedtorch_tpu.config import (
        DataConfig, ExperimentConfig, ModelConfig)
    from fedtorch_tpu.models import define_model
    cfg = ExperimentConfig(data=DataConfig(dataset="cifar10"),
                           model=ModelConfig(arch="resnet8")).finalize()
    shapes = jax.eval_shape(define_model(cfg, batch_size=2).init,
                            jax.random.key(1))
    return {"/".join(k.key for k in path): v.shape for path, v in
            jax.tree_util.tree_flatten_with_path(shapes)[0]}


def _unflatten(flat):
    tree = {}
    for path, v in flat.items():
        node = tree
        *mods, leaf = path.split("/")
        for m in mods:
            node = node.setdefault(m, {})
        node[leaf] = jnp.asarray(v)
    return tree


def _flatten(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out["/".join(prefix + (k,))] = np.asarray(v)
    return out


@pytest.mark.parametrize("leading_batch", [True, False],
                         ids=["uplink", "downlink"])
def test_tree_matches_jax_on_a_resnet8_payload(leading_batch):
    """Bucketed tree quantizer, port vs the JAX package's (Pallas kernel
    in interpret mode), on a ResNet-8 payload: per client [k, ...] on
    the uplink, the summed tree on the downlink."""
    k, bits = 3, 8
    rng = np.random.RandomState(5)
    shapes = _resnet8_params()
    if leading_batch:
        flat = {p: (rng.randn(k, *v) * 1e-2).astype(np.float32)
                for p, v in shapes.items()}
        per_client = [params_from_jax({p: v[c] for p, v in flat.items()})
                      for c in range(k)]
        tree = {n: torch.stack([pc[n] for pc in per_client])
                for n in per_client[0]}
    else:
        flat = {p: (rng.randn(*v) * 1e-2).astype(np.float32)
                for p, v in shapes.items()}
        tree = params_from_jax(flat)
    want = _flatten(jax_tree(_unflatten(flat), bits,
                             leading_batch=leading_batch,
                             force_pallas=True, interpret=True))
    got = qk.fused_quantize_dequantize_tree(tree, bits, leading_batch)
    assert list(got) == list(tree)
    if leading_batch:
        gots = [params_to_jax({n: v[c] for n, v in got.items()})
                for c in range(k)]
        got_flat = {p: np.stack([g[p] for g in gots]) for p in flat}
    else:
        got_flat = params_to_jax(got)
    for p, x in flat.items():
        rows = x.reshape(k if leading_batch else 1, -1)
        _assert_within_one_step(got_flat[p].reshape(rows.shape),
                                want[p].reshape(rows.shape), rows, bits)


def test_tree_launches_one_kernel_per_bucket(monkeypatch):
    """Every leaf on the row path (all three here) goes into one call of
    the ragged pair, as its [k, n] view, in tree order: one stats and one
    apply launch for the whole tree."""
    calls = []
    real = qk.qdq_ragged
    monkeypatch.setattr(qk, "qdq_ragged", lambda leaves, b: calls.append(
        [tuple(x.shape) for x in leaves]) or real(leaves, b))
    tree = {"a": torch.ones(2, 3, 4), "b": torch.zeros(2, 12),
            "c": torch.ones(2, 5)}
    out = qk.fused_quantize_dequantize_tree(tree, 8, leading_batch=True)
    assert calls == [[(2, 12), (2, 12), (2, 5)]]
    assert {n: v.shape for n, v in out.items()} == \
        {n: v.shape for n, v in tree.items()}


def test_cpu_tensor_takes_the_plain_version_and_counts_nothing():
    x = torch.from_numpy(np.random.RandomState(3).randn(5, 64)
                         .astype(np.float32))
    before = qk.launches
    np.testing.assert_array_equal(qk.qdq_batch(x, 8).numpy(),
                                  qk.qdq_batch_ref(x, 8).numpy())
    assert qk.launches == before


@pytest.mark.parametrize("bad, bits", [
    (torch.ones(2, 3, dtype=torch.float64), 8),
    (torch.ones(2, 3, 4), 8),
    (torch.ones(3, 2).t(), 8),
    (torch.ones(2, 0), 8),
    (torch.ones(2, 3), 4),
], ids=["f64", "3d", "strided", "empty", "bits4"])
def test_wrapper_refuses_what_the_kernel_does_not_take(bad, bits):
    with pytest.raises(ValueError):
        qk.qdq_batch(bad, bits)


def test_wrapper_refuses_other_devices():
    with pytest.raises(ValueError, match="cuda or cpu"):
        qk.qdq_batch(torch.ones(2, 3, device="meta"), 8)
