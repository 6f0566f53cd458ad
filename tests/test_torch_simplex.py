"""Simplex projection (``ops/simplex.py``), port vs the JAX package, on
the CPU: the projection (including the rho = 0 fallback and vectors
already on the simplex) and the DRFA/AFL floor, within 1e-6 (the
cumulative sums associate in other orders), each result on the simplex
within 1e-6."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

import torch_threads  # noqa: F401 (two torch threads a worker)
from fedtorch_tpu.ops import simplex as jsimplex
from fedtorch_tpu_torch.ops import simplex as tsimplex

VECTORS = {
    "uniform": np.full(8, 1 / 8, np.float32),
    "random": np.random.RandomState(0).randn(10).astype(np.float32),
    "large": (np.random.RandomState(1).rand(100) * 50).astype(np.float32),
    "one_spike": np.r_[np.zeros(7, np.float32), np.float32([4.0])],
    "all_negative": -np.arange(1, 7, dtype=np.float32),
    "ties": np.float32([0.3, 0.3, 0.3, -1.0, 0.3]),
    "after_a_dual_step": (np.full(20, 0.05) + 0.1 * np.random.RandomState(
        2).rand(20)).astype(np.float32),
}


@pytest.mark.parametrize("s", [1.0, 2.5])
@pytest.mark.parametrize("name", sorted(VECTORS))
def test_projection_matches(name, s):
    v = VECTORS[name]
    want = np.array(jsimplex.project_simplex(jnp.asarray(v), s))
    got = tsimplex.project_simplex(torch.from_numpy(v), s).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * s)
    assert abs(float(got.sum()) - s) <= 1e-5 * s and (got >= 0).all()


@pytest.mark.parametrize("floor", [1e-3, 0.05])
@pytest.mark.parametrize("name", sorted(VECTORS))
def test_floor_matches(name, floor):
    v = VECTORS[name]
    want = np.array(jsimplex.project_simplex_floor(jnp.asarray(v),
                                                   floor=floor))
    got = tsimplex.project_simplex_floor(torch.from_numpy(v),
                                         floor=floor).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert abs(float(got.sum()) - 1.0) <= 1e-6 and (got > 0).all()


def test_rho_zero_fallback():
    """No component meets the support condition past the first: the
    largest entry takes the whole mass."""
    v = np.float32([10.0, -5.0, -7.0])
    got = tsimplex.project_simplex(torch.from_numpy(v)).numpy()
    np.testing.assert_array_equal(got, np.float32([1.0, 0.0, 0.0]))
    np.testing.assert_array_equal(
        got, np.array(jsimplex.project_simplex(jnp.asarray(v))))
