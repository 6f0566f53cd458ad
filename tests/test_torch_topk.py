"""Top-k sparsification (``ops/topk.py``), port vs the JAX package, on
the CPU: the kept set and the round trip bitwise, including x and -x
tied at the k-th boundary, equal magnitudes, zeros (+0.0 and -0.0),
NaN and infinities; ``num_kept``'s rule and its refusal; the pytree
round trip and its residual."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

import torch_threads  # noqa: F401 (two torch threads a worker)
from fedtorch_tpu.ops import topk as jtopk
from fedtorch_tpu_torch.ops import topk as ttopk


def _both(x, ratio):
    j = np.array(jtopk.topk_roundtrip(jnp.asarray(x), ratio))
    t = ttopk.topk_roundtrip(torch.from_numpy(x), ratio).numpy()
    return j, t


def _assert_bitwise(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


CASES = {
    # 3 and -3 tie for the last kept place: the lower index wins
    "pm_tie_at_boundary": (np.array([1., -3., 3., 2., -2., 0.5, 5., -5.],
                                    np.float32), 0.75),
    "all_equal_magnitude": (np.array([2., -2.] * 16, np.float32), 0.5),
    "zeros_and_signed_zeros": (np.array([0., -0., 0., 1e-30, -0., 0.,
                                         -1e-30, 0.], np.float32), 0.5),
    "mostly_zeros": (np.r_[np.zeros(60, np.float32),
                           np.float32([-1., 1., 0., 2.])], 0.25),
    "nan_and_infs": (np.array([1., np.nan, -np.inf, 2., np.inf, -2., 0.,
                               3.], np.float32), 0.5),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_roundtrip_is_bitwise_the_jax_package_s(case):
    x, ratio = CASES[case]
    j, t = _both(x, ratio)
    _assert_bitwise(t, j)


@pytest.mark.parametrize("ratio", [0.02, 0.1, 0.5, 1.0])
@pytest.mark.parametrize("shape", [(7,), (16, 9), (3, 3, 4, 5)])
def test_random_tensors_with_ties_are_bitwise(shape, ratio):
    """Values drawn from a few levels of either sign, so ties of |x|
    straddle the k-th place in most draws."""
    rng = np.random.RandomState(sum(shape))
    x = (rng.randint(-4, 5, shape) * 0.25).astype(np.float32)
    if int(np.prod(shape) * ratio / 2) == 0:
        with pytest.raises(ValueError, match="too low"):
            ttopk.topk_roundtrip(torch.from_numpy(x), ratio)
        return
    j, t = _both(x, ratio)
    _assert_bitwise(t, j)


def test_compress_gives_the_jax_package_s_values_and_indices():
    rng = np.random.RandomState(3)
    x = (rng.randint(-3, 4, (6, 8)) * 0.5).astype(np.float32)
    js = jtopk.compress(jnp.asarray(x), 0.5)
    ts = ttopk.compress(torch.from_numpy(x), 0.5)
    np.testing.assert_array_equal(ts.indices.numpy(), np.array(js.indices))
    np.testing.assert_array_equal(ts.values.numpy(), np.array(js.values))
    assert ts.indices.dtype == torch.int32 and ts.shape == js.shape
    _assert_bitwise(ttopk.decompress(ts).numpy(),
                    np.array(jtopk.decompress(js)))


@pytest.mark.parametrize("n, ratio", [(10, 0.5), (3, 0.7), (100, 0.01),
                                      (1, 1.0), (7, 0.3)])
def test_num_kept_follows_the_rule(n, ratio):
    try:
        want = jtopk.num_kept(n, ratio)
    except ValueError:
        with pytest.raises(ValueError, match="Compression ratio is too low"):
            ttopk.num_kept(n, ratio)
        return
    assert ttopk.num_kept(n, ratio) == want


def test_compress_pytree_and_its_residual():
    rng = np.random.RandomState(4)
    tree = {"a": rng.randn(5, 4).astype(np.float32),
            "b": rng.randn(11).astype(np.float32)}
    jr, jres = jtopk.compress_pytree({k: jnp.asarray(v)
                                      for k, v in tree.items()}, 0.4)
    tr, tres = ttopk.compress_pytree({k: torch.from_numpy(v)
                                      for k, v in tree.items()}, 0.4)
    for k in tree:
        _assert_bitwise(tr[k].numpy(), np.array(jr[k]))
        _assert_bitwise(tres[k].numpy(), np.array(jres[k]))


def test_random_k_keeps_k_entries_of_the_tensor():
    x = torch.arange(1.0, 21.0)
    gen = torch.Generator().manual_seed(0)
    sp = ttopk.compress(x, 0.5, comp_type="random", generator=gen)
    assert sp.indices.shape == (5,) and len(set(sp.indices.tolist())) == 5
    np.testing.assert_array_equal(sp.values.numpy(),
                                  x.numpy()[sp.indices.numpy()])
    with pytest.raises(ValueError, match="generator"):
        ttopk.compress(x, 0.5, comp_type="random")
