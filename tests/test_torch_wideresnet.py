"""The port's WideResNet against the JAX package's, on the CPU.

* Forward and gradients: ``wideresnet16`` at widen factor 2 (identity and
  projection blocks), float32, on bridged weights. Logits rtol 1e-4 /
  atol 1e-5 and gradients rtol 1e-3 / atol 1e-5, as for ResNet in
  tests/test_torch_models.py: XLA's im2col convolution and PyTorch's
  direct convolution sum in other orders. The gradient is discontinuous
  at a ReLU's kink: where a pre-activation lies within float32 rounding
  of 0 (about one in a million), the two orders can put it on opposite
  sides, and that one element moves the gradient of every earlier layer
  by a few percent. About half of the input seeds hold such an element
  at this size (with seed 0, one stage-3 pre-activation comes out
  +1.4e-6 or -4.5e-7 in PyTorch alone, by the memory layout it runs
  in); the test takes a seed that holds none.
* The bridge: WRN params map both ways exactly, and ``params_from_jax``
  with ``expect`` covers the model; WideResNet-28-10's tree has the
  sizes the quantizer's launch counts are derived from.
* A quantized FedAvg round on ``wideresnet16`` at widen factor 1, with
  the port's row threshold shrunk so that the stage-2 and stage-3 convs
  go through the multi-block pair's plain version. The JAX round on the
  CPU quantizes in XLA (not on a TPU, so quant_kernel.py:260-268): the
  same function. Sizes, the injected plans, the per-round restart from
  the JAX state and the bar (each round's update within two int8
  downlink steps per element and 1e-3 relative L2) are those of
  tests/test_torch_round.py, whose helpers this file reuses. The bar
  holds because no ReLU input of these rounds lies within rounding of 0
  (see above); at widen factor 4 one does, and two float32 orders of
  the same round then differ by several steps (chip_smoke.py's
  reference phase measures that spread and holds the card to it).
"""
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import torch_threads  # noqa: F401 (two torch threads a worker)
from fedtorch_tpu import config as jcfg
from fedtorch_tpu.core.losses import softmax_cross_entropy as jce
from fedtorch_tpu.models import define_model as jdefine
from fedtorch_tpu_torch import config as tcfg
from fedtorch_tpu_torch.bridge import params_from_jax, params_to_jax
from fedtorch_tpu_torch.core.losses import softmax_cross_entropy as tce
from fedtorch_tpu_torch.models import define_model as tdefine
from fedtorch_tpu_torch.ops.cuda import quant_kernel as qk

from test_torch_round import _build, _run


def _flat(params):
    return {"/".join(k.key for k in path): np.asarray(v) for path, v in
            jax.tree_util.tree_flatten_with_path(params)[0]}


def _cfg(mod, arch, widen):
    return mod.ExperimentConfig(
        data=mod.DataConfig(dataset="cifar10"),
        model=mod.ModelConfig(arch=arch,
                              wideresnet_widen_factor=widen)).finalize()


@functools.lru_cache(maxsize=None)
def _models(arch, widen):
    """Both packages' models on the same (bridged) weights."""
    jm = jdefine(_cfg(jcfg, arch, widen), batch_size=2)
    tm = tdefine(_cfg(tcfg, arch, widen), batch_size=2, device="cpu")
    jp = jax.jit(jm.init)(jax.random.key(4))
    tp = params_from_jax(_flat(jp), expect=tm.init(torch.Generator()))
    return jm, tm, jp, tp


def test_logits_and_gradients_match():
    jm, tm, jp, tp = _models("wideresnet16", 2)
    rng = np.random.RandomState(1)  # no ReLU input within rounding of 0
    x = rng.randn(8, 32, 32, 3).astype(np.float32)
    y = rng.randint(0, 10, 8)
    jl = np.asarray(jax.jit(jm.apply)(jp, jnp.asarray(x)))
    tl = tm.apply(tp, torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(tl, jl, rtol=1e-4, atol=1e-5)

    jg = _flat(jax.jit(jax.grad(lambda p: jce(
        jm.apply(p, jnp.asarray(x)), jnp.asarray(y))))(jp))
    leaves = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
    loss = tce(tm.apply(leaves, torch.from_numpy(x)), torch.from_numpy(y))
    grads = dict(zip(leaves, torch.autograd.grad(loss,
                                                 list(leaves.values()))))
    tg = params_to_jax(grads)
    assert set(tg) == set(jg)
    for k, v in jg.items():
        np.testing.assert_allclose(tg[k], v, rtol=1e-3, atol=1e-5,
                                   err_msg=k)


def test_bridge_round_trip_and_coverage():
    jm, tm, jp, tp = _models("wideresnet16", 2)
    flat = _flat(jp)
    back = params_to_jax(tp)
    assert set(back) == set(flat)
    for k, v in flat.items():
        np.testing.assert_array_equal(back[k], v)
    # both block kinds and the head, under their flax names
    for key in ("_WideBasic_0.BatchStatsNorm_0.weight",
                "_WideBasic_0.Conv_1.weight", "_WideBasic_2.Conv_2.weight",
                "_WideBasic_2.BatchStatsNorm_1.bias",
                "BatchStatsNorm_0.weight", "Dense_0.weight"):
        assert key in tp, key
    assert "_WideBasic_1.Conv_2.weight" not in tp  # identity shortcut
    missing = dict(flat)
    del missing["_WideBasic_3/BatchStatsNorm_1/scale"]
    with pytest.raises(ValueError, match="_WideBasic_3.BatchStatsNorm_1"):
        params_from_jax(missing, expect=tp)


def test_wideresnet28_10_tree_has_the_papers_size():
    """WRN-28-10 (arXiv:1605.07146): 36,479,194 parameters in 80 leaves
    of 16 sizes, the same tree as the JAX package's; 15 leaves (93.5% of
    the parameters) lie past the row kernel's 524,288 elements."""
    module = tdefine(_cfg(tcfg, "wideresnet28", 10), device="cpu").module
    shapes = {k: tuple(v.shape) for k, v in module.named_parameters()}
    jshapes = jax.eval_shape(jdefine(_cfg(jcfg, "wideresnet28", 10)).init,
                             jax.random.key(0))
    flat = {"/".join(k.key for k in path): np.zeros(v.shape, np.float32)
            for path, v in jax.tree_util.tree_flatten_with_path(jshapes)[0]}
    bridged = params_from_jax(flat, expect=dict(module.named_parameters()))
    assert {k: tuple(v.shape) for k, v in bridged.items()} == shapes
    sizes = [int(np.prod(s)) for s in shapes.values()]
    assert sum(sizes) == 36_479_194 and len(sizes) == 80
    assert len(set(sizes)) == 16
    large = sorted(n for n in sizes if n > qk._MAX_ROW_ELEMS)
    assert large == [921_600] * 7 + [1_843_200] + [3_686_400] * 7
    assert sum(large) == 34_099_200


def test_quantized_round_through_the_pair_matches(monkeypatch):
    monkeypatch.setattr(qk, "_MAX_ROW_ELEMS", 4000)
    calls = []
    real = qk.qdq_tiled_stats
    monkeypatch.setattr(qk, "qdq_tiled_stats",
                        lambda x, *a: calls.append(x.shape[1])
                        or real(x, *a))
    built = _build(quantized=True, model=dict(
        arch="wideresnet16", wideresnet_widen_factor=1))
    trace = _run(*built, num_rounds=2, resync=True)
    # stage-2 and stage-3 convs: 4 sizes past 4000 elements, each one
    # uplink and one downlink stats call per round
    assert sorted(calls) == sorted([4608, 9216, 18432, 36864] * 4)
    for r in (1, 2):
        (jp0, tp0, _, _), (jp, tp, jl, tl) = trace[r - 1], trace[r]
        ju = np.concatenate([(jp[k] - jp0[k]).ravel() for k in jp])
        tu = np.concatenate([(tp[k] - tp0[k]).ravel() for k in jp])
        assert np.linalg.norm(tu - ju) <= 1e-3 * np.linalg.norm(ju)
        for k in jp:
            u = jp[k] - jp0[k]
            step = (u.max() - u.min()) / 255.0
            assert np.abs((tp[k] - tp0[k]) - u).max() <= 2 * step + 1e-7, k
        np.testing.assert_allclose(tl, jl, rtol=1e-3, atol=1e-5)
