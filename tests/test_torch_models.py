"""The port's config, core and model modules against the JAX package's.

Same numpy inputs through both packages on the CPU, float32. Tolerances:
logits rtol 1e-4 / atol 1e-5 and gradients rtol 1e-3 / atol 1e-5 (XLA's
im2col convolution and PyTorch's direct convolution sum in other
orders); optimizer steps rtol 1e-5.
"""
import dataclasses
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import torch_threads  # noqa: F401 (two torch threads a worker)
from fedtorch_tpu import config as jcfg
from fedtorch_tpu.core import optim as joptim
from fedtorch_tpu.core.losses import (
    accuracy as jaccuracy, per_sample_loss as jper_sample_loss,
    softmax_cross_entropy as jce,
)
from fedtorch_tpu.core.schedule import (
    compile_schedule as jcompile, lr_at as jlr_at,
)
from fedtorch_tpu.data.batching import (
    stack_partitions as jstack, take_batch as jtake,
)
from fedtorch_tpu.models import define_model as jdefine
from fedtorch_tpu.models.common import BatchStatsNorm as JNorm
from fedtorch_tpu.ops.augment import augment_image_batch as jaugment
from fedtorch_tpu_torch import config as tcfg
from fedtorch_tpu_torch.bridge import params_from_jax, params_to_jax
from fedtorch_tpu_torch.core import optim as toptim
from fedtorch_tpu_torch.core.losses import (
    accuracy as taccuracy, per_sample_loss as tper_sample_loss,
    softmax_cross_entropy as tce,
)
from fedtorch_tpu_torch.core.schedule import (
    compile_schedule as tcompile, lr_at as tlr_at,
)
from fedtorch_tpu_torch.data.batching import (
    round_row_plan, stack_partitions as tstack, take_batch as ttake,
)
from fedtorch_tpu_torch.models import define_model as tdefine
from fedtorch_tpu_torch.models.common import BatchStatsNorm, Conv
from fedtorch_tpu_torch.ops.augment import augment_image_batch


def _configs(**sections):
    """The same kwargs through both packages' config classes."""
    def build(mod):
        kw = {name: getattr(mod, cls)(**fields) for name, (cls, fields)
              in sections.items()}
        return mod.ExperimentConfig(**kw).finalize()
    return build(jcfg), build(tcfg)


def _flat(params):
    return {"/".join(k.key for k in path): np.asarray(v) for path, v in
            jax.tree_util.tree_flatten_with_path(params)[0]}


def _unflat(flat):
    tree = {}
    for path, v in flat.items():
        node = tree
        *mods, leaf = path.split("/")
        for m in mods:
            node = node.setdefault(m, {})
        node[leaf] = jnp.asarray(v)
    return tree


@functools.lru_cache(maxsize=None)
def _models(arch):
    """Both packages' models of ``arch`` on the same (bridged) weights,
    shared by the tests below (none of them mutates them)."""
    jc, tc = _configs(data=("DataConfig", dict(dataset="cifar10")),
                      model=("ModelConfig", dict(arch=arch)))
    jm = jdefine(jc, batch_size=2)
    tm = tdefine(tc, batch_size=2, device="cpu")
    jp = jax.jit(jm.init)(jax.random.key(3))
    tp = params_from_jax(_flat(jp), expect=tm.init(torch.Generator()))
    return jm, tm, jp, tp


def test_configs_finalize_identically():
    kw = dict(
        data=("DataConfig", dict(dataset="cifar10", batch_size=50)),
        federated=("FederatedConfig", dict(
            federated=True, num_clients=100, online_client_rate=0.1,
            algorithm="fedavg", sync_type="local_step", quantized=True)),
        model=("ModelConfig", dict(arch="resnet20")),
        optim=("OptimConfig", dict(lr=0.1, in_momentum=True,
                                   out_momentum=True)),
        train=("TrainConfig", dict(local_step=10)),
        mesh=("MeshConfig", dict(compute_dtype="bfloat16")))
    jc, tc = _configs(**kw)
    assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
    assert tc.train.num_epochs == 10 and tc.data.augment
    # the AFL coercion in finalize (sync_type/local_step)
    jc, tc = _configs(federated=("FederatedConfig", dict(
        federated=True, algorithm="afl")))
    assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
    assert tc.federated.sync_type == "local_step"


@pytest.mark.parametrize("arch", ["resnet8", "resnet20"])
def test_bridge_round_trip(arch):
    jm, tm, jp, tp = _models(arch)
    back = params_to_jax(tp)
    flat = _flat(jp)
    assert set(back) == set(flat)
    for k, v in flat.items():
        np.testing.assert_array_equal(back[k], v)


def test_bridge_raises_on_unmatched_leaves():
    jm, tm, jp, tp = _models("resnet8")
    expect = tm.init(torch.Generator())
    flat = _flat(jp)
    with pytest.raises(ValueError, match="unmatched flax leaf"):
        params_from_jax({**flat, "Conv_9/weird": np.zeros(3)})
    missing = dict(flat)
    del missing["Dense_0/bias"]
    with pytest.raises(ValueError, match="Dense_0.bias"):
        params_from_jax(missing, expect=expect)
    with pytest.raises(ValueError, match="unmatched torch leaf"):
        params_to_jax({**tp, "Dense_0.gamma": torch.zeros(3)})


@pytest.mark.parametrize("arch", ["resnet8", "resnet20"])
def test_logits_and_gradients_match(arch):
    jm, tm, jp, tp = _models(arch)
    rng = np.random.RandomState(0)
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
    for k, v in jg.items():
        np.testing.assert_allclose(tg[k], v, rtol=1e-3, atol=1e-5,
                                   err_msg=k)


def test_batch_stats_norm_matches():
    rng = np.random.RandomState(1)
    x = (rng.randn(6, 5, 7, 4) * 3 + 1).astype(np.float32)
    scale = rng.randn(4).astype(np.float32)
    bias = rng.randn(4).astype(np.float32)
    want = np.asarray(JNorm().apply(
        {"params": {"scale": scale, "bias": bias}}, jnp.asarray(x)))
    norm = BatchStatsNorm(4)
    with torch.no_grad():
        norm.weight.copy_(torch.from_numpy(scale))
        norm.bias.copy_(torch.from_numpy(bias))
        got = norm(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               rtol=1e-5, atol=1e-5)


def test_strided_1x1_shortcut_has_no_padding():
    """flax's default 'SAME' padding of the 1x1 stride-2 shortcut is 0:
    the port's Conv_2 must sample the even pixels, not shifted ones."""
    import flax.linen as fnn
    rng = np.random.RandomState(2)
    x = rng.randn(2, 8, 8, 16).astype(np.float32)
    conv = fnn.Conv(32, (1, 1), strides=(2, 2), use_bias=False)
    jp = conv.init(jax.random.key(0), jnp.asarray(x))
    want = np.asarray(conv.apply(jp, jnp.asarray(x)))
    tconv = Conv(16, 32, 1, stride=2, padding=0)
    w = params_from_jax({"Conv_2/kernel": np.asarray(
        jp["params"]["kernel"])})["Conv_2.weight"]
    got = torch.func.functional_call(
        tconv, {"weight": w}, (torch.from_numpy(x).permute(0, 3, 1, 2),))
    assert got.shape == (2, 32, 4, 4)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).detach().numpy(),
                               want, rtol=1e-5, atol=1e-6)


def _random_tree(rng, flat_shapes):
    return {k: rng.randn(*s).astype(np.float32)
            for k, s in flat_shapes.items()}


SHAPES = {"Conv_0/kernel": (3, 3, 3, 4), "BatchStatsNorm_0/scale": (4,),
          "BatchStatsNorm_0/bias": (4,), "Dense_0/kernel": (4, 10),
          "Dense_0/bias": (10,)}


@pytest.mark.parametrize("wd_skip", [False, True])
@pytest.mark.parametrize("nesterov", [False, True])
def test_sgd_local_and_server_steps_match(wd_skip, nesterov):
    rng = np.random.RandomState(4)
    _, tc = _configs(optim=("OptimConfig", dict(
        lr=0.1, in_momentum=True, out_momentum=True,
        out_momentum_factor=0.5, use_nesterov=nesterov,
        wd_skip_norm_bias=wd_skip)))
    ocfg_j = jcfg.OptimConfig(**dataclasses.asdict(tc.optim))
    p, g1, g2, d = (_random_tree(rng, SHAPES) for _ in range(4))
    jp, js = _unflat(p), joptim.init_sgd(_unflat(p))
    tp = params_from_jax(p)
    ts = toptim.init_sgd(tp)
    for g in (g1, g2):  # two steps: the momentum buffer carries over
        jp, js = joptim.sgd_local_step(jp, _unflat(g), js, 0.1, ocfg_j)
        tp, ts = toptim.sgd_local_step(tp, params_from_jax(g), ts,
                                       torch.tensor(0.1), tc.optim)
    jp, js = joptim.sgd_server_step(jp, _unflat(d), js, 1.0, ocfg_j)
    tp, ts = toptim.sgd_server_step(tp, params_from_jax(d), ts, 1.0,
                                    tc.optim)
    for got, want in ((tp, jp), (ts.in_buf, js.in_buf),
                      (ts.out_buf, js.out_buf)):
        got = params_to_jax(got)
        for k, v in _flat(want).items():
            np.testing.assert_allclose(got[k], v, rtol=1e-5, atol=1e-7,
                                       err_msg=k)


@pytest.mark.parametrize("correct_wd", [False, True])
def test_adam_local_step_matches(correct_wd):
    rng = np.random.RandomState(5)
    _, tc = _configs(optim=("OptimConfig", dict(
        optimizer="adam", lr=0.01, correct_wd=correct_wd)))
    ocfg_j = jcfg.OptimConfig(**dataclasses.asdict(tc.optim))
    p, g1, g2 = (_random_tree(rng, SHAPES) for _ in range(3))
    jp, js = _unflat(p), joptim.init_adam(_unflat(p))
    tp = params_from_jax(p)
    ts = toptim.init_adam(tp)
    for g in (g1, g2):
        jp, js = joptim.adam_local_step(jp, _unflat(g), js, 0.01, ocfg_j)
        tp, ts = toptim.adam_local_step(tp, params_from_jax(g), ts,
                                        torch.tensor(0.01), tc.optim)
    got = params_to_jax(tp)
    for k, v in _flat(jp).items():
        np.testing.assert_allclose(got[k], v, rtol=1e-5, atol=1e-7,
                                   err_msg=k)


def test_losses_match():
    rng = np.random.RandomState(6)
    logits = rng.randn(16, 10).astype(np.float32) * 3
    labels = rng.randint(0, 10, 16)
    logits[3] = logits[3, 0]  # an all-tie row: the first maximum wins
    jl, jy = jnp.asarray(logits), jnp.asarray(labels)
    tl, ty = torch.from_numpy(logits), torch.from_numpy(labels)
    np.testing.assert_allclose(float(tce(tl, ty)), float(jce(jl, jy)),
                               rtol=1e-6)
    np.testing.assert_allclose(tper_sample_loss(tl, ty, False).numpy(),
                               np.asarray(jper_sample_loss(jl, jy, False)),
                               rtol=1e-5, atol=1e-6)
    assert float(taccuracy(tl, ty)) == float(jaccuracy(jl, jy))


@pytest.mark.parametrize("scheme", [
    dict(),
    dict(schedule_scheme="custom_multistep", lr_change_epochs="3,6",
         warmup=True, warmup_epochs=2, scaleup=True),
    dict(schedule_scheme="strict", lr_change_epochs="4",
         lr_fields="0.1,0.01/0.01,0.001", lr_scale_indicators="0,1"),
    dict(schedule_scheme="custom_convex_decay", gamma=1.0, mu=0.5,
         alpha=2.0),
], ids=["constant", "multistep_warmup", "strict", "convex"])
def test_lr_schedule_matches(scheme):
    lr_cfg = tcfg.LRConfig(**scheme)
    ocfg = tcfg.OptimConfig(lr=0.1)
    js = jcompile(jcfg.LRConfig(**scheme), jcfg.OptimConfig(lr=0.1), 10,
                  world_size=4)
    ts = tcompile(lr_cfg, ocfg, 10, world_size=4)
    for e in (0.0, 0.5, 1.999, 2.0, 3.25, 6.0, 9.9, 12.0):
        want = float(jlr_at(js, jnp.float32(e)))
        got = float(tlr_at(ts, torch.tensor(e)))
        np.testing.assert_allclose(got, want, rtol=1e-6, err_msg=str(e))


def test_augment_matches_on_injected_draws():
    """The JAX function draws flip/tops/lefts from its key; the same
    draws, handed to the port, give the same pixels."""
    rng = np.random.RandomState(7)
    x = rng.randn(6, 32, 32, 3).astype(np.float32)
    key = jax.random.key(11)
    want = np.asarray(jaugment(key, jnp.asarray(x)))
    r_flip, r_top, r_left = jax.random.split(key, 3)
    flip = np.array(jax.random.bernoulli(r_flip, 0.5, (6,)))
    tops = np.array(jax.random.randint(r_top, (6,), 0, 9))
    lefts = np.array(jax.random.randint(r_left, (6,), 0, 9))
    got = augment_image_batch(torch.from_numpy(x), torch.from_numpy(flip),
                              torch.from_numpy(tops).long(),
                              torch.from_numpy(lefts).long())
    np.testing.assert_array_equal(got.numpy(), want)


def test_stack_partitions_and_row_plan():
    rng = np.random.RandomState(8)
    feats = rng.randn(20, 4, 4, 3).astype(np.float32)
    labels = rng.randint(0, 10, 20)
    parts = [np.arange(0, 7), np.arange(7, 10), np.arange(10, 20)]
    jd, td = jstack(feats, labels, parts), tstack(feats, labels, parts)
    np.testing.assert_array_equal(td.x.numpy(), np.asarray(jd.x))
    np.testing.assert_array_equal(td.y.numpy(), np.asarray(jd.y))
    np.testing.assert_array_equal(td.sizes.numpy(), np.asarray(jd.sizes))
    # a round's rows: a permutation of the client's real rows, cycled
    rows = round_row_plan(torch.Generator().manual_seed(0), 3, 10, 8)
    assert sorted(rows[:3].tolist()) == [0, 1, 2]
    assert rows[3:6].tolist() == rows[:3].tolist()
    # one step's batch from a given permutation, wrapping modulo the size
    perm = np.array([2, 0, 1, 3, 4, 5, 6, 7, 8, 9])
    for step in range(3):
        jx, jy = jtake(jnp.asarray(jd.x[1]), jnp.asarray(jd.y[1]),
                       jnp.asarray(perm), jnp.int32(3), step, 2)
        tx, ty = ttake(td.x[1], td.y[1], torch.from_numpy(perm), 3, step,
                       2)
        np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
        np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))
