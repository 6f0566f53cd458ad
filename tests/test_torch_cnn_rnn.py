"""The LeNet ``cnn`` and the char-GRU ``rnn`` of the port against the JAX
package's, on the CPU, on bridged weights and the same numpy inputs.

* ``define_model``: the JAX package's param names and counts (440,812
  for the MNIST ``cnn``, 672,212 on CIFAR-10, 467,488 on EMNIST-full;
  23,886 for the default ``rnn``, which ``torch.nn.GRU``'s two extra
  biases would break), and the bridge's round trip bit for bit.
* Forwards: the ``cnn`` on mnist, cifar10 and emnist_full, float32
  within 1e-5 relative L2 (the flatten order: a wrong one moves the
  logits by order 1), bfloat16 within 5e-2 of the logits' scale (as the
  transformer's bfloat16 logits are held: each package rounds to
  bfloat16 at its own points); the ``rnn`` with 1 and 2 layers from a
  random carry, logits and new carry within 1e-5 relative L2.
* Two local steps (momentum SGD) of each model through the algorithm's
  ``local_step``, the ``rnn``'s carry threaded from the first into the
  second: losses within 1e-5, the params' update within 1e-4 relative
  L2, and the returned carry within 1e-5 relative L2.

Sizes are small (the ``rnn`` at hidden 8, sequences of 8, batch 4).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401 (two torch threads a worker)
from fedtorch_tpu import config as jcfg
from fedtorch_tpu.algorithms import make_algorithm as jmake
from fedtorch_tpu.core import optim as joptim
from fedtorch_tpu.core.losses import make_criterion as jcriterion
from fedtorch_tpu.models import define_model as jdefine
from fedtorch_tpu.models.rnn import CharGRU as JCharGRU
from fedtorch_tpu_torch import config as tcfg
from fedtorch_tpu_torch.algorithms import make_algorithm as tmake
from fedtorch_tpu_torch.bridge import params_from_jax, params_to_jax
from fedtorch_tpu_torch.core import optim as toptim
from fedtorch_tpu_torch.core.losses import make_criterion as tcriterion
from fedtorch_tpu_torch.models import define_model as tdefine
from fedtorch_tpu_torch.models.common import ModelDef
from fedtorch_tpu_torch.models.rnn import CharGRU

B, T, H = 4, 8, 8
IMAGE = {"mnist": (28, 28, 1), "emnist_full": (28, 28, 1),
         "cifar10": (32, 32, 3)}


def _flat(params):
    return {"/".join(k.key for k in path): np.asarray(v) for path, v in
            jax.tree_util.tree_flatten_with_path(params)[0]}


def _rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def _configs(arch, dataset, dtype="float32", hidden=H, **optim):
    def build(mod):
        return mod.ExperimentConfig(
            data=mod.DataConfig(dataset=dataset, batch_size=B),
            model=mod.ModelConfig(arch=arch, rnn_hidden_size=hidden,
                                  rnn_seq_len=T),
            optim=mod.OptimConfig(lr=0.1, in_momentum=True, **optim),
            mesh=mod.MeshConfig(compute_dtype=dtype)).finalize()
    return build(jcfg), build(tcfg)


@functools.lru_cache(maxsize=None)
def _models(arch, dataset, dtype="float32"):
    """Both packages' models on the same (bridged) weights."""
    jc, tc = _configs(arch, dataset, dtype)
    jm = jdefine(jc, batch_size=B)
    tm = tdefine(tc, batch_size=B, device="cpu")
    jp = jax.jit(jm.init)(jax.random.key(3))
    tp = params_from_jax(_flat(jp), expect=tm.init(torch.Generator()),
                         module=tm.module)
    return jc, tc, jm, tm, jp, tp


def _images(dataset, seed=0):
    rng = np.random.RandomState(seed)
    return rng.randn(B, *IMAGE[dataset]).astype(np.float32), \
        rng.randint(0, 10, B)


def _tokens(seed=0, vocab=86):
    rng = np.random.RandomState(seed)
    return rng.randint(0, vocab, (B, T)), rng.randint(0, vocab, (B, T))


@pytest.mark.parametrize("arch, dataset, hidden, count", [
    ("cnn", "mnist", 50, 440_812), ("cnn", "cifar10", 50, 672_212),
    ("cnn", "emnist_full", 50, 467_488), ("rnn", "shakespeare", 50, 23_886),
])
def test_param_names_and_counts_are_the_jax_package_s(arch, dataset, hidden,
                                                      count):
    jc, tc = _configs(arch, dataset, hidden=hidden)
    tm = tdefine(tc, batch_size=B, device="cpu")
    tp = tm.init(torch.Generator().manual_seed(0))
    jm = jdefine(jc, batch_size=B)
    shapes = {"/".join(k.key for k in path): tuple(v.shape)
              for path, v in jax.tree_util.tree_flatten_with_path(
                  jax.eval_shape(jm.init, jax.random.key(0)))[0]}
    assert sum(v.numel() for v in tp.values()) == count
    assert sum(int(np.prod(v)) for v in shapes.values()) == count
    back = params_to_jax(tp, tm.module)
    assert {k: v.shape for k, v in back.items()} == shapes
    assert tm.is_recurrent == (arch == "rnn")


@pytest.mark.parametrize("arch, dataset", [("cnn", "mnist"),
                                           ("rnn", "shakespeare")])
def test_bridge_round_trip_is_bitwise(arch, dataset):
    _, _, _, tm, jp, tp = _models(arch, dataset)
    flat = _flat(jp)
    for module in (tm.module, None):
        back = params_to_jax(tp, module)
        assert set(back) == set(flat)
        for k, v in flat.items():
            np.testing.assert_array_equal(back[k], v)
        again = params_from_jax(back, expect=tp, module=module)
        for k, v in tp.items():
            assert torch.equal(again[k], v)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dataset", ["mnist", "cifar10", "emnist_full"])
def test_cnn_logits_match(dataset, dtype):
    _, _, jm, tm, jp, tp = _models("cnn", dataset, dtype)
    x, _ = _images(dataset)
    want = np.asarray(jm.apply(jp, jnp.asarray(x)))
    with torch.no_grad():
        got = tm.apply(tp, torch.from_numpy(x)).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    if dtype == "float32":
        assert _rel_l2(got, want) <= 1e-5
    else:
        assert np.abs(got - want).max() <= 5e-2 * np.abs(want).max()


@pytest.mark.parametrize("layers", [1, 2])
def test_rnn_logits_and_carry_match(layers):
    """The module with ``n_layers`` (``define_model`` builds 1) from a
    random carry: logits and every layer's new carry."""
    jmod = JCharGRU(hidden_size=H, n_layers=layers)
    tmod = CharGRU(hidden_size=H, n_layers=layers)
    rng = np.random.RandomState(layers)
    toks, _ = _tokens(layers)
    carry = rng.randn(layers, B, H).astype(np.float32)
    jp = jmod.init(jax.random.key(5), jnp.asarray(toks, jnp.int32),
                   jmod.initial_carry(B))["params"]
    model = ModelDef("rnn", tmod, torch.zeros(B, T, dtype=torch.int64),
                     is_recurrent=True)
    tp = params_from_jax(_flat(jp), expect=model.init(torch.Generator()),
                         module=tmod)
    want_l, want_c = jmod.apply({"params": jp}, jnp.asarray(toks),
                                jnp.asarray(carry))
    with torch.no_grad():
        got_l, got_c = model.apply(tp, torch.from_numpy(toks),
                                   torch.from_numpy(carry))
    assert got_l.shape == (B, T, 86) and got_c.shape == (layers, B, H)
    assert _rel_l2(got_l.numpy(), want_l) <= 1e-5
    assert _rel_l2(got_c.numpy(), want_c) <= 1e-5
    # the fresh-carry forward is apply from init_carry's zeros
    assert model.init_carry(3).shape == (layers, 3, H)
    assert not model.init_carry(3).any()


def _jax_step(jc, jm, jp, x, y, carry, opt):
    alg = jmake(jc)
    alg.bind(jm, jcriterion(False))

    def step(p, o, c):
        return alg.local_step(
            params=p, opt=o, client_aux=(), rnn_carry=c, server_params=p,
            server_aux=(), bx=jnp.asarray(x), by=jnp.asarray(y),
            bval_x=None, bval_y=None, lr=jnp.float32(0.1),
            rng=jax.random.key(0), step_idx=0, local_index=jnp.int32(0),
            step_budget=jnp.int32(2))
    return jax.jit(step)(jp, opt, carry)


@pytest.mark.parametrize("arch, dataset", [("cnn", "mnist"),
                                           ("rnn", "shakespeare")])
def test_two_local_steps_match(arch, dataset):
    """Two steps of the base ``local_step`` from the same weights and
    momentum buffers; the ``rnn``'s carry starts at zeros and the first
    step's returned carry enters the second."""
    jc, tc, jm, tm, jp, tp = _models(arch, dataset)
    talg = tmake(tc)
    talg.bind(tm, tcriterion(False))
    jopt = joptim.init_opt_state(jp, jc.optim)
    topt = toptim.init_opt_state(tp, tc.optim)
    jcarry, tcarry = jm.init_carry(B), tm.init_carry(B)
    for s in range(2):
        x, y = _images(dataset, s) if arch == "cnn" else _tokens(s)
        jp1, jopt, _, jcarry, jloss, jacc = _jax_step(
            jc, jm, jp, x, y, jcarry, jopt)
        tp1, topt, _, tcarry, tloss, tacc = talg.local_step(
            params=tp, opt=topt, client_aux=(), rnn_carry=tcarry,
            server_params=tp, server_aux=(), bx=torch.from_numpy(x),
            by=torch.from_numpy(y), bval_x=None, bval_y=None,
            lr=torch.tensor(0.1), step_idx=s,
            local_index=torch.tensor(s, dtype=torch.int32), step_budget=2)
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
        assert float(tacc) == pytest.approx(float(jacc), abs=1e-6)
        jf, jf1 = _flat(jp), _flat(jp1)
        tf1 = params_to_jax(tp1, tm.module)
        want = np.concatenate([(jf1[k] - jf[k]).ravel() for k in jf])
        got = np.concatenate([(tf1[k] - jf[k]).ravel() for k in jf])
        assert _rel_l2(got, want) <= 1e-4, s
        if arch == "rnn":
            assert not tcarry.requires_grad
            assert _rel_l2(tcarry.numpy(), jcarry) <= 1e-5
            assert float(np.abs(np.asarray(jcarry)).max()) > 0
        else:
            assert tcarry is None and jcarry is None
        # the next step from the JAX state, bridged
        jp = jp1
        tp = params_from_jax(jf1, expect=tp, module=tm.module)
        topt = toptim.SGDState(
            in_buf=params_from_jax(_flat(jopt.in_buf), expect=tp,
                                   module=tm.module),
            out_buf=topt.out_buf)
