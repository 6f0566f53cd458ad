"""The transformer LM, port vs the JAX package, on the CPU.

Both packages build the model through ``define_model`` (d_model =
2 * rnn_hidden_size, 4 heads where they divide it), the port on weights
bridged from the JAX package's init. On the CPU the JAX package's flash
attention runs its XLA oracle and chunked custom VJP, the port's its
plain version and chunked torch-op backward.

Tolerances: float32 logits rtol 1e-4 / atol 1e-5 and gradients rtol
1e-3 / atol 1e-5 (matrix products sum in other orders); bfloat16 logits
within 5e-2 of their scale (each package rounds to bfloat16 at its own
places, about 3 significant digits); the federated rounds as
tests/test_torch_round.py states them.
"""
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import torch_threads  # noqa: F401 (two torch threads a worker)
from fedtorch_tpu import config as jcfg
from fedtorch_tpu.algorithms import make_algorithm as jmake
from fedtorch_tpu.core import losses as jlosses
from fedtorch_tpu.core.optim import _wd_coef as j_wd_coef
from fedtorch_tpu.data.batching import stack_partitions as jstack
from fedtorch_tpu.models import define_model as jdefine
from fedtorch_tpu.models.transformer import TransformerLM as JTransformerLM
from fedtorch_tpu.parallel import FederatedTrainer as JTrainer
from fedtorch_tpu_torch import config as tcfg
from fedtorch_tpu_torch.algorithms import make_algorithm as tmake
from fedtorch_tpu_torch.bridge import params_from_jax, params_to_jax
from fedtorch_tpu_torch.core import losses as tlosses
from fedtorch_tpu_torch.core.optim import _wd_coef as t_wd_coef
from fedtorch_tpu_torch.data.batching import stack_partitions as tstack
from fedtorch_tpu_torch.models import define_model as tdefine
from fedtorch_tpu_torch.models.transformer import TransformerLM
from fedtorch_tpu_torch.parallel import FederatedTrainer
from test_torch_round import _assert_params_close, _flat, _run

T, V = 32, 86


def _cfg(mod, attention="flash", dtype="float32", hidden=32, layers=2,
         seq=T, **sections):
    kw = dict(
        data=mod.DataConfig(dataset="shakespeare"),
        model=mod.ModelConfig(arch="transformer", rnn_hidden_size=hidden,
                              mlp_num_layers=layers, rnn_seq_len=seq,
                              vocab_size=V, attention=attention),
        mesh=mod.MeshConfig(compute_dtype=dtype))
    kw.update({k: v(mod) for k, v in sections.items()})
    return mod.ExperimentConfig(**kw).finalize()


@functools.lru_cache(maxsize=None)
def _models(attention="flash", dtype="float32", hidden=32, layers=2):
    """Both packages' models on the same (bridged) weights."""
    jm = jdefine(_cfg(jcfg, attention, dtype, hidden, layers), batch_size=3)
    tm = tdefine(_cfg(tcfg, attention, dtype, hidden, layers), batch_size=3,
                 device="cpu")
    jp = jax.jit(jm.init)(jax.random.key(3))
    tp = params_from_jax(_flat(jp), expect=tm.init(torch.Generator()),
                         module=tm.module)
    return jm, tm, jp, tp


def _tokens(B=3, seed=0, seq=T):
    return np.random.RandomState(seed).randint(0, V, (B, seq))


def _wide_modules(jm, tm, head_dim):
    """The ModelDefs with their modules swapped for d_model 2 x
    ``head_dim`` in 2 heads of ``head_dim``, 1 layer, flash (define_model
    gives 4 heads; heads of 256 from it need d_model 1024, heads of 512
    d_model 2048)."""
    d = 2 * head_dim
    return (jm._replace(module=JTransformerLM(
                vocab_size=V, d_model=d, num_heads=2, num_layers=1,
                attention="flash")),
            tm._replace(module=TransformerLM(V, d, 2, 1,
                                             attention="flash")))


@functools.lru_cache(maxsize=None)
def _wide_models(head_dim):
    """Both packages' d_model 2 x ``head_dim``, 2-head models on the
    same (bridged) weights, T 64."""
    jm, tm = _wide_modules(
        jdefine(_cfg(jcfg, hidden=head_dim, layers=1, seq=64), batch_size=2),
        tdefine(_cfg(tcfg, hidden=head_dim, layers=1, seq=64), batch_size=2,
                device="cpu"), head_dim)
    jp = jax.jit(jm.init)(jax.random.key(5))
    tp = params_from_jax(_flat(jp), expect=tm.init(torch.Generator()),
                         module=tm.module)
    return jm, tm, jp, tp


def test_bridge_round_trip():
    jm, tm, jp, tp = _models()
    flat = _flat(jp)
    back = params_to_jax(tp, tm.module)
    assert set(back) == set(flat)
    for k, v in flat.items():
        np.testing.assert_array_equal(back[k], v)
    # every kind of leaf, under its flax name
    for key in ("pos_embed", "tok_embed.weight", "block_1.ln2.weight",
                "block_0.attn.qkv.weight", "block_0.mlp_in.bias",
                "head.weight"):
        assert key in tp, key
    np.testing.assert_array_equal(tp["block_0.attn.qkv.weight"].numpy(),
                                  flat["block_0/attn/qkv/kernel"].T)
    # a leaf of a module without a rule, and one the model does not have
    with pytest.raises(ValueError, match="unmatched flax leaf"):
        params_from_jax({**flat, "block_0/attn/qkv/scale": np.zeros(3)},
                        module=tm.module)
    with pytest.raises(ValueError, match="unmatched torch leaf"):
        params_to_jax({**tp, "block_9.ln1.weight": torch.zeros(3)},
                      tm.module)


@pytest.mark.parametrize("attention, dtype, hidden, layers", [
    pytest.param(a, d, 32, 2, id=f"{a}-{d}") for d in ("float32", "bfloat16")
    for a in ("dense", "flash")] + [
    # the default width (rnn_hidden_size 50: d_model 100, 4 heads of 25)
    # and d_model 512 (4 heads of 128), one layer each
    pytest.param("flash", d, h, 1, id=f"flash-{d}-d{2 * h}")
    for h in (50, 256) for d in ("float32", "bfloat16")])
def test_logits_match(attention, dtype, hidden, layers):
    jm, tm, jp, tp = _models(attention, dtype, hidden, layers)
    assert tm.module.block_0.attn.num_heads == 4
    toks = _tokens()
    want = np.asarray(jm.apply(jp, jnp.asarray(toks, jnp.int32)))
    with torch.no_grad():
        got = tm.apply(tp, torch.from_numpy(toks)).numpy()
    assert got.shape == (3, T, V) and got.dtype == np.float32
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    else:
        assert np.abs(got - want).max() <= 5e-2 * np.abs(want).max()


def test_head_dim_256_logits_and_gradients_match():
    """d_model 512 in 2 heads of 256, 1 layer, T 64, flash attention,
    float32: logits and the char-LM loss's gradients, at the tolerances
    above."""
    _hold_wide_logits_and_gradients(256)


def test_head_dim_512_logits_and_gradients_match():
    """d_model 1024 in 2 heads of 512 (the TF32 kernel's column blocks
    on the card), 1 layer, T 64, flash attention, float32: logits and
    gradients at the tolerances above."""
    _hold_wide_logits_and_gradients(512)


def _hold_wide_logits_and_gradients(head_dim):
    jm, tm, jp, tp = _wide_models(head_dim)
    d = 2 * head_dim
    assert tm.module.block_0.attn.num_heads == 2
    assert tp["block_0.attn.qkv.weight"].shape == (3 * d, d)
    toks = _tokens(B=2, seed=2, seq=64)
    labels = np.roll(toks, -1, axis=1)
    want = np.asarray(jm.apply(jp, jnp.asarray(toks, jnp.int32)))
    leaves = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
    logits = tm.apply(leaves, torch.from_numpy(toks))
    np.testing.assert_allclose(logits.detach().numpy(), want, rtol=1e-4,
                               atol=1e-5)
    jg = jax.grad(lambda p: jlosses.softmax_cross_entropy(
        jm.apply(p, jnp.asarray(toks, jnp.int32)),
        jnp.asarray(labels, jnp.int32)))(jp)
    loss = tlosses.softmax_cross_entropy(logits, torch.from_numpy(labels))
    grads = torch.autograd.grad(loss, list(leaves.values()))
    tg = params_to_jax(dict(zip(leaves, grads)), tm.module)
    for k, v in _flat(jg).items():
        np.testing.assert_allclose(tg[k], v, rtol=1e-3, atol=1e-5,
                                   err_msg=k)


def test_rnn_hidden_size_512_gives_4_heads_of_256():
    """The d_model-1024 transformer cell: both packages derive 4 heads
    of 256 from rnn_hidden_size 512."""
    tm = tdefine(_cfg(tcfg, hidden=512, layers=1), batch_size=1,
                 device="cpu").module
    jm = jdefine(_cfg(jcfg, hidden=512, layers=1), batch_size=1).module
    assert tm.pos_embed.shape == (2048, 1024)
    assert tm.block_0.attn.num_heads == jm.num_heads == 4
    assert jm.d_model // jm.num_heads == 256


def _heads(hidden):
    """(d_model, heads) that both packages' define_model derive from
    ``rnn_hidden_size`` (meta device for the port: no weights)."""
    tm = tdefine(_cfg(tcfg, hidden=hidden, layers=1), batch_size=1,
                 device="meta").module
    jm = jdefine(_cfg(jcfg, hidden=hidden, layers=1), batch_size=1).module
    assert tm.pos_embed.shape[1] == jm.d_model
    assert tm.block_0.attn.num_heads == jm.num_heads
    return jm.d_model, jm.num_heads


def test_rnn_hidden_size_1024_gives_4_heads_of_512():
    """The d_model-2048 transformer cell: both packages derive 4 heads
    of 512 from rnn_hidden_size 1024."""
    assert _heads(1024) == (2048, 4)


def test_rnn_hidden_size_257_gives_2_heads_of_257():
    """An odd rnn_hidden_size from 257 up: d_model 514, which 4 does not
    divide, in 2 heads of 257 (the TF32 kernel's column blocks on the
    card), in both packages."""
    assert _heads(257) == (514, 2)


def test_dense_and_flash_agree():
    toks = torch.from_numpy(_tokens())
    _, dense, _, tp = _models("dense")
    _, flash, _, _ = _models("flash")
    with torch.no_grad():
        torch.testing.assert_close(flash.apply(tp, toks),
                                   dense.apply(tp, toks),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("attention", ["dense", "flash"])
def test_causality(attention):
    """Changing a future token leaves every earlier logit alone."""
    _, tm, _, tp = _models(attention)
    toks = _tokens()
    toks2 = toks.copy()
    toks2[:, 20] = (toks2[:, 20] + 1) % V
    with torch.no_grad():
        a = tm.apply(tp, torch.from_numpy(toks))
        b = tm.apply(tp, torch.from_numpy(toks2))
    torch.testing.assert_close(a[:, :20], b[:, :20], rtol=0, atol=1e-6)
    assert not torch.allclose(a[:, 20:], b[:, 20:])


@pytest.mark.parametrize("attention", ["dense", "flash"])
def test_char_lm_gradients_match(attention):
    jm, tm, jp, tp = _models(attention)
    toks = _tokens(seed=1)
    labels = np.roll(toks, -1, axis=1)
    jg = jax.grad(lambda p: jlosses.softmax_cross_entropy(
        jm.apply(p, jnp.asarray(toks, jnp.int32)),
        jnp.asarray(labels, jnp.int32)))(jp)
    leaves = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
    loss = tlosses.softmax_cross_entropy(
        tm.apply(leaves, torch.from_numpy(toks)), torch.from_numpy(labels))
    grads = torch.autograd.grad(loss, list(leaves.values()))
    tg = params_to_jax(dict(zip(leaves, grads)), tm.module)
    for k, v in _flat(jg).items():
        np.testing.assert_allclose(tg[k], v, rtol=1e-3, atol=1e-5,
                                   err_msg=k)


def test_parameter_tree_of_the_slice():
    """The main path's configuration: d_model 256, 4 heads of 64, 4
    layers, max_len 2048: the JAX package's tree, 3,723,862 parameters
    in 46 leaves of 8 sizes."""
    kw = dict(hidden=128, layers=4, seq=2048, dtype="bfloat16")
    module = tdefine(_cfg(tcfg, **kw), device="cpu").module
    jshapes = jax.eval_shape(jdefine(_cfg(jcfg, **kw)).init,
                             jax.random.key(0))
    flat = {"/".join(k.key for k in path): np.zeros(v.shape, np.float32)
            for path, v in jax.tree_util.tree_flatten_with_path(jshapes)[0]}
    params = dict(module.named_parameters())
    bridged = params_from_jax(flat, expect=params, module=module)
    sizes = [v.numel() for v in bridged.values()]
    assert sum(sizes) == 3_723_862 and len(sizes) == 46
    assert len(set(sizes)) == 8 and max(sizes) == 524_288
    assert module.block_0.attn.num_heads == 4


def test_weight_decay_skips_the_same_leaves():
    """wd_skip_norm_bias: the LayerNorm scales and every bias, as the
    JAX package's rule over the flax names."""
    _, tm, jp, tp = _models()
    ocfg = tcfg.OptimConfig(weight_decay=0.1, wd_skip_norm_bias=True)
    jcoef = j_wd_coef(jcfg.OptimConfig(weight_decay=0.1,
                                       wd_skip_norm_bias=True))
    want = {"/".join(k.key for k in path): jcoef(path) for path, _ in
            jax.tree_util.tree_flatten_with_path(jp)[0]}
    tcoef = t_wd_coef(ocfg)
    paths = params_to_jax(tp, tm.module)  # same order as tp
    assert {p: tcoef(k) for k, p in zip(tp, paths)} == want


# -- the repairs of the shared modules ---------------------------------------

def test_stack_partitions_keeps_sequence_labels():
    """[N, T] token windows with next-token labels stack to [C, n_max,
    T] in both packages, array for array."""
    rng = np.random.RandomState(0)
    x = rng.randint(0, V, (11, 16)).astype(np.int32)
    y = np.roll(x, -1, axis=1)
    parts = [np.arange(0, 4), np.arange(4, 6), np.arange(6, 11)]
    j, t = jstack(x, y, parts), tstack(x, y, parts)
    assert t.y.shape == (3, 5, 16)
    for a, b in zip(j, t):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


@pytest.mark.parametrize("shape", [(6, V), (3, 7, V)])
def test_losses_and_accuracy_match(shape):
    rng = np.random.RandomState(4)
    logits = rng.randn(*shape).astype(np.float32)
    labels = rng.randint(0, V, shape[:-1])
    labels.flat[0] = logits.reshape(-1, V)[0].argmax()  # one hit at least
    tl, ty = torch.from_numpy(logits), torch.from_numpy(labels)
    for name in ("per_sample_nll", "softmax_cross_entropy", "accuracy"):
        want = np.asarray(getattr(jlosses, name)(logits, labels))
        got = getattr(tlosses, name)(tl, ty).numpy()
        assert got.shape == want.shape, name
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6,
                                   err_msg=name)


# -- federated rounds --------------------------------------------------------

C, N, B, K = 4, 8, 4, 2


def _round_build(quantized, clients=C, steps=K, seq=16, rate=0.5,
                 head_dim=None):
    """Both trainers on d_model 16, 1 layer, T 16, 4 clients of 8
    windows, k = 2, batch 4, 2 local steps, SGD lr 0.05 without weight
    decay, flash attention; the port on the JAX package's weights.
    ``head_dim``: the model of :func:`_wide_modules` (2 heads of that
    width) instead, at the given clients, online rate, steps and T."""
    def cfg(mod):
        return _cfg(
            mod, hidden=8, layers=1, seq=seq,
            data=lambda m: m.DataConfig(dataset="shakespeare", batch_size=B),
            federated=lambda m: m.FederatedConfig(
                federated=True, num_clients=clients, online_client_rate=rate,
                algorithm="fedavg", sync_type="local_step",
                quantized=quantized),
            optim=lambda m: m.OptimConfig(lr=0.05, weight_decay=0.0),
            train=lambda m: m.TrainConfig(local_step=steps))

    jc, tc = cfg(jcfg), cfg(tcfg)
    rng = np.random.RandomState(2)
    stream = rng.randint(0, V, clients * N * seq + 1)
    x = stream[:-1].reshape(clients * N, seq).astype(np.int32)
    y = stream[1:].reshape(clients * N, seq).astype(np.int32)
    parts = [np.arange(i * N, (i + 1) * N) for i in range(clients)]
    jm, tm = jdefine(jc, batch_size=B), tdefine(tc, batch_size=B,
                                                device="cpu")
    if head_dim:
        jm, tm = _wide_modules(jm, tm, head_dim)
    jtr = JTrainer(jc, jm, jmake(jc), jstack(x, y, parts))
    js, jcl = jtr.init_state(jax.random.key(0))
    ttr = FederatedTrainer(tc, tm, tmake(tc), tstack(x, y, parts),
                           device="cpu")
    ts, tcl = ttr.init_state(0)
    bridged = params_from_jax(_flat(js.params), expect=ts.params,
                              module=ttr.model.module)
    ts = ts._replace(params=bridged)
    for n, p in tcl.params.items():
        p[:] = bridged[n]
    return jtr, js, jcl, ttr, ts, tcl


def test_fedavg_round_matches():
    jp, tp, jl, tl = _run(*_round_build(False), num_rounds=1)[1]
    _assert_params_close(tp, jp)
    np.testing.assert_allclose(tl, jl, rtol=1e-4, atol=1e-6)


def _hold_quantized_rounds(trace, rounds):
    for r in rounds:
        (jp0, tp0, _, _), (jp, tp, jl, tl) = trace[r - 1], trace[r]
        ju = np.concatenate([(jp[k] - jp0[k]).ravel() for k in jp])
        tu = np.concatenate([(tp[k] - tp0[k]).ravel() for k in jp])
        assert np.linalg.norm(tu - ju) <= 1e-3 * np.linalg.norm(ju)
        for k in jp:
            u = jp[k] - jp0[k]
            step = (u.max() - u.min()) / 255.0
            assert np.abs((tp[k] - tp0[k]) - u).max() <= 2 * step + 1e-7, k
        np.testing.assert_allclose(tl, jl, rtol=1e-3, atol=1e-5)


def test_quantized_fedavg_rounds_match():
    """int8 uplink and downlink, each round restarted from the JAX
    state: the update within 1e-3 relative L2 and every element within
    two downlink steps."""
    _hold_quantized_rounds(
        _run(*_round_build(True), num_rounds=2, resync=True), (1, 2))


def test_quantized_fedavg_round_at_head_dim_256():
    """One int8 round of the heads-of-256 model (2 clients, both
    online, 1 local step, T 32) from the JAX state, held as above: its
    qkv (786,432 elements) and MLP weights (1,048,576) take the tiled
    quantizer, its other leaves the ragged one."""
    _hold_quantized_rounds(
        _run(*_round_build(True, clients=2, steps=1, seq=32, rate=1.0,
                           head_dim=256), num_rounds=1, resync=True), (1,))


def test_quantized_fedavg_round_at_head_dim_512():
    """One int8 round of the heads-of-512 model (d_model 1024, 2
    clients, both online, 1 local step, T 32) from the JAX state, held
    as above: its qkv (3,145,728 elements) and MLP weights (4,194,304)
    take the tiled quantizer, its other leaves the ragged one."""
    _hold_quantized_rounds(
        _run(*_round_build(True, clients=2, steps=1, seq=32, rate=1.0,
                           head_dim=512), num_rounds=1, resync=True), (1,))
