"""The Switch mixture-of-experts transformer, port vs the JAX package, on
the CPU.

Inputs come from numpy seeds, weights from the JAX package's init through
``bridge.py``. The routing and the dispatch plan are compared exactly
first: a token whose two largest gate probabilities lie within
``NEAR_TIE`` of each other may take the other expert in the other package
(the gate's float32 products sum in other orders), so such tokens are
counted and the outputs held on the rest. The sparse path's backward
accumulates its gathers with ``index_put_``; only the pad rows take more
than one addend, so no bar below depends on the order of those sums.

Tolerances: float32 layer outputs and logits rtol 1e-4 / atol 1e-5 and
gradients rtol 1e-3 / atol 1e-5 (``test_torch_transformer.py``'s: the
matrix products sum in other orders); bfloat16 outputs within 5e-2 of
their scale (each package rounds to bfloat16 at its own places); the
load-balance loss rtol 1e-5; the routed and dropped fractions rtol
1e-6 (one float32 rounding: the same counts over the same routing, their
mean taken in other ways); the quantized rounds as
``tests/test_torch_round.py`` states them (the update within 1e-3
relative L2 and two downlink steps an element, losses rtol 1e-3); the
CLI's test and best top-1 within 1/128 (``test_torch_cli_zoo.py``'s).
"""
import functools
import os
import warnings

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import torch_threads  # noqa: F401 (two torch threads a worker)
from format_fixtures import write_tff_shakespeare
from fedtorch_tpu import cli as jcli
from fedtorch_tpu import config as jcfg
from fedtorch_tpu.algorithms import make_algorithm as jmake
from fedtorch_tpu.data.batching import stack_partitions as jstack
from fedtorch_tpu.models import define_model as jdefine
from fedtorch_tpu.models import transformer as jtr
from fedtorch_tpu.parallel import FederatedTrainer as JTrainer
from fedtorch_tpu_torch import cli as tcli
from fedtorch_tpu_torch import config as tcfg
from fedtorch_tpu_torch.algorithms import make_algorithm as tmake
from fedtorch_tpu_torch.bridge import params_from_jax, params_to_jax
from fedtorch_tpu_torch.data.batching import stack_partitions as tstack
from fedtorch_tpu_torch.models import define_model as tdefine
from fedtorch_tpu_torch.models import transformer as ttr
from fedtorch_tpu_torch.models.common import ModelDef
from fedtorch_tpu_torch.parallel import FederatedTrainer
from test_torch_cli import _replay_the_jax_run
from test_torch_round import _flat, _run

NEAR_TIE = 1e-6
F32 = dict(rtol=1e-4, atol=1e-5)
GRADS = dict(rtol=1e-3, atol=1e-5)
FRACTION = dict(rtol=1e-6, atol=0)
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@functools.lru_cache(maxsize=None)
def _layer(E=8, dtype="float32", cf=0.0, seed=1):
    """An MoE layer in both packages on the JAX init's weights, and a
    ``[2, 12, 16]`` input in its dtype."""
    x = np.random.RandomState(seed).randn(2, 12, 16).astype(np.float32)
    jl = jtr.MoEMLP(num_experts=E, dtype=dtype, capacity_factor=cf)
    jp = jax.jit(jl.init)(jax.random.key(0), jnp.asarray(x))["params"]
    tl = ttr.MoEMLP(16, E, dtype=DTYPES[dtype], capacity_factor=cf)
    tp = params_from_jax(_flat(jp), expect=dict(tl.named_parameters()),
                         module=tl)
    return jl, jp, tl, tp, x


def _jax_routing(jp, x):
    probs = jax.nn.softmax(jnp.asarray(x, jnp.float32)
                           @ jp["gate"]["kernel"], axis=-1)
    return np.asarray(probs), np.asarray(jnp.argmax(probs, axis=-1))


def _near_ties(probs):
    top2 = np.sort(probs, axis=-1)[..., -2:]
    return top2[..., 1] - top2[..., 0] < NEAR_TIE


def _held(got, want, dtype, where=None):
    if where is not None:
        got, want = got[where], want[where]
    if dtype == "float32":
        np.testing.assert_allclose(got, want, **F32)
    else:
        assert np.abs(got - want).max() <= 5e-2 * np.abs(want).max()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cf", [0.0, 4.0, 0.5],
                         ids=["dense", "sparse-ample", "sparse-drops"])
def test_moe_layer_routes_dispatches_and_computes_as_the_jax_layer(dtype,
                                                                   cf):
    jl, jp, tl, tp, x = _layer(dtype=dtype, cf=cf)
    xin = jnp.asarray(x).astype(dtype)
    (want, var) = jl.apply({"params": jp}, xin,
                           mutable=["aux_loss", "intermediates"])
    tx = torch.from_numpy(x).to(DTYPES[dtype])
    # the routing, then the plan, exactly
    probs, jsel = _jax_routing(jp, np.asarray(xin.astype(jnp.float32)))
    _, _, tsel = ttr.moe_route(tx, tp["gate.kernel"])
    ties = _near_ties(probs)
    flipped = tsel.numpy() != jsel
    assert not (flipped & ~ties).any()
    if cf > 0:
        capacity = ttr.moe_capacity(cf, 24, 8)
        assert capacity == max(1, int(np.ceil(cf * 24 / 8)))
        jplan = jtr.moe_dispatch_plan(jnp.asarray(jsel), 8, capacity)
        tplan = ttr.moe_dispatch_plan(torch.tensor(jsel), 8, capacity)
        for a, b in zip(jplan, tplan):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))
        if cf < 1:
            assert not bool(tplan[1].all())   # some tokens drop
    with torch.no_grad():
        got, stats = torch.func.functional_call(tl, tp, (tx,))
    # a flipped token changes its two experts' slots: hold the tokens of
    # the other experts
    touched = np.union1d(jsel[flipped], tsel.numpy()[flipped])
    held = ~np.isin(jsel, touched)
    assert held.mean() >= 0.75, (flipped.sum(), held.mean())
    _held(got.float().numpy(), np.asarray(want, np.float32), dtype, held)
    if flipped.any():
        return
    np.testing.assert_allclose(
        float(stats["load_balance"]),
        float(var["aux_loss"]["load_balance"][0]), rtol=1e-5)
    np.testing.assert_allclose(
        stats["expert_fraction"].numpy(),
        np.asarray(var["intermediates"]["expert_fraction"][0]), **FRACTION)
    assert ("drop_fraction" in stats) == (cf > 0)
    if cf > 0:
        np.testing.assert_allclose(
            float(stats["drop_fraction"]),
            float(var["intermediates"]["drop_fraction"][0]), **FRACTION)


def test_dropped_tokens_contribute_zero():
    """Every token on expert 0 (a zero gate): with capacity 2 only the
    first two tokens in storage order are computed, as in the JAX
    package."""
    jl, jp, tl, tp, x = _layer(E=4, cf=1.0)
    x = x[:1, :8]
    tp = dict(tp, **{"gate.kernel": torch.zeros(16, 4)})
    jp = dict(jp, gate={"kernel": jnp.zeros((16, 4))})
    with torch.no_grad():
        got, stats = torch.func.functional_call(
            ttr.MoEMLP(16, 4, capacity_factor=1.0), tp,
            (torch.from_numpy(x),))
    want = jtr.MoEMLP(num_experts=4, capacity_factor=1.0).apply(
        {"params": jp}, jnp.asarray(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    assert np.abs(got[0, :2].numpy()).max() > 0
    np.testing.assert_array_equal(got[0, 2:].numpy(), 0.0)
    assert float(stats["drop_fraction"]) == 0.75


@pytest.mark.parametrize("E, C, shape", [(4, 3, (2, 12)), (8, 1, (1, 24)),
                                         (3, 16, (4, 5))])
def test_dispatch_plan_is_the_jax_plan(E, C, shape):
    sel = np.random.RandomState(E).randint(0, E, shape)
    want = jtr.moe_dispatch_plan(jnp.asarray(sel), E, C)
    got = ttr.moe_dispatch_plan(torch.from_numpy(sel), E, C)
    for a, b in zip(want, got):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


def _aux_of_jax(jl, jp, x):
    _, var = jl.apply({"params": jp}, x, mutable=["aux_loss"])
    return var["aux_loss"]["load_balance"][0]


def test_aux_loss_is_near_one_under_random_routing():
    jl, jp, tl, tp, _ = _layer(E=4)
    x = np.random.RandomState(3).randn(4, 32, 16).astype(np.float32)
    with torch.no_grad():
        _, stats = torch.func.functional_call(tl, tp, (torch.from_numpy(x),))
    want = float(_aux_of_jax(jl, jp, jnp.asarray(x)))
    np.testing.assert_allclose(float(stats["load_balance"]), want,
                               rtol=1e-5)
    assert 0.9 < float(stats["load_balance"]) < 1.5


def test_aux_loss_approaches_E_when_routing_collapses():
    jl, jp, tl, tp, x = _layer(E=4)
    x = np.abs(x) + 0.1
    gate = np.zeros((16, 4), np.float32)
    gate[:, 0] = 10.0
    tp = dict(tp, **{"gate.kernel": torch.from_numpy(gate)})
    jp = dict(jp, gate={"kernel": jnp.asarray(gate)})
    with torch.no_grad():
        _, stats = torch.func.functional_call(tl, tp, (torch.from_numpy(x),))
    want = float(_aux_of_jax(jl, jp, jnp.asarray(x)))
    np.testing.assert_allclose(float(stats["load_balance"]), want,
                               rtol=1e-5)
    assert float(stats["load_balance"]) > 0.9 * 4


def test_aux_loss_gradient_is_the_jax_gradient():
    """The gate's gradient of the aux loss: nonzero, pushing away from
    the overloaded expert, the JAX package's."""
    jl, jp, tl, tp, x = _layer(E=4)
    want = jax.grad(lambda p: _aux_of_jax(jl, p, jnp.asarray(x)))(jp)
    leaves = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
    _, stats = torch.func.functional_call(tl, leaves, (torch.from_numpy(x),))
    (g,) = torch.autograd.grad(stats["load_balance"], [leaves["gate.kernel"]])
    want = np.asarray(want["gate"]["kernel"])
    assert np.abs(want).max() > 0
    np.testing.assert_allclose(g.numpy(), want, **GRADS)


# -- the model ---------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _lm(cf=0.0, layers=2, remat=False, dtype="float32"):
    kw = dict(vocab_size=32, d_model=16, num_heads=2, num_layers=layers,
              max_len=16, num_experts=4, capacity_factor=cf)
    jm = jtr.TransformerLM(**kw, dtype=dtype)
    toks = np.random.RandomState(1).randint(0, 32, (2, 16))
    jp = jax.jit(jm.init)(jax.random.key(0), jnp.asarray(toks))["params"]
    tm = ttr.TransformerLM(**kw, dtype=DTYPES[dtype], remat=remat)
    tp = params_from_jax(_flat(jp), expect=dict(tm.named_parameters()),
                         module=tm)
    return jm, jp, tm, tp, toks


@pytest.mark.parametrize("cf", [0.0, 1.25, 0.25],
                         ids=["dense", "sparse", "tight"])
def test_model_logits_aux_and_fractions_match(cf):
    jm, jp, tm, tp, toks = _lm(cf)
    want, var = jm.apply({"params": jp}, jnp.asarray(toks),
                         mutable=["aux_loss", "intermediates"])
    md = ModelDef("transformer", tm, torch.from_numpy(toks),
                  has_aux_loss=True)
    with torch.no_grad():
        logits, aux = md.apply_with_aux(tp, torch.from_numpy(toks))
    np.testing.assert_allclose(logits.numpy(), np.asarray(want), **F32)
    np.testing.assert_allclose(
        float(aux), sum(float(v) for v in jax.tree.leaves(var["aux_loss"])),
        rtol=1e-5)
    for name, tfn, jfn in (
            ("expert_fraction", ttr.routing_fractions, jtr.routing_fractions),
            ("drop_fraction", ttr.drop_fractions, jtr.drop_fractions)):
        got = tfn(tm, tp, torch.from_numpy(toks))
        want_f = jfn(jm, jp, jnp.asarray(toks))
        assert set(got) == set(want_f), name
        for block, v in want_f.items():
            np.testing.assert_allclose(got[block].numpy(), np.asarray(v),
                                       **FRACTION)
    assert set(ttr.drop_fractions(tm, tp, torch.from_numpy(toks))) == \
        (set() if cf == 0 else {"block_0", "block_1"})
    if cf == 0.25:
        assert all(float(v) > 0 for v in ttr.drop_fractions(
            tm, tp, torch.from_numpy(toks)).values())


def test_dense_model_reports_no_fractions():
    module = ttr.TransformerLM(vocab_size=32, d_model=16, num_heads=2,
                               num_layers=1, max_len=16)
    toks = torch.zeros(2, 16, dtype=torch.int64)
    params = ModelDef("t", module, toks).init(torch.Generator())
    assert ttr.routing_fractions(module, params, toks) == {}
    _, aux = torch.func.functional_call(module, params, (toks,),
                                        {"with_aux": True})
    assert float(aux["load_balance"]) == 0.0


@pytest.mark.parametrize("cf", [0.0, 1.25], ids=["dense", "sparse"])
def test_gradients_with_the_aux_term_match(cf):
    """The local step's loss, cross-entropy + 0.01 aux, differentiated in
    both packages; and remat gives the same gradients bitwise."""
    from fedtorch_tpu.core import losses as jlosses
    from fedtorch_tpu_torch.core import losses as tlosses
    jm, jp, tm, tp, toks = _lm(cf)
    labels = np.roll(toks, -1, axis=1)

    def jloss(p):
        out, var = jm.apply({"params": p}, jnp.asarray(toks),
                            mutable=["aux_loss"])
        aux = sum(jax.tree.leaves(var["aux_loss"]))
        return jlosses.softmax_cross_entropy(out, jnp.asarray(labels)) \
            + 0.01 * aux
    want = _flat(jax.grad(jloss)(jp))
    grads = {}
    for remat in (False, True):
        module = _lm(cf, remat=remat)[2]
        md = ModelDef("transformer", module, torch.from_numpy(toks),
                      has_aux_loss=True)
        leaves = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
        logits, aux = md.apply_with_aux(leaves, torch.from_numpy(toks))
        loss = tlosses.softmax_cross_entropy(
            logits, torch.from_numpy(labels)) + 0.01 * aux
        grads[remat] = params_to_jax(dict(zip(leaves, torch.autograd.grad(
            loss, list(leaves.values())))), module)
    for k, v in want.items():
        np.testing.assert_allclose(grads[False][k], v, err_msg=k, **GRADS)
        np.testing.assert_array_equal(grads[True][k], grads[False][k])


def _cfg(mod, **model):
    return mod.ExperimentConfig(
        data=mod.DataConfig(dataset="shakespeare"),
        model=mod.ModelConfig(arch="transformer", **model)).finalize()


def test_define_model_builds_moe_blocks_and_warns_as_the_jax_package():
    kw = dict(rnn_hidden_size=8, mlp_num_layers=1, rnn_seq_len=16,
              moe_experts=8)
    with warnings.catch_warnings(record=True) as jw:
        warnings.simplefilter("always")
        jdefine(_cfg(jcfg, **kw))
    with warnings.catch_warnings(record=True) as tw:
        warnings.simplefilter("always")
        model = tdefine(_cfg(tcfg, **kw), device="cpu")
    assert [str(w.message) for w in tw] == [str(w.message) for w in jw]
    assert len(tw) == 1 and model.has_aux_loss
    assert model.module.block_0.moe.num_experts == 8
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        sparse = tdefine(_cfg(tcfg, **kw, moe_capacity_factor=1.25),
                         device="cpu")
        dense = tdefine(_cfg(tcfg, rnn_hidden_size=8), device="cpu")
    assert sparse.module.block_0.moe.capacity_factor == 1.25
    assert not dense.has_aux_loss


def test_parameter_tree_of_the_moe_cell():
    """The chip's ``moe_transformer`` path: d_model 256, 4 heads of 64, 4
    layers, 16 experts: the JAX package's tree, 35,274,326 params, 8
    leaves of 4,194,304 elements (past the ragged pair's 524,288)."""
    kw = dict(rnn_hidden_size=128, mlp_num_layers=4, rnn_seq_len=2048,
              moe_experts=16, moe_capacity_factor=1.25)
    module = tdefine(_cfg(tcfg, **kw), device="cpu").module
    shapes = jax.eval_shape(jdefine(_cfg(jcfg, **kw)).init,
                            jax.random.key(0))
    flat = {"/".join(k.key for k in path): np.zeros(v.shape, np.float32)
            for path, v in jax.tree_util.tree_flatten_with_path(shapes)[0]}
    bridged = params_from_jax(flat, expect=dict(module.named_parameters()),
                              module=module)
    sizes = [v.numel() for v in bridged.values()]
    assert sum(sizes) == 35_274_326
    assert sorted(n for n in sizes if n > 524_288) == [4_194_304] * 8


# -- the federated round and the CLI -----------------------------------------

C, N, B, K = 4, 8, 4, 2


def _round_build(aux_weight):
    """Both trainers on the JAX expert-parallel tests' MoE round (d_model
    16, 1 layer, T 16, 2 experts at capacity factor 1.5, 4 clients of 8
    windows, all online, batch 4, 2 local steps, SGD lr 0.05), quantized
    int8 both ways; the port on the JAX package's weights."""
    def cfg(mod):
        return mod.ExperimentConfig(
            data=mod.DataConfig(dataset="shakespeare", batch_size=B),
            federated=mod.FederatedConfig(
                federated=True, num_clients=C, online_client_rate=1.0,
                algorithm="fedavg", sync_type="local_step", quantized=True),
            model=mod.ModelConfig(arch="transformer", mlp_num_layers=1,
                                  rnn_seq_len=16, rnn_hidden_size=8,
                                  moe_experts=2, moe_capacity_factor=1.5,
                                  moe_aux_weight=aux_weight),
            optim=mod.OptimConfig(lr=0.05, weight_decay=0.0),
            train=mod.TrainConfig(local_step=K)).finalize()

    jc, tc = cfg(jcfg), cfg(tcfg)
    rng = np.random.RandomState(3)
    x = rng.randint(0, 86, (C * N, 16)).astype(np.int32)
    y = np.roll(x, -1, axis=1).astype(np.int32)
    parts = [np.arange(i * N, (i + 1) * N) for i in range(C)]
    jtrainer = JTrainer(jc, jdefine(jc, batch_size=B), jmake(jc),
                        jstack(x, y, parts))
    js, jcl = jtrainer.init_state(jax.random.key(0))
    ttrainer = FederatedTrainer(tc, tdefine(tc, batch_size=B, device="cpu"),
                                tmake(tc), tstack(x, y, parts), device="cpu")
    assert ttrainer.model.has_aux_loss
    ts, tcl = ttrainer.init_state(0)
    bridged = params_from_jax(_flat(js.params), expect=ts.params,
                              module=ttrainer.model.module)
    ts = ts._replace(params=bridged)
    for n, p in tcl.params.items():
        p[:] = bridged[n]
    return jtrainer, js, jcl, ttrainer, ts, tcl


@functools.lru_cache(maxsize=None)
def _round(aux_weight):
    return _run(*_round_build(aux_weight), num_rounds=1)


@pytest.mark.parametrize("aux_weight", [0.0, 0.01])
def test_quantized_moe_round_matches_the_jax_round(aux_weight):
    (jp0, tp0, _, _), (jp, tp, jl, tl) = _round(aux_weight)
    ju = np.concatenate([(jp[k] - jp0[k]).ravel() for k in jp])
    tu = np.concatenate([(tp[k] - tp0[k]).ravel() for k in jp])
    assert np.linalg.norm(tu - ju) <= 1e-3 * np.linalg.norm(ju)
    for k in jp:
        u = jp[k] - jp0[k]
        step = (u.max() - u.min()) / 255.0
        assert np.abs((tp[k] - tp0[k]) - u).max() <= 2 * step + 1e-7, k
    np.testing.assert_allclose(tl, jl, rtol=1e-3, atol=1e-5)


def test_the_aux_term_enters_the_reported_loss():
    """With the weight on, the round's losses carry the aux term: they
    differ from the weight-off round's, as in the JAX package."""
    off, on = _round(0.0)[1][3], _round(0.01)[1][3]
    assert np.isfinite(on).all() and np.abs(on - off).max() > 1e-6


def test_cli_moe_run_returns_the_jax_cli_s_results(tmp_path, monkeypatch):
    """``-a transformer`` with the three MoE flags on TFF shakespeare
    files: from the JAX run's weights and draws, the port's results dict
    within 1/128 of the JAX CLI's."""
    text = "".join(np.random.RandomState(4).choice(
        list("abcdefgh ,.\n"), 2400))
    write_tff_shakespeare(
        os.path.join(tmp_path, "shakespeare", "shakespeare_train.h5"),
        {f"CLIENT_{i}": [text[i * 300:(i + 1) * 300]] for i in range(8)})
    argv = ["--backend", "cpu", "-f", "true", "-d", "shakespeare", "-p",
            str(tmp_path), "-a", "transformer", "--rnn_hidden_size", "8",
            "--mlp_num_layers", "1", "--rnn_seq_len", "16", "--moe_experts",
            "4", "--moe_capacity_factor", "1.25", "--moe_aux_weight", "0.01",
            "--num_workers", "8", "--online_client_rate", "0.5",
            "--federated_sync_type", "local_step", "--local_step", "2", "-b",
            "4", "--lr", "0.1", "--num_comms", "2", "--eval_freq", "1",
            "--debug", "false"]
    want = jcli.main(argv + ["-c", str(tmp_path / "jax")])
    port = argv + ["-c", str(tmp_path / "port")]
    _replay_the_jax_run(monkeypatch, port, 2)
    got = tcli.main(port)
    assert got["rounds"] == 2
    for key in ("test_top1", "best_top1"):
        assert abs(got[key] - want[key]) <= 1 / 128, key
