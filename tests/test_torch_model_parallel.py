"""The port's sequence, expert, tensor and pipeline parallelism against
the JAX package's, on the CPU.

Each world size, 2 and 4, is one spawned gloo group
(``tests/torch_dist.py``, a ``FileStore`` under ``tmp_path``, ranks at one
thread, a 60 s collective timeout) that runs every case below; each case
is its own test, held against the JAX function on a mesh of the same size
(``conftest.py`` gives JAX 8 CPU devices). Inputs come from numpy seeds,
the models' weights from the JAX package's init through ``bridge.py``.
The port's functions take and give each rank's shard where the JAX ones
take and give whole arrays, so the tests cut the inputs and join the
outputs by rank.

Tolerances, float32 throughout: attention outputs atol = rtol = 2e-5 and
their gradients atol 5e-5 / rtol 5e-4, held against the JAX package's
dense oracle ``reference_attention`` (the bars at which its own tests
hold its ring's and Ulysses' gradients to that oracle); the expert layer
atol = rtol = 2e-5 (its tests' bar); logits of a whole model rtol 1e-4 / atol 1e-5 and its
gradients rtol 1e-3 / atol 1e-5 (``test_torch_transformer.py``'s: the
matrix products sum in other orders); refusals by the JAX package's
text.
"""
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import Mesh

import torch_threads  # noqa: F401 (two torch threads a worker)
from torch_dist import Group
from fedtorch_tpu.core.losses import softmax_cross_entropy
from fedtorch_tpu.models.transformer import (
    MoEMLP as JMoE, TransformerLM as JLM, long_context_apply as jlong,
)
from fedtorch_tpu.parallel.expert import ep_moe_apply as jep
from fedtorch_tpu.parallel.pipeline import pipeline_apply as jpipe
from fedtorch_tpu.parallel.sequence import (
    reference_attention as jreference, ring_attention as jring,
    ulysses_attention as julysses,
)
from fedtorch_tpu.parallel.tensor import (
    tp_apply as jtp, transformer_tp_specs as jspecs,
)
from fedtorch_tpu_torch.bridge import params_from_jax
from fedtorch_tpu_torch.models.transformer import (
    MoEMLP as TMoE, TransformerLM as TLM,
)

WORLDS = (2, 4)
ATTN = dict(atol=2e-5, rtol=2e-5)
ATTN_GRAD = dict(atol=5e-5, rtol=5e-4)
LOGITS = dict(rtol=1e-4, atol=1e-5)
GRADS = dict(rtol=1e-3, atol=1e-5)


def _mesh(n, name):
    return Mesh(np.asarray(jax.devices()[:n]), (name,))


def _flat(tree):
    return {"/".join(k.key for k in path): np.array(v) for path, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


@functools.lru_cache(maxsize=None)
def _qkv(h=4, seed=0):
    return tuple(np.random.RandomState(seed).randn(3, 2, 32, h, 16)
                 .astype(np.float32))


@functools.lru_cache(maxsize=None)
def _lm(**kw):
    """A model of ``kw`` in both packages on the JAX init's weights:
    (jax module, jax params, model kwargs, port params as numpy)."""
    kw = dict(kw)
    seq, batch = kw.pop("seq"), kw.pop("batch")
    model = dict(kw, max_len=seq)
    jm = JLM(**model)
    toks = np.random.RandomState(1).randint(0, kw["vocab_size"],
                                            (batch, seq)).astype(np.int32)
    jp = jax.jit(jm.init)(jax.random.key(0), jnp.asarray(toks))["params"]
    module = TLM(**model)
    tp = params_from_jax(_flat(jp), expect=dict(module.named_parameters()),
                         module=module)
    return jm, jp, model, {k: v.numpy() for k, v in tp.items()}, toks


SEQ_LM = dict(vocab_size=32, d_model=32, num_heads=4, num_layers=2, seq=64,
              batch=2)
SEQ_MOE = dict(SEQ_LM, num_experts=4, capacity_factor=1.25)
TP_LM = dict(vocab_size=64, d_model=32, num_heads=4, num_layers=2, seq=32,
             batch=4)
TP_FALLBACK = dict(TP_LM, d_model=25, num_heads=5)
TP_MOE = dict(TP_LM, num_experts=4)
PP_LM = dict(vocab_size=48, d_model=32, num_heads=4, num_layers=4, seq=24,
             batch=8)
PP_MOE = dict(vocab_size=32, d_model=16, num_heads=2, num_layers=4, seq=16,
              batch=4, num_experts=4)
PP_REMAT = dict(PP_LM, remat=True)


@functools.lru_cache(maxsize=None)
def _moe_layer(E=8):
    layer = JMoE(num_experts=E)
    x = np.random.RandomState(2).randn(2, 12, 16).astype(np.float32)
    jp = jax.jit(layer.init)(jax.random.key(0), jnp.asarray(x))["params"]
    module = TMoE(16, E)
    tp = params_from_jax(_flat(jp), expect=dict(module.named_parameters()),
                         module=module)
    return jp, {k: v.numpy() for k, v in tp.items()}, x


def _lm_case(spec):
    _, _, model, params, toks = _lm(**spec)
    return dict(model=model, params=params, tokens=toks.astype(np.int64))


def _case_table(world):
    """``[(name, case function, inputs)]`` of one world size, ``inputs`` a
    function that builds the case's kwargs (collection builds nothing)."""
    table = []

    def add(name, fn, inputs):
        table.append((name, fn, inputs))

    def qkv(h=4):
        return dict(zip("qkv", _qkv(h=h)))
    for strategy in ("ring", "ulysses"):
        for impl in ("dense", "flash"):
            for causal in (False, True):
                add(f"{strategy}-{impl}-{'causal' if causal else 'full'}",
                    "attention", lambda s=strategy, i=impl, c=causal: dict(
                        qkv(), strategy=s, causal=c, block_impl=i))
    for strategy, impl in (("ring", "dense"), ("ring", "flash"),
                           ("ulysses", "flash")):
        add(f"{strategy}-{impl}-causal-grad", "attention",
            lambda s=strategy, i=impl: dict(qkv(), strategy=s, causal=True,
                                            block_impl=i, grad=True))
    add("ulysses-indivisible-heads", "refusal", lambda: dict(
        qkv(world + 1), case="attention", strategy="ulysses", causal=True,
        block_impl="dense"))
    for strategy in ("ring", "ulysses"):
        add(f"{strategy}-unknown-block-impl", "refusal",
            lambda s=strategy: dict(qkv(), case="attention", strategy=s,
                                    causal=False, block_impl="sparse"))
    for strategy in ("ring", "ulysses"):
        for impl in ("dense", "flash"):
            add(f"long-context-{strategy}-{impl}", "long_context",
                lambda s=strategy, i=impl: dict(
                    _lm_case(SEQ_LM), strategy=s, block_impl=i))
    add("long-context-ring-flash-grad", "long_context", lambda: dict(
        _lm_case(SEQ_LM), strategy="ring", block_impl="flash", grad=True))
    add("long-context-moe-ring-flash", "long_context", lambda: dict(
        _lm_case(SEQ_MOE), strategy="ring", block_impl="flash"))
    add("long-context-unknown-strategy", "refusal", lambda: dict(
        _lm_case(SEQ_LM), case="long_context", strategy="sparse",
        block_impl="dense"))
    for name, cf in (("dense", 0.0), ("sparse-ample", 8.0),
                     ("sparse-drops", 0.5)):
        add(f"expert-{name}", "expert", lambda cf=cf: dict(
            params=_moe_layer()[1], x=_moe_layer()[2], capacity_factor=cf))
    add("expert-indivisible", "refusal", lambda: dict(
        case="expert", params=_moe_layer(2 * world - 1)[1],
        x=_moe_layer()[2], capacity_factor=0.0))
    for name, spec in (("tp", TP_LM), ("tp-fallback", TP_FALLBACK),
                       ("tp-moe", TP_MOE)):
        add(name, "tensor", lambda spec=spec: _lm_case(spec))
    if world == 4:
        add("dp-tp-2x2", "tensor", lambda: dict(_lm_case(TP_LM), dp=True))
    for m in ((2, 1) if world == 2 else (4, 8)):
        add(f"pipeline-m{m}", "pipeline", lambda m=m: dict(
            _lm_case(PP_LM), num_microbatches=m))
    add("pipeline-moe", "pipeline", lambda: dict(_lm_case(PP_MOE),
                                                 num_microbatches=2))
    add("pipeline-remat", "pipeline", lambda: dict(_lm_case(PP_REMAT),
                                                   num_microbatches=world))
    add("pipeline-indivisible-layers", "refusal", lambda: dict(
        _lm_case(dict(PP_LM, num_layers=world + 1)), case="pipeline",
        num_microbatches=None))
    add("pipeline-indivisible-batch", "refusal", lambda: dict(
        _lm_case(dict(PP_LM, batch=6)), case="pipeline",
        num_microbatches=4))
    return table


@functools.lru_cache(maxsize=None)
def _cases(world):
    """``{name: (case function, kwargs)}`` of one world size."""
    return {name: (fn, dict(inputs(), world=world))
            for name, fn, inputs in _case_table(world)}


CASES = [(w, name) for w in WORLDS for name, _, _ in _case_table(w)]


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    started = {w: Group(w, [(n, fn, kw) for n, (fn, kw)
                            in _cases(w).items()],
                        tmp_path_factory.mktemp(f"gloo{w}"))
               for w in WORLDS}
    yield started
    for g in started.values():
        if g.results is None:
            g.results = g._collect()


def _join(per_rank):
    """The ranks' sequence shards joined on dim 1."""
    return np.concatenate(per_rank, axis=1)


def _refusal(fn, *args, **kwargs):
    with pytest.raises(ValueError) as err:
        fn(*args, **kwargs)
    return str(err.value)


def _jax_attention(world, name, kw):
    fn = jring if kw["strategy"] == "ring" else julysses
    mesh = _mesh(world, "sp")
    q, k, v = (jnp.asarray(t) for t in (kw["q"], kw["k"], kw["v"]))

    @jax.jit
    def run(q, k, v):
        return fn(q, k, v, mesh, causal=kw["causal"],
                  block_impl=kw["block_impl"])
    if not kw.get("grad"):
        return run(q, k, v)
    # the gradients against the JAX package's dense oracle, as its own
    # tests hold its ring's and Ulysses' (at the same bar)
    grads = jax.grad(lambda *a: jnp.sum(jreference(
        *a, causal=kw["causal"]) ** 2), argnums=(0, 1, 2))(q, k, v)
    return [run(q, k, v), *grads]


def _jax_long_context(world, name, kw, spec):
    jm, jp, _, _, toks = _lm(**spec)
    mesh = _mesh(world, "sp")

    @jax.jit
    def run(p):
        return jlong(jm, p, jnp.asarray(toks), mesh,
                     strategy=kw["strategy"], block_impl=kw["block_impl"])
    if not kw.get("grad"):
        return run(jp)
    # the sequence-parallel forward trains as the dense one does
    labels = jnp.roll(jnp.asarray(toks), -1, axis=1)
    grads = jax.grad(lambda p: softmax_cross_entropy(
        jm.apply({"params": p}, jnp.asarray(toks)), labels))(jp)
    module = TLM(**_lm(**spec)[2])
    return params_from_jax(_flat(grads), module=module)


_SPECS = {"long-context": SEQ_LM, "long-context-moe": SEQ_MOE}


@pytest.mark.parametrize("world, name", CASES,
                         ids=[f"{w}-{n}" for w, n in CASES])
def test_matches_the_jax_package(groups, world, name):
    fn, kw = _cases(world)[name]
    if fn == "attention":
        want = _jax_attention(world, name, kw)
        got = groups[world].result(name)
        if kw.get("grad"):
            for i, what in enumerate(("out", "dq", "dk", "dv")):
                np.testing.assert_allclose(
                    _join([r[i] for r in got]), np.asarray(want[i]),
                    err_msg=what, **(ATTN if i == 0 else ATTN_GRAD))
        else:
            np.testing.assert_allclose(_join(got), np.asarray(want), **ATTN)
    elif fn == "long_context":
        spec = SEQ_MOE if "moe" in name else SEQ_LM
        want = _jax_long_context(world, name, kw, spec)
        got = groups[world].result(name)
        for r in got:
            if kw.get("grad"):
                for key, g in want.items():
                    np.testing.assert_allclose(r[key], g.numpy(),
                                               err_msg=key, **GRADS)
            else:
                np.testing.assert_allclose(r, np.asarray(want), **LOGITS)
    elif fn == "expert":
        jp, _, x = _moe_layer()
        want = jax.jit(lambda p, x: jep(
            p, x, _mesh(world, "ep"),
            capacity_factor=kw["capacity_factor"]))(jp, jnp.asarray(x))
        for r in groups[world].result(name):
            np.testing.assert_allclose(r, np.asarray(want), **ATTN)
    elif fn == "tensor":
        _check_tensor(groups, world, name, kw)
    elif fn == "pipeline":
        spec = {"pipeline-moe": PP_MOE,
                "pipeline-remat": PP_REMAT}.get(name, PP_LM)
        jm, jp, _, _, toks = _lm(**spec)
        want = jpipe(jm, jp, jnp.asarray(toks), _mesh(world, "pp"),
                     num_microbatches=kw["num_microbatches"])
        for r in groups[world].result(name):
            np.testing.assert_allclose(r, np.asarray(want), **LOGITS)
    else:
        assert groups[world].result(name) == [_jax_refusal(world, name, kw)] \
            * world


def _jax_refusal(world, name, kw):
    if kw["case"] == "attention":
        fn = jring if kw["strategy"] == "ring" else julysses
        return _refusal(fn, *(jnp.asarray(kw[t]) for t in "qkv"),
                        _mesh(world, "sp"), causal=kw["causal"],
                        block_impl=kw["block_impl"])
    if kw["case"] == "long_context":
        jm, jp, _, _, toks = _lm(**SEQ_LM)
        return _refusal(jlong, jm, jp, jnp.asarray(toks), _mesh(world, "sp"),
                        strategy=kw["strategy"])
    if kw["case"] == "expert":
        jp, _, x = _moe_layer(2 * world - 1)
        return _refusal(jep, jp, jnp.asarray(x), _mesh(world, "ep"))
    spec = dict(PP_LM, num_layers=world + 1) if "layers" in name \
        else dict(PP_LM, batch=6)
    jm, jp, _, _, toks = _lm(**spec)
    return _refusal(jpipe, jm, jp, jnp.asarray(toks), _mesh(world, "pp"),
                    num_microbatches=kw["num_microbatches"])


def _check_tensor(groups, world, name, kw):
    spec = {"tp-fallback": TP_FALLBACK, "tp-moe": TP_MOE}.get(name, TP_LM)
    jm, jp, _, _, toks = _lm(**spec)
    got = groups[world].result(name)
    if kw.get("dp"):
        mesh = Mesh(np.asarray(jax.devices()[:4]).reshape(2, 2),
                    ("dp", "tp"))
        want = np.asarray(jtp(jm, jp, jnp.asarray(toks), mesh,
                              dp_axis="dp"))
        # rank = 2 * dp + tp: each dp row's two tp ranks give its rows
        for r, res in enumerate(got):
            half = (r // 2) * 2
            np.testing.assert_allclose(res["out"], want[half:half + 2],
                                       **LOGITS)
        mesh_tp = mesh
    else:
        mesh_tp = _mesh(world, "tp")
        want = np.asarray(jtp(jm, jp, jnp.asarray(toks), mesh_tp))
        for res in got:
            np.testing.assert_allclose(res["out"], want, **LOGITS)
    # the JAX specs, on the port's (out, in) weights
    placement = {"PartitionSpec()": "R",
                 "PartitionSpec('tp',)": "S(0)",
                 "PartitionSpec(None, 'tp')": "S(0)",
                 "PartitionSpec('tp', None)": "S(1)"}
    jflat = jax.tree_util.tree_flatten_with_path(
        jspecs(jp, mesh=mesh_tp), is_leaf=lambda s: isinstance(
            s, jax.sharding.PartitionSpec))[0]
    # params_from_jax keeps the flax leaves' order, the specs tree's
    keys = params_from_jax(_flat(jp), module=TLM(**_lm(**spec)[2]))
    want_specs = {key: placement[repr(s)]
                  for key, (_, s) in zip(keys, jflat)}
    assert got[0]["specs"] == want_specs
    if name == "tp-fallback":
        assert want_specs["block_0.attn.qkv.weight"] == "R"
        assert want_specs["block_0.mlp_in.weight"] == "S(0)"
