"""Evaluation, port vs the JAX package, on the CPU.

Each model is built by both packages from one config, the port's params
bridged from the JAX init, and evaluated on the same numpy test set.
Test sets that are not a multiple of the batch exercise the padding:
the last batch is filled with rows cycled from the head of the set,
which the models' batch-statistics norm sees, and masked out of the
sums.

Bars, float32: loss within 1e-5 relative; top-1 and top-5 equal (the
logits agree to ~1e-6 and no two classes of these inputs are that
close); per-class accuracy equal; per-client loss within 1e-5 relative
and accuracy equal. The zero-initialised logistic regression ties every
class, which holds the top-k order among ties.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import torch_threads  # noqa: F401 (two torch threads a worker)
from fedtorch_tpu import config as jcfg
from fedtorch_tpu.core.losses import (
    metrics_topk as j_metrics_topk, topk_accuracy as j_topk,
)
from fedtorch_tpu.data.batching import ClientData as JClientData
from fedtorch_tpu.models import define_model as jdefine
from fedtorch_tpu.parallel import evaluate as jeval
from fedtorch_tpu.parallel.evaluate import (
    _pad_batches as j_pad, evaluate_clients as jeval_clients,
    evaluate_per_class as jeval_per_class,
)
from fedtorch_tpu_torch import config as tcfg
from fedtorch_tpu_torch.bridge import params_from_jax, params_to_jax
from fedtorch_tpu_torch.core.losses import (
    accuracy as t_accuracy, metrics_topk as t_metrics_topk,
    per_class_accuracy as t_per_class, topk_accuracy as t_topk,
)
from fedtorch_tpu_torch.data.batching import ClientData
from fedtorch_tpu_torch.models import define_model as tdefine
from fedtorch_tpu_torch.parallel.evaluate import (
    _pad_batches as t_pad, evaluate as teval,
    evaluate_clients as teval_clients, evaluate_per_class as teval_per_class,
)


def _flat(params):
    return {"/".join(k.key for k in path): np.array(v) for path, v in
            jax.tree_util.tree_flatten_with_path(params)[0]}


def _models(dataset, **model):
    sections = dict(data=("DataConfig", dict(dataset=dataset)),
                    model=("ModelConfig", model))

    def cfg(mod):
        return mod.ExperimentConfig(**{
            n: getattr(mod, c)(**kw) for n, (c, kw) in sections.items()
        }).finalize()

    jm = jdefine(cfg(jcfg))
    tm = tdefine(cfg(tcfg), device="cpu")
    jp = jm.init(jax.random.key(3))
    tp = params_from_jax(_flat(jp), expect=dict(tm.module.named_parameters()),
                         module=tm.module)
    return jm, jp, tm, tp


def _inputs(kind, n, seed=0):
    rng = np.random.RandomState(seed)
    if kind == "image":
        return (rng.randn(n, 32, 32, 3).astype(np.float32),
                rng.randint(0, 10, n).astype(np.int64))
    if kind == "flat":
        return (rng.randn(n, 60).astype(np.float32),
                rng.randint(0, 10, n).astype(np.int64))
    if kind == "targets":
        return (rng.randn(n, 60).astype(np.float32),
                rng.randn(n).astype(np.float32))
    stream = rng.randint(0, 86, n * 32 + 1)
    return (stream[:-1].reshape(n, 32).astype(np.int32),
            stream[1:].reshape(n, 32).astype(np.int32))


CASES = {
    # 300 test images: 2 batches of 256, the second with 212 cycled rows
    "resnet8": (("cifar10",), dict(arch="resnet8"), "image", 300, 256),
    "mlp": (("synthetic",), dict(arch="mlp", mlp_hidden_size=32), "flat",
            300, 256),
    "logistic_regression": (("synthetic",),
                            dict(arch="logistic_regression"), "flat", 300,
                            256),
    # regression: squared error, top-k 0
    "least_square": (("synthetic",), dict(arch="least_square"), "targets",
                     300, 256),
    # per-token statistics: 10 windows of 32 in batches of 4
    "transformer": (("shakespeare",), dict(
        arch="transformer", rnn_hidden_size=16, mlp_num_layers=2,
        rnn_seq_len=32, attention="flash"), "tokens", 10, 4),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_evaluate_matches_the_jax_package(name):
    (dataset,), model, kind, n, batch = CASES[name]
    jm, jp, tm, tp = _models(dataset, **model)
    x, y = _inputs(kind, n)
    want = jeval(jm, jp, x, y, batch_size=batch)
    got = teval(tm, tp, x, y, batch_size=batch)
    np.testing.assert_allclose(float(got.loss), float(want.loss), rtol=1e-5)
    assert float(got.top1) == pytest.approx(float(want.top1), abs=1e-7)
    assert float(got.top5) == pytest.approx(float(want.top5), abs=1e-7)
    if name == "logistic_regression":
        # zero weights: every class ties, so top-k takes the lowest ids
        assert float(got.top1) == pytest.approx(np.mean(y == 0))
        assert float(got.top5) == pytest.approx(np.mean(y < 5))


def test_padding_cycles_rows_from_the_head():
    x, y = _inputs("image", 300)
    for got, want in zip(t_pad(x, y, 256), j_pad(x, y, 256)):
        np.testing.assert_array_equal(got, want)
    bx, _, bm = t_pad(x[:3], y[:3], 8)  # pad > n: the rows cycle again
    np.testing.assert_array_equal(bx[0, 3:], x[[0, 1, 2, 0, 1]])
    assert bm.tolist() == [[1, 1, 1, 0, 0, 0, 0, 0]]


def test_padding_rows_change_the_batch_statistics():
    """Why the padding must be the JAX package's: the cycled rows enter
    the batch-statistics norm, so other padding moves the real rows'
    loss."""
    jm, jp, tm, tp = _models("cifar10", arch="resnet8")
    x, y = _inputs("image", 20)
    padded = float(teval(tm, tp, x, y, batch_size=32).loss)
    exact = float(teval(tm, tp, x, y, batch_size=20).loss)
    assert abs(padded - exact) > 1e-4
    np.testing.assert_allclose(
        padded, float(jeval(jm, jp, x, y, batch_size=32).loss), rtol=1e-5)


@pytest.mark.parametrize("name", ["resnet8", "transformer"])
def test_evaluate_per_class_matches_the_jax_package(name):
    (dataset,), model, kind, n, batch = CASES[name]
    jm, jp, tm, tp = _models(dataset, **model)
    x, y = _inputs(kind, n, seed=1)
    classes = 10 if kind == "image" else 86
    jacc, jcount = jeval_per_class(jm, jp, x, y, classes, batch_size=batch)
    tacc, tcount = teval_per_class(tm, tp, x, y, classes, batch_size=batch)
    np.testing.assert_array_equal(tcount.numpy(), np.asarray(jcount))
    np.testing.assert_allclose(tacc.numpy(), np.asarray(jacc), atol=1e-7)
    assert float(tcount.sum()) == y.size


def test_evaluate_clients_matches_and_skips_empty_clients():
    """Four clients, each with its own MLP weights; client 2 has size 0
    (it reads its row 0 but stays out of the summary)."""
    jm, jp, tm, _ = _models("synthetic", arch="mlp", mlp_hidden_size=16)
    C, n_max = 4, 40
    rng = np.random.RandomState(2)
    x = rng.randn(C, n_max, 60).astype(np.float32)
    y = rng.randint(0, 10, (C, n_max)).astype(np.int64)
    sizes = np.asarray([40, 23, 0, 7], np.int32)
    keys = jax.random.split(jax.random.key(5), C)
    jparams = jax.vmap(jm.init)(keys)
    flat = _flat(jparams)
    rows = [params_from_jax({k: v[c] for k, v in flat.items()},
                            module=tm.module) for c in range(C)]
    tparams = {k: torch.stack([r[k] for r in rows]) for k in rows[0]}
    jl, ja, js = jeval_clients(jm, jparams, JClientData(x, y, sizes),
                               batch_size=16, max_batches=2)
    tl, ta, ts = teval_clients(
        tm, tparams, ClientData(torch.from_numpy(x), torch.from_numpy(y),
                                torch.from_numpy(sizes)),
        batch_size=16, max_batches=2)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5)
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    assert set(ts) == set(js)
    for k in js:
        assert ts[k] == pytest.approx(js[k], rel=1e-5, abs=1e-7), k
    assert ts["acc_worst"] == pytest.approx(float(np.asarray(ja)[[0, 1, 3]]
                                                  .min()))


def test_topk_keeps_lax_top_k_order_among_ties():
    """bf16-like logits on a coarse grid tie often; lax.top_k ranks equal
    logits by the lower class id, +0.0 above -0.0 and NaN on top, and so
    must the port."""
    rng = np.random.RandomState(4)
    logits = np.round(rng.randn(512, 10) * 2) / 2  # -0.0 among them
    logits[:64] = 0.0  # whole rows tied
    logits[64:70] = -0.0
    logits[70, 3], logits[71, 5], logits[72] = np.nan, -np.inf, np.inf
    labels = rng.randint(0, 10, 512)
    for ks in ((1,), (1, 5), (2, 3, 7)):
        want = np.asarray(j_topk(jnp.asarray(logits, jnp.float32),
                                 jnp.asarray(labels), ks))
        got = t_topk(torch.from_numpy(logits.astype(np.float32)),
                     torch.from_numpy(labels), ks).numpy()
        np.testing.assert_array_equal(got, want)
    for classes in (2, 4, 5, 10, 86):
        assert t_metrics_topk(classes) == j_metrics_topk(classes)
    bf = torch.from_numpy(logits.astype(np.float32)).to(torch.bfloat16)
    assert float(t_accuracy(bf, torch.from_numpy(labels))) == \
        float(np.asarray(j_topk(jnp.asarray(logits, jnp.bfloat16),
                                jnp.asarray(labels), (1,)))[0])


def test_per_class_accuracy_counts_masked_rows_out():
    rng = np.random.RandomState(6)
    logits = rng.randn(50, 10).astype(np.float32)
    labels = rng.randint(0, 10, 50)
    mask = (np.arange(50) < 37).astype(np.float32)
    from fedtorch_tpu.core.losses import per_class_accuracy as j_per_class
    jc, jt = j_per_class(jnp.asarray(logits), jnp.asarray(labels), 10,
                         jnp.asarray(mask))
    tc, tt = t_per_class(torch.from_numpy(logits), torch.from_numpy(labels),
                         10, torch.from_numpy(mask))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))


def test_the_bridge_maps_explicitly_named_dense_layers_without_the_module():
    """The MLP's ``layer1`` and ``fc`` carry no flax auto-name: the
    bridge maps their leaves by name and rank."""
    jm, jp, tm, tp = _models("synthetic", arch="mlp", mlp_hidden_size=16)
    bare = params_from_jax(_flat(jp), expect=tp)
    for k, v in tp.items():
        torch.testing.assert_close(bare[k], v, rtol=0, atol=0)
    back = params_to_jax(tp)
    for k, v in _flat(jp).items():
        np.testing.assert_array_equal(back[k], v)
