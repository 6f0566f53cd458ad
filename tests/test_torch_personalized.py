"""The personalized algorithms (APFL, PerFedMe, PerFedAvg), port vs the
JAX package, on the CPU.

MLP (2 layers of 32, batch statistics), CIFAR-10-shaped inputs, 8
clients of 20 samples split by ``train_val_split`` (16 train, 4 val),
online rate 0.25 (k = 2), batch 8, 2 local steps, float32, no
augmentation. Both packages start from the same weights and client aux
(copied from the JAX package). The cohort, the training rows and (for
PerFedAvg) the validation rows of every round are replayed from the key
chain the JAX ``round_fn`` folds (its ``VAL_FOLD`` stream) and injected
into the port's ``RoundPlan``.

Held after 1 and after 3 rounds: the server params and every tensor of
every client's aux (the personal model and its optimizer state, alpha,
the local snapshot), each tree within ``REL`` (1e-5) of its largest
|value|, as ``test_torch_zoo.py`` holds the zoo; the reported losses
(1e-4 relative) and accuracies; ``evaluate_personal``'s ``[C]`` losses
(1e-5 relative) and accuracies and its summary. The ResNet-8 APFL case
(two train-mode forwards of a batch-statistics net a step) holds the
server params at the same bar and its client aux to the port's own
spread over CPU summation orders (see there). Quantized APFL uses
``test_torch_round.py``'s int8 bars, each round from the JAX package's
state.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import torch_threads  # noqa: F401 (two torch threads a worker)
from fedtorch_tpu import config as jcfg
from fedtorch_tpu.algorithms import make_algorithm as jmake
from fedtorch_tpu.data import build_federated_data as jbuild_data
from fedtorch_tpu.data.batching import (
    VAL_FOLD, round_row_plan as j_round_row_plan, stack_partitions as jstack,
    train_val_split as j_train_val_split,
)
from fedtorch_tpu.models import define_model as jdefine
from fedtorch_tpu.parallel import FederatedTrainer as JTrainer
from fedtorch_tpu.parallel.evaluate import (
    evaluate_personal as j_evaluate_personal,
)
from fedtorch_tpu_torch import config as tcfg
from fedtorch_tpu_torch.algorithms import make_algorithm as tmake
from fedtorch_tpu_torch.bridge import params_to_jax
from fedtorch_tpu_torch.data import build_federated_data as tbuild_data
from fedtorch_tpu_torch.data.batching import (
    stack_partitions as tstack, train_val_split,
)
from fedtorch_tpu_torch.models import define_model as tdefine
from fedtorch_tpu_torch.parallel import FederatedTrainer, evaluate_personal

from test_torch_zoo import (
    _assert_state_close, _copy_state, _flat, _groups, _plans as zoo_plans,
)

C, N, B, K = 8, 20, 8, 2
REL = 1e-5


def _plain(tree):
    """NamedTuples (the optimizer states) as dicts, for the zoo's tree
    walkers; everything else as it is."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return {f: _plain(getattr(tree, f)) for f in tree._fields}
    if isinstance(tree, dict):
        return {k: _plain(v) for k, v in tree.items()}
    return tree


def _config(mod, algorithm, arch, sync_type, lr, in_momentum, **fed):
    model = dict(arch=arch, mlp_hidden_size=32) if arch == "mlp" \
        else dict(arch=arch)
    return mod.ExperimentConfig(
        data=mod.DataConfig(dataset="cifar10", batch_size=B, augment=False),
        federated=mod.FederatedConfig(
            federated=True, num_clients=C, online_client_rate=0.25,
            algorithm=algorithm, sync_type=sync_type, **fed),
        model=mod.ModelConfig(**model),
        optim=mod.OptimConfig(lr=lr, in_momentum=in_momentum),
        train=mod.TrainConfig(local_step=K)).finalize()


def _build(algorithm, arch="mlp", sizes=(N,) * C, sync_type="local_step",
           lr=0.1, in_momentum=False, val=True, **fed):
    jc = _config(jcfg, algorithm, arch, sync_type, lr, in_momentum, **fed)
    tc = _config(tcfg, algorithm, arch, sync_type, lr, in_momentum, **fed)
    assert jc.federated.personal and tc.federated.personal
    rng = np.random.RandomState(0)
    feats = rng.randn(sum(sizes), 32, 32, 3).astype(np.float32)
    labels = rng.randint(0, 10, sum(sizes))
    ends = np.cumsum(sizes)
    parts, vparts = train_val_split(
        [np.arange(e - s, e) for s, e in zip(sizes, ends)],
        tc.data.val_fraction, seed=0)
    jval = jstack(feats, labels, vparts) if val else None
    tval = tstack(feats, labels, vparts) if val else None
    jtr = JTrainer(jc, jdefine(jc, batch_size=B), jmake(jc),
                   jstack(feats, labels, parts), val_data=jval)
    js, jcl = jtr.init_state(jax.random.key(0))
    ttr = FederatedTrainer(tc, tdefine(tc, batch_size=B, device="cpu"),
                           tmake(tc), tstack(feats, labels, parts),
                           val_data=tval, device="cpu")
    ts, tcl = ttr.init_state(0)
    # the JAX package's weights, and the client aux made from them
    ts = _copy_state(js, jcl, ts, tcl, ttr.model.module)
    return jtr, js, jcl, ttr, ts, tcl


def _plans(jtr, js, num_rounds):
    """The zoo's replayed plans, plus each online client's validation
    rows from the ``VAL_FOLD`` stream when the algorithm takes them."""
    plans = zoo_plans(jtr, js, num_rounds)
    if not jtr.algorithm.needs_val_batch:
        return plans
    key = jax.random.wrap_key_data(jax.random.key_data(js.rng))
    v_n_max = jtr.val_data.x.shape[1]
    out = []
    for r, plan in enumerate(plans):
        _, rng_train = jax.random.split(jax.random.fold_in(key, r))
        rngs = jax.random.split(rng_train, jtr.k_online)
        idx = jnp.asarray(plan.idx.numpy())
        vrows = jax.vmap(lambda rc, s: j_round_row_plan(
            rc, s, v_n_max, jtr.local_steps * jtr.batch_size, VAL_FOLD))(
                rngs, jnp.take(jtr.val_data.sizes, idx))
        out.append(plan._replace(
            vrows=torch.from_numpy(np.array(vrows)).long()))
    return out


def _run(jtr, js, jcl, ttr, ts, tcl, num_rounds):
    for plan in _plans(jtr, js, num_rounds):
        js, jcl, jm = jtr.run_round(js, jcl)
        ts, tcl, tm = ttr.round_fn(ts, tcl, plan)
        np.testing.assert_array_equal(tm.online_mask.numpy(),
                                      np.asarray(jm.online_mask)[:C])
        np.testing.assert_allclose(tm.train_loss.numpy(),
                                   np.asarray(jm.train_loss)[:C],
                                   rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(tm.train_acc.numpy(),
                                   np.asarray(jm.train_acc)[:C], atol=1e-6)
    return js, jcl, ts, tcl


def _assert_close(js, jcl, ts, tcl, module):
    return _assert_state_close(js, jcl._replace(aux=_plain(jcl.aux)), ts,
                               tcl._replace(aux=_plain(tcl.aux)), module)


def _assert_personal_eval_close(jtr, jcl, ttr, tcl, name):
    jl, ja, jsum = j_evaluate_personal(jtr.model, jcl.aux, jcl.params,
                                       jtr.val_data, name)
    tl, ta, tsum = evaluate_personal(ttr.model, tcl.aux, tcl.params,
                                     ttr.val_data, name)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl)[:C], rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja)[:C], atol=1e-6)
    assert set(tsum) == set(jsum)
    for key, want in jsum.items():
        assert abs(tsum[key] - float(want)) <= 1e-5 * max(
            abs(float(want)), 1.0), (key, tsum, jsum)
    return tsum


CASES = {
    "apfl": ("apfl", dict(lr=0.1)),
    "apfl_adaptive_alpha": ("apfl", dict(lr=0.1, adaptive_alpha=True)),
    # lr lambda = 0.05 * 15 < 1: the personal model does not oscillate
    "perfedme": ("perfedme", dict(lr=0.05)),
    "perfedavg": ("perfedavg", dict(lr=0.1, perfedavg_beta=0.05)),
    "perfedavg_momentum": ("perfedavg", dict(lr=0.1, in_momentum=True)),
}


@pytest.mark.parametrize("num_rounds", [1, 3])
@pytest.mark.parametrize("case", sorted(CASES))
def test_rounds_match_the_jax_package(case, num_rounds):
    algorithm, kw = CASES[case]
    built = _build(algorithm, **kw)
    w0 = _flat(built[1].params)["layer1/kernel"]
    js, jcl, ts, tcl = _run(*built, num_rounds)
    n = _assert_close(js, jcl, ts, tcl, built[3].model.module)
    assert n >= 3
    assert not np.allclose(_flat(js.params)["layer1/kernel"], w0)
    summary = _assert_personal_eval_close(built[0], jcl, built[3], tcl,
                                          algorithm)
    assert all(np.isfinite(v) for v in summary.values())


def test_adaptive_alpha_is_one_value_for_the_online_clients():
    """After a round with ``adaptive_alpha`` every online client holds
    the online mean of the updated alphas (the JAX package's), in [0,
    1], and it moved; the offline clients keep their alpha."""
    built = _build("apfl", adaptive_alpha=True)
    plan = _plans(built[0], built[1], 1)[0]
    js, jcl, ts, tcl = _run(*built, 1)
    alpha = tcl.aux["alpha"]
    on = plan.idx.tolist()
    off = [c for c in range(C) if c not in on]
    assert len(set(alpha[on].tolist())) == 1
    assert 0.0 <= float(alpha[on[0]]) <= 1.0
    assert float(alpha[on[0]]) != 0.5
    assert alpha[off].tolist() == [0.5] * len(off)
    np.testing.assert_allclose(alpha.numpy(), np.asarray(jcl.aux["alpha"]),
                               rtol=1e-6)


def test_perfedme_pull_fires_at_each_client_s_own_budget():
    """Epoch sync over unequal clients: K = 2 batches of the largest
    client, a client of <= 8 training rows stops after one step, and its
    pull of w toward theta fires there (``step_budget``), before K; the
    running count's every-5th-step pull fires in the third round. Every
    client keeps at least 2 val rows: the evaluation batch cycles a
    client's val rows, and 64 copies of one row have zero variance under
    the batch-statistics norm, so the logits tie up to rounding noise and
    the top-1 is decided by it, in either package."""
    sizes = (20, 10, 12, 20, 10, 15, 10, 20)
    built = _build("perfedme", sizes=sizes, sync_type="epoch", lr=0.05)
    assert built[3].local_steps == 2
    js, jcl, ts, tcl = _run(*built, 3)
    _assert_close(js, jcl, ts, tcl, built[3].model.module)
    _assert_personal_eval_close(built[0], jcl, built[3], tcl, "perfedme")


def _client_tree_gaps(pairs):
    """{tree: the largest over clients of max |got - want| / max |want|}
    for ``(tree, client, [(want, got)])`` numpy leaf pairs."""
    out = {}
    for tree, leaves in pairs:
        scale = max(float(np.abs(w).max()) for w, _ in leaves)
        err = max(float(np.abs(g.astype(np.float64) - w).max())
                  for w, g in leaves)
        out[tree] = max(out.get(tree, 0.0), err / max(scale, 1e-30))
    return out


def _jax_vs_port(jcl, tcl, ref, module):
    return _client_tree_gaps(
        (where.split("[")[0], [(w, g) for _, w, g in leaves])
        for where, leaves in _groups(_plain(jcl.aux), _plain(tcl.aux), ref,
                                     module, "clients"))


def _port_vs_port(a, b, where="clients"):
    """The same groups as ``_jax_vs_port`` over two port aux trees."""
    if isinstance(a, dict) and all("." in k for k in a):
        lead = next(iter(a.values())).shape[0]
        for c in range(lead):
            yield where, [(a[k][c].numpy().astype(np.float64),
                           b[k][c].numpy()) for k in a]
    elif isinstance(a, dict):
        for k in a:
            yield from _port_vs_port(a[k], b[k], f"{where}/{k}")
    elif isinstance(a, torch.Tensor):
        yield where, [(a.numpy().astype(np.float64), b.numpy())]


def test_apfl_resnet8_matches():
    """ResNet-8 with batch-statistics norms: the mixed output is two
    train-mode forwards, each normalising with its own batch's
    statistics; adaptive alpha and momentum on, 1 round at lr 0.01.
    The server params are held at ``REL``. A ReLU kink moves the
    gradients by ~1e-3 of a momentum buffer between two summation orders
    of one package (ROADMAP C; 1.6e-3 between 1 and 4 CPU threads of the
    port), so each client aux tree is held to twice the gap between the
    port and itself on one CPU thread, or to 2 ``REL``. At lr 0.1
    a kink flips the local model's own steps in the first round, which
    are FedAvg's: there the port's APFL server params are its FedAvg's
    bitwise, so that gap to the JAX package is FedAvg's own."""
    kw = dict(arch="resnet8", adaptive_alpha=True, in_momentum=True,
              lr=0.01)
    jtr, js, jcl, ttr, ts, tcl = _build("apfl", **kw)
    plans = _plans(jtr, js, 1)
    js, jcl, ts, tcl = _run(jtr, js, jcl, ttr, ts, tcl, 1)
    module = ttr.model.module
    _assert_state_close(js, jcl._replace(aux=()), ts, tcl._replace(aux=()),
                        module)
    gaps = _jax_vs_port(jcl, tcl, ts.params, module)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        _, _, _, ttr1, ts1, tcl1 = _build("apfl", **kw)
        for plan in plans:
            ts1, tcl1, _ = ttr1.round_fn(ts1, tcl1, plan)
    finally:
        torch.set_num_threads(threads)
    spread = _client_tree_gaps(_port_vs_port(_plain(tcl.aux),
                                             _plain(tcl1.aux)))
    assert set(gaps) == set(spread)
    for tree, gap in gaps.items():
        assert gap <= 2 * max(spread[tree], REL), (tree, gap, spread[tree])
    _assert_personal_eval_close(jtr, jcl, ttr, tcl, "apfl")

    servers = {}
    for algorithm in ("apfl", "fedavg"):
        jtr, js, _, ttr, ts, tcl = _build(algorithm, arch="resnet8",
                                          adaptive_alpha=True,
                                          personal=True)
        servers[algorithm] = ttr.round_fn(ts, tcl,
                                          _plans(jtr, js, 1)[0])[0].params
    for n, v in servers["apfl"].items():
        assert torch.equal(v, servers["fedavg"][n]), n


def _assert_aux_close(jcl, tcl, ref, module):
    """Every client aux tree within ``REL`` of its largest |value|."""
    for where, leaves in _groups(_plain(jcl.aux), _plain(tcl.aux), ref,
                                 module, "clients"):
        scale = max(float(np.abs(w).max()) for _, w, _ in leaves)
        for leaf, want, got in leaves:
            err = np.abs(got.astype(np.float64) - want).max()
            assert err <= REL * max(scale, 1e-30), (where, leaf, err, scale)


def test_quantized_apfl_rounds_match():
    """``-q``: FedAvg's int8 wire format through the quantizer's plain
    version, each round from the JAX package's state: the server update
    within 1e-3 relative L2 and two downlink steps an element, the
    client aux (trained before the wire format) at ``REL``."""
    jtr, js, jcl, ttr, ts, tcl = _build("apfl", quantized=True,
                                        adaptive_alpha=True)
    module = ttr.model.module
    for r, plan in enumerate(_plans(jtr, js, 3)):
        if r:
            ts = _copy_state(js, jcl, ts, tcl, module)
        jp0 = _flat(js.params)
        tp0 = params_to_jax(ts.params, module)
        js, jcl, _ = jtr.run_round(js, jcl)
        ts, tcl, _ = ttr.round_fn(ts, tcl, plan)
        jp, tp = _flat(js.params), params_to_jax(ts.params, module)
        ju = np.concatenate([(jp[k] - jp0[k]).ravel() for k in jp])
        tu = np.concatenate([(tp[k] - tp0[k]).ravel() for k in jp])
        assert np.linalg.norm(tu - ju) <= 1e-3 * np.linalg.norm(ju)
        for k in jp:
            u = jp[k] - jp0[k]
            step = (u.max() - u.min()) / 255.0
            assert np.abs((tp[k] - tp0[k]) - u).max() <= 2 * step + 1e-7, k
        _assert_aux_close(jcl, tcl, ts.params, module)


def test_perfedavg_without_val_data_raises_the_jax_message():
    with pytest.raises(ValueError) as want:
        _build("perfedavg", val=False)
    cfg = _config(tcfg, "perfedavg", "mlp", "local_step", 0.1, False)
    data = tstack(np.zeros((16, 32, 32, 3), np.float32), np.zeros(16, int),
                  [np.arange(2 * i, 2 * i + 2) for i in range(C)])
    with pytest.raises(ValueError) as got:
        FederatedTrainer(cfg, tdefine(cfg, batch_size=B, device="cpu"),
                         tmake(cfg), data, device="cpu")
    assert str(got.value) == str(want.value)
    assert "perfedavg needs per-client validation batches" in str(got.value)


@pytest.mark.parametrize("name, cls", [("apfl", "APFL"),
                                       ("perfedme", "PerFedMe"),
                                       ("perfedavg", "PerFedAvg")])
def test_personalized_algorithms_are_made_by_name(name, cls):
    """``make_algorithm`` builds each by name, personalization forced on
    by the config; only PerFedAvg takes a validation batch a step."""
    cfg = tcfg.ExperimentConfig(federated=tcfg.FederatedConfig(
        federated=True, num_clients=C, algorithm=name)).finalize()
    alg = tmake(cfg)
    assert type(alg).__name__ == cls and alg.name == name
    assert cfg.federated.personal
    assert alg.needs_val_batch == (name == "perfedavg")
    jc = jcfg.ExperimentConfig(federated=jcfg.FederatedConfig(
        federated=True, num_clients=C, algorithm=name)).finalize()
    assert jmake(jc).needs_val_batch == alg.needs_val_batch


@pytest.mark.parametrize("sizes", [(20, 7, 1, 12), (5, 5, 2, 30)])
@pytest.mark.parametrize("fraction", [0.2, 0.5])
def test_train_val_split_is_bitwise(sizes, fraction):
    """One ``RandomState(seed)`` permutes the partitions in turn;
    ``max(int(n f), 1)`` val rows, none for a client of one sample."""
    ends = np.cumsum(sizes)
    parts = [np.arange(e - s, e) for s, e in zip(sizes, ends)]
    want = j_train_val_split(parts, fraction, seed=3)
    got = train_val_split(parts, fraction, seed=3)
    for w, g in zip(want, got):
        assert len(w) == len(g)
        for a, b in zip(w, g):
            np.testing.assert_array_equal(a, b)
    assert [len(v) for v in got[1]] == [
        max(int(s * fraction), 1) if s > 1 else 0 for s in sizes]


@pytest.mark.parametrize("iid", [True, False])
def test_build_federated_data_with_personal_is_bitwise(iid):
    """``build_federated_data`` with ``personal``: the train and val
    tensors and sizes of the JAX package's, on the synthetic task."""
    def cfg(mod):
        return mod.ExperimentConfig(
            data=mod.DataConfig(dataset="synthetic", iid=iid),
            federated=mod.FederatedConfig(
                federated=True, num_clients=6, algorithm="apfl"),
            train=mod.TrainConfig(manual_seed=5)).finalize()
    want, got = jbuild_data(cfg(jcfg)), tbuild_data(cfg(tcfg))
    assert got.val is not None
    for split in ("train", "val"):
        w, g = getattr(want, split), getattr(got, split)
        for field in ("x", "y", "sizes"):
            np.testing.assert_array_equal(
                getattr(g, field).numpy(), np.asarray(getattr(w, field)))
    np.testing.assert_array_equal(got.test_x, np.asarray(want.test_x))
