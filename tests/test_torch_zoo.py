"""The algorithm zoo beyond FedAvg, port vs the JAX package, on the CPU.

MLP (2 layers of 32, batch statistics), CIFAR-10-shaped inputs, 8
clients of 16 samples, online rate 0.25 (k = 2), batch 8, 2 local steps,
plain local SGD (SCAFFOLD's control update assumes it), float32, no
augmentation. Both packages start from the same weights (bridged). The
cohort and rows of every round, DRFA's snapshot step (``fold_in(rng,
11)``) and its second phase's cohort and rows (``fold_in(rng, 99)``,
the JAX package's own ``host_probe_fn``) are replayed from the key chain
the JAX ``round_fn`` folds and injected into the port's ``RoundPlan``.

Held after 1 and after 3 rounds: the server params, every tensor of the
server aux (SCAFFOLD's control, AFL's and DRFA's lambda, DRFA's gamma
and kth_avg) and of every client's aux (control, tracking delta,
error-feedback memory, DRFA's snapshot and step). Unquantized, each
tree within ``REL`` of the tree's largest |value| (1e-5, as
``test_torch_round.py``; the matrix products sum in other orders), the
tracking variate and the memory within ``REL_TRACKING`` (1e-4: see
there).
Quantized FedCOMGATE uses ``test_torch_round.py``'s int8 bars: each
round from the JAX package's state (params and aux copied into the
port), the round's server update within 1e-3 relative L2 and two
downlink quantization steps per element.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import torch_threads  # noqa: F401 (two torch threads a worker)
from fedtorch_tpu import config as jcfg
from fedtorch_tpu.algorithms import make_algorithm as jmake
from fedtorch_tpu.data.batching import (
    round_row_plan as j_round_row_plan, stack_partitions as jstack,
)
from fedtorch_tpu.models import define_model as jdefine
from fedtorch_tpu.parallel import FederatedTrainer as JTrainer
from fedtorch_tpu.parallel.federated import participation_indices
from fedtorch_tpu_torch import config as tcfg
from fedtorch_tpu_torch.algorithms import make_algorithm as tmake
from fedtorch_tpu_torch.bridge import params_from_jax, params_to_jax
from fedtorch_tpu_torch.data.batching import stack_partitions as tstack
from fedtorch_tpu_torch.models import define_model as tdefine
from fedtorch_tpu_torch.parallel import FederatedTrainer, RoundPlan

C, N, B, K = 8, 16, 8, 2
REL = 1e-5
# FedGATE's tracking variate (and the error-feedback memory beside it) is
# a difference of the round delta and the aggregate over lr*K = 0.2:
# cancellation makes its rounding relative to the deltas, not to itself.
# Largest gaps over 3 rounds, measured (CPU): 2.8e-5 (drfa over fedgate)
# and 1.9e-5 (top-k at 0.5) of the variate's largest |value|.
REL_TRACKING = 1e-4


def _build(algorithm, sizes=(N,) * C, sync_type="local_step", **fed):
    sections = dict(
        data=("DataConfig", dict(dataset="cifar10", batch_size=B,
                                 augment=False)),
        federated=("FederatedConfig", dict(
            federated=True, num_clients=C, online_client_rate=0.25,
            algorithm=algorithm, sync_type=sync_type, **fed)),
        model=("ModelConfig", dict(arch="mlp", mlp_hidden_size=32)),
        optim=("OptimConfig", dict(lr=0.1)),
        train=("TrainConfig", dict(local_step=K)))

    def cfg(mod):
        return mod.ExperimentConfig(**{
            name: getattr(mod, cls)(**kw)
            for name, (cls, kw) in sections.items()}).finalize()

    jc, tc = cfg(jcfg), cfg(tcfg)
    rng = np.random.RandomState(0)
    feats = rng.randn(sum(sizes), 32, 32, 3).astype(np.float32)
    labels = rng.randint(0, 10, sum(sizes))
    ends = np.cumsum(sizes)
    parts = [np.arange(e - s, e) for s, e in zip(sizes, ends)]

    jtr = JTrainer(jc, jdefine(jc, batch_size=B), jmake(jc),
                   jstack(feats, labels, parts))
    js, jcl = jtr.init_state(jax.random.key(0))
    ttr = FederatedTrainer(tc, tdefine(tc, batch_size=B, device="cpu"),
                           tmake(tc), tstack(feats, labels, parts),
                           device="cpu")
    ts, tcl = ttr.init_state(0)
    module = ttr.model.module
    bridged = params_from_jax(_flat(js.params), expect=ts.params,
                              module=module)
    ts = ts._replace(params=bridged)
    for n, p in tcl.params.items():
        p[:] = bridged[n]
    return jtr, js, jcl, ttr, ts, tcl


def _flat(params):
    return {"/".join(k.key for k in path): np.array(v) for path, v in
            jax.tree_util.tree_flatten_with_path(params)[0]}


def _plans(jtr, js, num_rounds):
    """The JAX round_fn's cohort and rows, DRFA's snapshot step and its
    probe, replayed from the key chain."""
    key = jax.random.wrap_key_data(jax.random.key_data(js.rng))
    k, n_max = jtr.k_online, jtr.data.x.shape[1]
    alg = jtr.algorithm
    plans = []
    for r in range(num_rounds):
        rng_round = jax.random.fold_in(key, r)
        rng_sample, rng_train = jax.random.split(rng_round)
        idx = participation_indices(rng_sample, jtr.num_clients, k,
                                    jnp.int32(r))
        rngs = jax.random.split(rng_train, k)
        rows = jax.vmap(lambda rc, s: j_round_row_plan(
            rc, s, n_max, jtr.local_steps * jtr.batch_size))(
                rngs, jnp.take(jtr.data.sizes, idx))
        plan = RoundPlan(torch.from_numpy(np.array(idx)).long(),
                         torch.from_numpy(np.array(rows)).long())
        if alg.name == "drfa":
            k_rand = jax.random.randint(
                jax.random.fold_in(rng_round, 11), (), 1,
                max(jtr.local_steps, 2))
            idx2, rows2 = alg.host_probe_fn(jtr.data.sizes)(rng_round)
            plan = plan._replace(
                k_rand=int(k_rand),
                probe_idx=torch.from_numpy(np.array(idx2)).long(),
                probe_rows=torch.from_numpy(np.array(rows2)).long())
        plans.append(plan)
    return plans


def _is_params(node, ref) -> bool:
    return isinstance(node, dict) and set(node) == set(ref)


def _groups(jnode, tnode, ref, module, where=""):
    """(name, [(leaf, jax array, port array)]) for every params-shaped
    subtree of a server or client state tree (per client for a leading
    [C] axis), in the JAX layout, and for every other tensor."""
    if _is_params(tnode, ref):
        jflat = _flat(jnode)
        lead = next(iter(tnode.values())).dim() > \
            next(iter(ref.values())).dim()
        for c in range(C) if lead else [None]:
            row = tnode if c is None else {n: v[c] for n, v in tnode.items()}
            yield (where if c is None else f"{where}[{c}]"), [
                (n, jflat[n] if c is None else jflat[n][c], v)
                for n, v in params_to_jax(row, module).items()]
        return
    if isinstance(tnode, dict):
        assert set(jnode) == set(tnode), (where, set(jnode), set(tnode))
        for key in tnode:
            yield from _groups(jnode[key], tnode[key], ref, module,
                               f"{where}/{key}")
        return
    if isinstance(tnode, torch.Tensor):
        want = np.array(jnode)
        yield where, [("", want[:C] if tnode.dim() else want,
                       tnode.detach().numpy())]
        return
    assert tnode == () and jnode == (), where


def _assert_state_close(js, jcl, ts, tcl, module, rel=REL):
    """Server params and aux, client aux: every leaf of a params-shaped
    tree (or a bare tensor) within ``rel`` of the tree's largest |value|
    (a leaf can be all rounding noise: the MLP's first bias, whose
    gradient the batch norm after it cancels)."""
    trees = (("params", js.params, ts.params), ("server", js.aux, ts.aux),
             ("clients", jcl.aux, tcl.aux))
    n = 0
    for name, jt, tt in trees:
        for where, leaves in _groups(jt, tt, ts.params, module, name):
            scale = max(float(np.abs(w).max()) for _, w, _ in leaves)
            bar = REL_TRACKING if where.split("[")[0].endswith(
                ("/delta", "/memory")) else rel
            for leaf, want, got in leaves:
                assert got.shape == want.shape, (where, leaf, got.shape)
                err = np.abs(got.astype(np.float64) - want).max()
                assert err <= bar * max(scale, 1e-30), \
                    (where, leaf, err, scale)
                n += 1
    return n


def _run(jtr, js, jcl, ttr, ts, tcl, num_rounds):
    for plan in _plans(jtr, js, num_rounds):
        js, jcl, jm = jtr.run_round(js, jcl)
        ts, tcl, tm = ttr.round_fn(ts, tcl, plan)
        np.testing.assert_array_equal(tm.online_mask.numpy(),
                                      np.asarray(jm.online_mask))
        np.testing.assert_allclose(tm.train_loss.numpy(),
                                   np.asarray(jm.train_loss), rtol=1e-4,
                                   atol=1e-6)
        np.testing.assert_allclose(float(tm.comm_bytes),
                                   float(jm.comm_bytes), rtol=1e-6)
    return js, jcl, ts, tcl


CASES = {
    "scaffold": ("scaffold", {}),
    "fedgate": ("fedgate", {}),
    "fedgate_topk_0.5": ("fedgate", dict(compressed=True,
                                         compressed_ratio=0.5)),
    "fedgate_topk_0.1": ("fedgate", dict(compressed=True,
                                         compressed_ratio=0.1)),
    "qsparse": ("qsparse", dict(compressed_ratio=0.5)),
    "qffl_q0": ("qffl", dict(qffl_q=0.0)),
    "qffl_q1": ("qffl", dict(qffl_q=1.0)),
    "afl": ("afl", {}),
    "drfa_fedavg": ("fedavg", dict(drfa=True)),
    "drfa_fedgate": ("fedgate", dict(drfa=True)),
    "drfa_scaffold": ("scaffold", dict(drfa=True)),
}


@pytest.mark.parametrize("num_rounds", [1, 3])
@pytest.mark.parametrize("case", sorted(CASES))
def test_rounds_match_the_jax_package(case, num_rounds):
    algorithm, fed = CASES[case]
    built = _build(algorithm, **fed)
    w0 = _flat(built[1].params)["layer1/kernel"]
    js, jcl, ts, tcl = _run(*built, num_rounds)
    n = _assert_state_close(js, jcl, ts, tcl, built[3].model.module)
    assert n >= 3
    # the server moved
    assert not np.allclose(_flat(js.params)["layer1/kernel"], w0)


@pytest.mark.parametrize("algorithm, fed", [
    ("fedgate", {}), ("scaffold", dict(drfa=True)),
    ("fedavg", dict(drfa=True)), ("qffl", dict(qffl_q=1.0))],
    ids=["fedgate", "drfa_scaffold", "drfa_fedavg", "qffl"])
def test_epoch_sync_with_size_skew_matches(algorithm, fed):
    """Epoch sync over unequal clients: K = 2 batches of the largest
    client; a client of <= 8 samples stops after one step, so FedGATE's
    tracking update divides by its own budget and DRFA's snapshot step
    is clamped into it (the port skips the steps the JAX package masks);
    qFFL's full-data loss takes a last batch that wraps into the
    client's padding rows and masks them out."""
    sizes = (16, 5, 9, 16, 8, 12, 3, 16)
    built = _build(algorithm, sizes=sizes, sync_type="epoch", **fed)
    js, jcl, ts, tcl = _run(*built, 3)
    _assert_state_close(js, jcl, ts, tcl, built[3].model.module)


def _copy_state(js, jcl, ts, tcl, module):
    """The JAX package's server params and every aux tree into the
    port's state (params-shaped and bare tensors alike)."""
    ref = ts.params

    def copy(jnode, tnode):
        if _is_params(tnode, ref):
            jflat = _flat(jnode)
            lead = next(iter(tnode.values())).dim() > \
                next(iter(ref.values())).dim()
            rows = range(C) if lead else [None]
            for c in rows:
                flat = {k: v if c is None else v[c] for k, v in jflat.items()}
                for n, v in params_from_jax(flat, module=module).items():
                    (tnode[n] if c is None else tnode[n][c]).copy_(v)
        elif isinstance(tnode, dict):
            for key in tnode:
                copy(jnode[key], tnode[key])
        elif isinstance(tnode, torch.Tensor):
            src = np.array(jnode)
            tnode.copy_(torch.from_numpy(src[:C] if tnode.dim() else src))

    params = {n: v.clone() for n, v in ts.params.items()}
    copy(js.params, params)
    copy(js.aux, ts.aux)
    copy(jcl.aux, tcl.aux)
    for n, v in tcl.params.items():
        v[:] = params[n]
    return ts._replace(params=params)


@pytest.mark.parametrize("fed", [dict(), dict(drfa=True)],
                         ids=["fedcomgate", "drfa_fedcomgate"])
def test_quantized_fedgate_rounds_match(fed):
    """FedCOMGATE: the uplink and downlink through the quantizer's plain
    version (the ragged pair's twin on the CPU), int8, held per round
    from the JAX package's state: the update as above, and each online
    client's tracking variate, which moves by (delta_i - d) / (lr K),
    within two downlink steps of d over lr K."""
    jtr, js, jcl, ttr, ts, tcl = _build("fedgate", quantized=True, **fed)
    module = ttr.model.module
    lr_k = 0.1 * K

    def tracking(aux):
        return aux["inner"]["delta"] if "inner" in aux else aux["delta"]
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
        jt = _flat(tracking(jcl.aux))
        for k in jp:
            u = jp[k] - jp0[k]
            step = (u.max() - u.min()) / 255.0
            assert np.abs((tp[k] - tp0[k]) - u).max() <= 2 * step + 1e-7, k
            for c in plan.idx.tolist():
                got = params_to_jax({n: v[c] for n, v in
                                     tracking(tcl.aux).items()}, module)[k]
                assert np.abs(got - jt[k][c]).max() \
                    <= (2 * step + 1e-6) / lr_k, (k, c)


def test_drawn_plans_carry_drfa_draws_and_are_seeded():
    """Without an injected plan the port draws DRFA's snapshot step in
    [1, K) and a probe of k clients with B rows inside each one's size
    from the server's generator: the same seed, the same rounds."""
    outs = []
    for _ in range(2):
        _, _, _, ttr, ts, tcl = _build("fedavg", drfa=True)
        plan = ttr.draw_plan(ts)
        assert 1 <= plan.k_rand < max(K, 2)
        assert plan.probe_idx.shape == (2,) and plan.probe_rows.shape == (
            2, B)
        assert int(plan.probe_rows.max()) < N
        ts, tcl, _ = ttr.run_rounds(ts, tcl, 2)
        lam = ts.aux["lambda"]
        assert abs(float(lam.sum()) - 1.0) < 1e-6 and bool((lam >= 0).all())
        outs.append(lam.clone())
    torch.testing.assert_close(outs[0], outs[1], rtol=0, atol=0)


def test_lambda_sampling_draws_the_cohort_from_lambda():
    """``drfa_lambda_sampling``: the Gumbel top-k cohort of k distinct
    clients; a client whose lambda dominates is always drawn."""
    _, _, _, ttr, ts, tcl = _build("fedavg", drfa=True,
                                   drfa_lambda_sampling=True)
    lam = torch.full((C,), 1e-6)
    lam[5] = 1.0
    ts = ts._replace(aux=dict(ts.aux, **{"lambda": lam / lam.sum()}))
    for _ in range(5):
        idx = ttr.draw_plan(ts).idx
        assert len(set(idx.tolist())) == 2 and 5 in idx.tolist()


def test_drfa_over_another_algorithm_raises_the_jax_message():
    cfg = tcfg.ExperimentConfig(federated=tcfg.FederatedConfig(
        federated=True, num_clients=C, algorithm="qffl",
        drfa=True)).finalize()
    with pytest.raises(ValueError, match=r"DRFA wraps one of \('fedavg', "
                       r"'fedgate', 'scaffold'\), got 'qffl'"):
        tmake(cfg)


def test_payload_scale_follows_the_wire_format():
    def scale(algorithm, **fed):
        cfg = tcfg.ExperimentConfig(federated=tcfg.FederatedConfig(
            federated=True, num_clients=C, algorithm=algorithm,
            **fed)).finalize()
        return tmake(cfg).payload_scale()
    assert scale("scaffold") == 2.0
    assert scale("fedgate", compressed=True, compressed_ratio=0.25) == 0.25
    assert scale("fedgate", quantized=True) == 0.25
    assert scale("qsparse", compressed_ratio=0.5) == 0.5
    assert scale("fedgate") == 1.0
