"""Client fusion in the port (``client_fusion='fused'``) against the JAX
package's, on the CPU.

* **Layers**: ``FusedConv``, ``FusedDense``, ``FusedBatchStatsNorm``,
  ``fused_max_pool`` and ``pack_clients`` against the JAX package's fused
  layers; ``FusedResNetCifar`` at depths 8 and 44 (Bottleneck) and
  ``FusedCNN`` against the JAX fused modules, on the JAX weights bridged
  per client with ``params_from_jax`` and stacked; forwards within 1e-5
  of the output's largest |value| in float32 (the models measured from
  the JAX module in float64, where ResNet-44's float32 reference is
  itself 2.0e-5 off). Param names and shapes are the stacked per-client
  tree's.
* **The gate**: every refusal of ``fusion_supported`` and
  ``resolve_client_fusion`` word for word the JAX package's, the
  builders' None where no fused form exists, 'auto' to 'vmap', and the
  commit dispatch refusing the fused execution.
* **Rounds**: one fused round, and then three, through
  ``FederatedTrainer`` against the JAX package's fused round (the same
  weights, the JAX round's cohort, rows and fault uniforms replayed into
  the port's plan) and against the port's own per-client ('vmap')
  round: unquantized, every state tree within 1e-5 of its largest
  |value| (``test_torch_zoo.py``'s bar), the counters, epochs and local
  indices equal; int8, each round from the JAX state, the server update
  within 1e-3 relative L2 and two downlink steps (``test_torch_round.py``'s
  bars). Cases: FedAvg (ResNet-8), FedProx, SCAFFOLD under epoch sync
  with frozen clients, FedAvg with chaos and the guards, bf16 (the cnn).
  bf16 rounds to bfloat16 at each package's own points, so its JAX bar is
  twice the gap between the two packages' per-client ('vmap') rounds on
  the same inputs, measured in the test.

Sizes are small: 8 clients, k = 2 or 4, batch 8, 2 local steps.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401 (two torch threads a worker)
from fedtorch_tpu import config as jcfg
from fedtorch_tpu.algorithms import make_algorithm as jmake
from fedtorch_tpu.data.batching import stack_partitions as jstack
from fedtorch_tpu.models import common as jcommon
from fedtorch_tpu.models import define_fused_model as jdefine_fused
from fedtorch_tpu.models import define_model as jdefine
from fedtorch_tpu.models import resnet as jresnet
from fedtorch_tpu.parallel import FederatedTrainer as JTrainer
from fedtorch_tpu.parallel import fusion as jfusion
from fedtorch_tpu_torch import config as tcfg
from fedtorch_tpu_torch.algorithms import make_algorithm as tmake
from fedtorch_tpu_torch.bridge import params_from_jax, params_to_jax
from fedtorch_tpu_torch.core.state import tree_stack
from fedtorch_tpu_torch.data.batching import stack_partitions as tstack
from fedtorch_tpu_torch.models import common as tcommon
from fedtorch_tpu_torch.models import define_fused_model as tdefine_fused
from fedtorch_tpu_torch.models import define_model as tdefine
from fedtorch_tpu_torch.models import resnet as tresnet
from fedtorch_tpu_torch.parallel import FederatedTrainer
from fedtorch_tpu_torch.parallel import fusion as tfusion
from fedtorch_tpu_torch.tools.order_spread import SPREAD_FACTOR
from test_torch_chaos import COUNTERS, _fault_plans, _strip
from test_torch_round import _copy_state
from test_torch_zoo import _flat, _groups, _is_params

C, N, B, K = 8, 16, 8, 2
BAR = 1e-5


def _cfg(mod, fusion="fused", arch="cnn", dataset="cifar10", norm="bn",
         dtype="float32", fault=None, optim=None, **fed):
    """Both packages' config: ``fed`` overrides the federated fields
    (k = 2 of 8 clients, local-step sync, FedAvg), ``optim`` the
    optimizer's (momentum SGD at lr 0.05)."""
    fed = dict(dict(federated=True, num_clients=C, online_client_rate=0.25,
                    algorithm="fedavg", sync_type="local_step",
                    num_epochs_per_comm=1), **fed)
    return mod.ExperimentConfig(
        data=mod.DataConfig(dataset=dataset, batch_size=B, augment=False),
        federated=mod.FederatedConfig(**fed),
        model=mod.ModelConfig(arch=arch, conv_impl="conv", norm=norm,
                              mlp_hidden_size=16),
        optim=mod.OptimConfig(**dict(dict(lr=0.1, in_momentum=True),
                                     **(optim or {}))),
        train=mod.TrainConfig(local_step=K),
        mesh=mod.MeshConfig(client_fusion=fusion, compute_dtype=dtype,
                            num_devices=1),
        fault=mod.FaultConfig(**(fault or {}))).finalize()


def _rel(got, want) -> float:
    return float(np.abs(np.asarray(got, np.float64) - want).max()
                 / max(np.abs(want).max(), 1e-30))


def _stack_bridged(jstacked, module, k):
    """A JAX stacked [k] params tree in the port's names and layouts:
    each client bridged with ``params_from_jax``, then stacked."""
    rows = [params_from_jax(_flat(jax.tree.map(lambda v: v[i], jstacked)),
                            module=module) for i in range(k)]
    return tree_stack(rows)


# -- the layers ---------------------------------------------------------------

def test_fused_layers_match_the_jax_fused_layers():
    """Each layer on the same inputs and stacked weights: the port's
    OIHW and (out, in) layouts are the JAX HWIO and (in, out) ones
    transposed per client."""
    rng = np.random.RandomState(0)
    k, b, h, cin, cout = 3, 2, 9, 4, 5
    x5 = rng.randn(k, b, h, h, cin).astype(np.float32)
    jx = jcommon.pack_clients(x5)  # [B, H, W, k, C]
    tx = tcommon.pack_clients(torch.from_numpy(x5))  # [B, k*C, H, W]
    np.testing.assert_array_equal(
        tx.permute(0, 2, 3, 1).reshape(jx.shape).numpy(), np.asarray(jx))

    def nhwkc(t):  # the port's packed NCHW view as the JAX layout
        return t.permute(0, 2, 3, 1).reshape(
            t.shape[0], t.shape[2], t.shape[3], k, -1).detach().numpy()

    for ks, stride, pad, bias in ((3, 1, 1, False), (3, 2, 1, False),
                                  (1, 2, 0, False), (5, 1, 0, True)):
        jconv = jcommon.FusedConv(cout, (ks, ks), num_clients=k,
                                  strides=(stride, stride), padding=pad,
                                  use_bias=bias)
        jp = jconv.init(jax.random.key(ks + stride), jx)["params"]
        if bias:
            jp = dict(jp, bias=jax.random.normal(jax.random.key(9), (k, cout)))
        want = np.asarray(jconv.apply({"params": jp}, jx))
        tconv = tcommon.FusedConv(k, cin, cout, ks, stride, pad, bias=bias)
        params = {"weight": torch.from_numpy(np.asarray(
            jp["kernel"]).transpose(0, 4, 3, 1, 2).copy())}
        if bias:
            params["bias"] = torch.from_numpy(np.array(jp["bias"]))
        got = nhwkc(torch.func.functional_call(tconv, params, (tx,)))
        assert _rel(got, want) <= BAR, (ks, stride, pad, bias)

    jnorm = jcommon.FusedBatchStatsNorm(num_clients=k)
    jp = {"scale": jax.random.normal(jax.random.key(1), (k, cin)),
          "bias": jax.random.normal(jax.random.key(2), (k, cin))}
    want = np.asarray(jnorm.apply({"params": jp}, jx))
    tnorm = tcommon.fused_norm("bn", k, cin)
    got = nhwkc(torch.func.functional_call(tnorm, {
        "weight": torch.from_numpy(np.array(jp["scale"])),
        "bias": torch.from_numpy(np.array(jp["bias"]))}, (tx,)))
    assert _rel(got, want) <= BAR

    want = np.asarray(jcommon.fused_max_pool(jx, (2, 2), (2, 2)))
    assert _rel(nhwkc(tcommon.fused_max_pool(tx, 2, 2)), want) == 0.0

    xd = rng.randn(b, k, cin).astype(np.float32)
    for dtype in (None, "bfloat16"):
        jdense = jcommon.FusedDense(cout, num_clients=k, dtype=dtype)
        jp = jdense.init(jax.random.key(3), xd)["params"]
        jp = dict(jp, bias=jax.random.normal(jax.random.key(4), (k, cout)))
        want = np.asarray(jdense.apply({"params": jp}, xd), np.float32)
        tdense = tcommon.FusedDense(
            k, cin, cout,
            dtype=torch.float32 if dtype is None else torch.bfloat16)
        got = torch.func.functional_call(tdense, {
            "weight": torch.from_numpy(np.asarray(
                jp["kernel"]).transpose(0, 2, 1).copy()),
            "bias": torch.from_numpy(np.array(jp["bias"]))},
            (torch.from_numpy(xd),)).float().numpy()
        # bf16: one bfloat16 spacing of the output's scale
        assert _rel(got, want) <= (BAR if dtype is None else 2.0 ** -8)


def test_fused_norm_refuses_other_norms_with_the_jax_text():
    with pytest.raises(ValueError) as want:
        jcommon.fused_norm_f32("gn", np.zeros((1, 2, 2)), "float32", 2,
                               name="x")
    with pytest.raises(ValueError) as got:
        tcommon.fused_norm("gn", 2, 2)
    assert str(got.value) == str(want.value)


def _jax_float64(module, jp, x):
    """The JAX fused module's logits with every layer in float64 (x64 on,
    the module cloned at ``dtype='float64'``, ``jnp.float32`` read as
    float64 for its norms' and head's casts), as
    ``test_torch_models_zoo.py`` evaluates the JAX package."""
    with jax.enable_x64(True), pytest.MonkeyPatch.context() as patch:
        patch.setattr(jnp, "float32", jnp.float64)
        out = jax.jit(module.clone(dtype="float64").apply)(
            {"params": jax.tree.map(lambda v: jnp.asarray(v, jnp.float64),
                                    jp)}, jnp.asarray(x, jnp.float64))
        assert out.dtype == jnp.float64
        return np.asarray(out)


@pytest.mark.parametrize("arch", ["resnet8", "resnet44", "cnn"])
def test_fused_models_match_the_jax_fused_modules(arch):
    """The port's fused module on the JAX fused module's weights (bridged
    per client and stacked), its params the stacked per-client tree. The
    logits within 1e-5 of their largest |value| of the JAX module's float32
    logits, measured from the JAX module in float64: the port may be as
    far from it as the JAX package's own float32 logits are (ResNet-44's
    43 convolutions and norms at batch 3 put them 2.0e-5 from it), never
    held looser than 1e-5."""
    k, b = 2, 3
    jc, tc = _cfg(jcfg, arch=arch), _cfg(tcfg, arch=arch)
    jfused = jdefine_fused(jc, k)
    x = np.random.RandomState(1).randn(k, b, 32, 32, 3).astype(np.float32)
    jp = jax.jit(jfused.init)(jax.random.key(0), x)["params"]
    want = np.asarray(jax.jit(jfused.apply)({"params": jp}, x))
    truth = _jax_float64(jfused, jp, x)
    model = tdefine(tc, device="cpu")
    fused = tdefine_fused(tc, k, device="cpu")
    stacked = _stack_bridged(jp, model.module, k)
    per_client = model.init(torch.Generator().manual_seed(0))
    assert {n: tuple(v.shape) for n, v in fused.named_parameters()} == \
        {n: (k,) + tuple(v.shape) for n, v in per_client.items()}
    assert list(dict(fused.named_parameters())) == list(per_client)
    got = torch.func.functional_call(fused, stacked,
                                     (torch.from_numpy(x),))
    assert got.shape == (k, b, 10)
    assert _rel(got.detach().numpy(), truth) <= max(BAR, _rel(want, truth))
    # and the port's fused module is its per-client module, client by
    # client
    per = torch.stack([model.apply({n: v[i] for n, v in stacked.items()},
                                   torch.from_numpy(x[i]))
                       for i in range(k)])
    assert _rel(got.detach().numpy(), per.detach().numpy()) <= BAR


def test_builders_return_none_where_the_jax_package_has_no_fused_form():
    for dataset, norm in (("cifar10", "gn"), ("imagenet", "bn"),
                          ("stl10", "gn")):
        assert jresnet.build_fused_resnet("resnet20", dataset, 4,
                                          norm) is None
        assert tresnet.build_fused_resnet("resnet20", dataset, 4,
                                          norm) is None
    assert isinstance(tresnet.build_fused_resnet("resnet20", "stl10", 4),
                      tresnet.FusedResNetCifar)
    for arch in ("mlp", "logistic_regression"):
        jc, tc = _cfg(jcfg, arch=arch), _cfg(tcfg, arch=arch)
        assert jdefine_fused(jc, 2) is None
        assert tdefine_fused(tc, 2, device="cpu") is None


# -- the gate -----------------------------------------------------------------

GATE_CASES = {
    "apfl": dict(algorithm="apfl"),
    "perfedavg": dict(algorithm="perfedavg"),
    "perfedme": dict(algorithm="perfedme"),
    "drfa": dict(algorithm="fedavg", drfa=True),
    "qffl": dict(algorithm="qffl", qffl_q=1.0),
    "rnn": dict(arch="rnn", dataset="shakespeare"),
    "robust_mlp": dict(arch="robust_mlp", dataset="synthetic"),
    "least_square": dict(arch="least_square", dataset="synthetic"),
    "mlp": dict(arch="mlp", dataset="synthetic"),
    "resnet8_gn": dict(arch="resnet8", norm="gn"),
    "transformer": dict(arch="transformer", dataset="shakespeare"),
}


@pytest.mark.parametrize("case", sorted(GATE_CASES))
def test_gate_refuses_with_the_jax_reason(case):
    jc, tc = _cfg(jcfg, **GATE_CASES[case]), _cfg(tcfg, **GATE_CASES[case])
    jmodel = jdefine(jc, batch_size=B)
    tmodel = tdefine(tc, batch_size=B, device="cpu")
    jalg, talg = jmake(jc), tmake(tc)
    want = jfusion.fusion_supported(jc, jmodel, jalg, 1, 2)
    got = tfusion.fusion_supported(tc, tmodel, talg, 1, 2)
    assert want[0] is None and got == (None, want[1])
    with pytest.raises(ValueError) as jerr:
        jfusion.resolve_client_fusion(jc, jmodel, jalg, 1, 2)
    with pytest.raises(ValueError) as terr:
        tfusion.resolve_client_fusion(tc, tmodel, talg, 1, 2)
    assert str(terr.value) == str(jerr.value)
    for mode in ("auto", "vmap"):
        tv = _cfg(tcfg, fusion=mode, **GATE_CASES[case])
        assert tfusion.resolve_client_fusion(tv, tmodel, talg, 1, 2) == \
            ("vmap", None)


def test_moe_aux_loss_refusal_is_the_jax_text():
    """An MoE transformer from ``define_model`` reaches the gate's
    aux-loss reason, and ``'fused'`` on it is refused with the JAX
    text."""
    def cfg(mod):
        return mod.ExperimentConfig(
            data=mod.DataConfig(dataset="shakespeare"),
            model=mod.ModelConfig(arch="transformer", moe_experts=2),
            mesh=mod.MeshConfig(client_fusion="fused")).finalize()
    jc, tc = cfg(jcfg), cfg(tcfg)
    jmodel, tmodel = jdefine(jc), tdefine(tc, device="cpu")
    assert tmodel.has_aux_loss
    want = jfusion.fusion_supported(jc, jmodel, jmake(jc), 1, 2)
    assert tfusion.fusion_supported(tc, tmodel, tmake(tc), 1, 2) == \
        (None, want[1])
    with pytest.raises(ValueError) as jerr:
        jfusion.resolve_client_fusion(jc, jmodel, jmake(jc), 1, 2)
    with pytest.raises(ValueError) as terr:
        tfusion.resolve_client_fusion(tc, tmodel, tmake(tc), 1, 2)
    assert str(terr.value) == str(jerr.value)


def test_supported_configurations_resolve_to_fused_and_auto_to_vmap():
    for arch in ("cnn", "resnet8"):
        for alg in ("fedavg", "fedprox", "fedadam", "scaffold", "fedgate",
                    "qsparse", "afl"):
            tc = _cfg(tcfg, arch=arch, algorithm=alg)
            mode, module = tfusion.resolve_client_fusion(
                tc, tdefine(tc, device="cpu"), tmake(tc), 1, 2)
            assert mode == "fused" and module is not None, (arch, alg)
    tc = _cfg(tcfg, fusion="auto")
    t = FederatedTrainer(tc, tdefine(tc, device="cpu"), tmake(tc),
                         tstack(*_data()), device="cpu")
    assert (t.client_fusion, t.fused_module) == ("vmap", None)


def _data(sizes=(N,) * C, seed=0):
    rng = np.random.RandomState(seed)
    feats = rng.randn(sum(sizes), 32, 32, 3).astype(np.float32)
    labels = rng.randint(0, 10, sum(sizes))
    ends = np.cumsum(sizes)
    return feats, labels, [np.arange(e - s, e) for s, e in zip(sizes, ends)]


def test_trainers_refuse_as_the_jax_trainers_do():
    """An unsupported fused configuration at construction, and the
    commit dispatch, which trains each client against its own snapshot,
    against the fused execution."""
    from fedtorch_tpu.async_plane import (
        AsyncFederatedTrainer as JAsync,
    )
    from fedtorch_tpu_torch.async_plane import AsyncFederatedTrainer
    feats, labels, parts = _data()
    for kw, jcls, tcls in (
            (dict(arch="mlp"), JTrainer, FederatedTrainer),
            (dict(algorithm="qffl", qffl_q=1.0), JTrainer, FederatedTrainer),
            (dict(sync_mode="async"), JAsync, AsyncFederatedTrainer)):
        jc, tc = _cfg(jcfg, **kw), _cfg(tcfg, **kw)
        with pytest.raises(ValueError) as jerr:
            jcls(jc, jdefine(jc, batch_size=B), jmake(jc),
                 jstack(feats, labels, parts))
        with pytest.raises(ValueError) as terr:
            tcls(tc, tdefine(tc, batch_size=B, device="cpu"), tmake(tc),
                 tstack(feats, labels, parts), device="cpu")
        assert str(terr.value) == str(jerr.value), kw


# -- rounds -------------------------------------------------------------------

def _build(sizes=(N,) * C, spread=False, **kw):
    """The trainers of one population: the JAX package's fused trainer,
    the port's fused and per-client ones, the port's states on the JAX
    weights, and with ``spread`` the JAX package's per-client ('vmap',
    on the same native convolution) trainer. Returns ``{execution:
    (jax, port)}`` of (trainer, server, clients), the JAX vmap entry
    ``None`` without ``spread``."""
    feats, labels, parts = _data(sizes)
    out = {}
    for fusion in ("fused", "vmap"):
        jc, tc = (_cfg(mod, fusion=fusion, **kw) for mod in (jcfg, tcfg))
        if fusion == "fused" or spread:
            # the fused and vmap JAX trainers init the same weights
            jtr = JTrainer(jc, jdefine(jc, batch_size=B), jmake(jc),
                           jstack(feats, labels, parts))
            assert jtr.client_fusion == fusion
            js, jcl = jtr.init_state(jax.random.key(0))
        ttr = FederatedTrainer(tc, tdefine(tc, batch_size=B, device="cpu"),
                               tmake(tc), tstack(feats, labels, parts),
                               device="cpu")
        assert ttr.client_fusion == fusion
        ts, tcl = ttr.init_state(0)
        params = params_from_jax(_flat(js.params), expect=ts.params,
                                 module=ttr.model.module)
        for n, p in tcl.params.items():
            p[:] = params[n]
        out[fusion] = [[jtr, js, jcl] if fusion == "fused" or spread
                       else None, [ttr, ts._replace(params=params), tcl]]
    return out


def _gaps(js, jcl, ts, tcl, module) -> dict:
    """Each state group's largest gap (server params, server aux, each
    client's aux; ``test_torch_zoo.py``'s groups) over the group's
    largest |value|, the JAX state against the port's."""
    out = {}
    for name, jt, tt in (("params", js.params, ts.params),
                         ("server", js.aux, ts.aux),
                         ("clients", jcl.aux, tcl.aux)):
        for where, leaves in _groups(jt, tt, ts.params, module, name):
            scale = max(float(np.abs(w).max()) for _, w, _ in leaves)
            out[where] = max(float(np.abs(g.astype(np.float64) - w).max())
                             for _, w, g in leaves) / max(scale, 1e-30)
    return out


def _port_gaps(a, acl, b, bcl) -> dict:
    """:func:`_gaps` between two port states (``a``/``acl`` the
    reference), in the same groups."""
    out = {}

    def walk(x, y, where):
        if _is_params(y, b.params):
            lead = next(iter(y.values())).dim() > \
                next(iter(b.params.values())).dim()
            for c in range(C) if lead else [None]:
                pairs = [(u if c is None else u[c], v if c is None else v[c])
                         for u, v in zip(x.values(), y.values())]
                scale = max(float(u.abs().max()) for u, _ in pairs)
                out[where if c is None else f"{where}[{c}]"] = max(
                    float((u - v).abs().max()) for u, v in pairs) \
                    / max(scale, 1e-30)
        elif isinstance(y, dict):
            for key in y:
                walk(x[key], y[key], f"{where}/{key}")
        elif isinstance(y, torch.Tensor):
            out[where] = float((x - y).abs().max()) / max(
                float(x.abs().max()), 1e-30)

    for name, x, y in (("params", a.params, b.params),
                       ("server", a.aux, b.aux),
                       ("clients", acl.aux, bcl.aux)):
        walk(x, y, name)
    return out


def _assert_within_spread(got: dict, spread: dict, bar: float):
    """Every group of ``got`` within the larger of ``bar`` and
    ``SPREAD_FACTOR`` times the same group's gap between the two
    packages' per-client rounds (``spread``)."""
    for where, gap in got.items():
        assert gap <= max(bar, SPREAD_FACTOR * spread.get(where, 0.0)), \
            (where, gap, spread.get(where))


ROUND_CASES = {
    "fedavg": {},
    "fedprox": dict(algorithm="fedprox"),
    # unequal sizes: K = 3 batches of the largest client; the clients of
    # at most 8 samples freeze after their one batch, of 9-16 after two
    "scaffold_epoch_freeze": dict(
        algorithm="scaffold", sync_type="epoch",
        optim=dict(in_momentum=False), online_client_rate=0.5,
        sizes=(24, 5, 9, 16, 8, 12, 3, 24), spread=True),
    "fedavg_chaos_guards": dict(
        online_client_rate=0.5,
        fault=dict(client_drop_rate=0.5, straggler_rate=0.5,
                   nan_inject_rate=0.5, guard_updates=True)),
    # bfloat16 rounds at each package's own points: held to the spread
    "fedavg_bf16": dict(dtype="bfloat16", spread=True),
}


@pytest.mark.parametrize("case", sorted(ROUND_CASES))
def test_fused_rounds_match_the_jax_fused_round_and_the_vmap_round(case):
    """Three rounds from the same weights and the JAX round's plans, held
    after the first and after the third: the port's fused state against
    the JAX fused round's and against the port's per-client round's,
    each group within 1e-5 of its largest |value|; in bf16, where each
    package rounds at its own points, within ``SPREAD_FACTOR`` times the
    largest gap so far between the two packages' per-client rounds
    where that is larger. The counters, the online mask, epochs and
    local indices equal, the per-client losses and accuracies within
    1e-4 of their largest value (or the same spread rule)."""
    built = _build(**ROUND_CASES[case])
    (jtr, js, jcl), (ttr, ts, tcl) = built["fused"]
    jv, (vtr, vs, vcl) = built["vmap"]
    module, fired = ttr.model.module, 0.0
    # the largest per-client gaps so far (a round in which the two
    # per-client rounds happen to land close sets no bar)
    spread, lspread = {}, {}
    for r, plan in enumerate(_fault_plans(jtr, js, 3, ttr)):
        js, jcl, jm = jtr.run_round(js, jcl)
        if jv is not None:
            jvtr, jvs, jvcl = jv
            jvs, jvcl, jvm = jvtr.run_round(jvs, jvcl)
            jv = jvtr, jvs, jvcl
        ts, tcl, tm = ttr.round_fn(ts, tcl, plan)
        vs, vcl, vm = vtr.round_fn(vs, vcl, plan)
        for f in COUNTERS:
            assert float(getattr(tm, f)) == float(getattr(jm, f)) \
                == float(getattr(vm, f)), f
        for m in (jm, vm):
            np.testing.assert_array_equal(tm.online_mask.numpy(),
                                          np.asarray(m.online_mask))
        np.testing.assert_allclose(float(tm.comm_bytes),
                                   float(jm.comm_bytes), rtol=1e-6)
        for f in ("train_loss", "train_acc"):
            got, jwant, vwant = (np.asarray(getattr(m, f))
                                 for m in (tm, jm, vm))
            if jv is not None:
                lspread[f] = max(lspread.get(f, 0.0), float(np.abs(
                    vwant - np.asarray(getattr(jvm, f))).max()))
            for want in (jwant, vwant):
                assert np.abs(got - want).max() <= max(
                    1e-4 * np.abs(want).max() + 1e-6,
                    SPREAD_FACTOR * lspread.get(f, 0.0)), f
        n = tcl.local_index.shape[0]
        np.testing.assert_array_equal(tcl.local_index.numpy(),
                                      np.asarray(jcl.local_index)[:n])
        np.testing.assert_allclose(tcl.epoch.numpy(),
                                   np.asarray(jcl.epoch)[:n], rtol=1e-6)
        assert torch.equal(tcl.local_index, vcl.local_index)
        assert torch.equal(tcl.epoch, vcl.epoch)
        fired += float(tm.dropped_clients + tm.straggler_clients
                       + tm.rejected_updates)
        if jv is not None:
            for where, gap in _gaps(jvs, jvcl, _strip(vs, jvs), vcl,
                                    module).items():
                spread[where] = max(spread.get(where, 0.0), gap)
        if r in (0, 2):
            _assert_within_spread(
                _gaps(js, jcl, _strip(ts, js), tcl, module), spread, BAR)
            _assert_within_spread(_port_gaps(vs, vcl, ts, tcl), spread,
                                  BAR)
    if case == "fedavg_chaos_guards":
        assert fired > 0  # the fault planes fired
    if case == "scaffold_epoch_freeze":
        # clients froze before the scan's end
        assert len(set(tcl.local_index.tolist()) - {0}) > 1


def test_quantized_resnet20_rounds_restart_from_the_jax_state():
    """int8 both ways on ResNet-20, each round from the JAX state (both
    executions): the fused server update within 1e-3 relative L2 and two
    downlink steps of the JAX fused update, or ``SPREAD_FACTOR`` times
    the per-client rounds' gaps where native-conv order alone flips more
    int8 values; the losses within 1e-3."""
    built = _build(arch="resnet20", quantized=True, spread=True)
    (jtr, js, jcl), (ttr, ts, tcl) = built["fused"]
    (jvtr, jvs, jvcl), (vtr, vs, vcl) = built["vmap"]
    module = ttr.model.module

    def update(j0, j1, t0, t1):
        ju = np.concatenate([(j1[n] - j0[n]).ravel() for n in j0])
        tu = np.concatenate([(t1[n] - t0[n]).ravel() for n in j0])
        steps = max(np.abs((t1[n] - t0[n]) - (j1[n] - j0[n])).max()
                    / max((j1[n] - j0[n]).max() - (j1[n] - j0[n]).min(),
                          1e-30) * 255.0 for n in j0)
        return np.linalg.norm(tu - ju) / np.linalg.norm(ju), steps

    for r, plan in enumerate(_fault_plans(jtr, js, 3, ttr)):
        if r:
            ts = _copy_state(js, jcl, ts, tcl, module)
            vs = _copy_state(jvs, jvcl, vs, vcl, module)
        before = [_flat(js.params), params_to_jax(ts.params, module),
                  _flat(jvs.params), params_to_jax(vs.params, module)]
        js, jcl, jm = jtr.run_round(js, jcl)
        jvs, jvcl, _ = jvtr.run_round(jvs, jvcl)
        ts, tcl, tm = ttr.round_fn(ts, tcl, plan)
        vs, vcl, _ = vtr.round_fn(vs, vcl, plan)
        after = [_flat(js.params), params_to_jax(ts.params, module),
                 _flat(jvs.params), params_to_jax(vs.params, module)]
        rel, steps = update(before[0], after[0], before[1], after[1])
        vrel, vsteps = update(before[2], after[2], before[3], after[3])
        assert rel <= max(1e-3, SPREAD_FACTOR * vrel), (r, rel, vrel)
        assert steps <= max(2.0, SPREAD_FACTOR * vsteps) + 1e-3, \
            (r, steps, vsteps)
        np.testing.assert_allclose(tm.train_loss.numpy(),
                                   np.asarray(jm.train_loss), rtol=1e-3,
                                   atol=1e-5)
