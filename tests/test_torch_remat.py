"""Per-block rematerialization (``cfg.mesh.remat``) in the port, on the
CPU.

Remat recomputes each block in the backward from its input instead of
keeping its activations (``models/common.py`` ``rematerialized``, the
JAX package's per-block ``nn.remat``). It is the same computation, so
the logits and every gradient through ``ModelDef.apply`` (the engine's
``functional_call``) must come out bitwise the same with it as without
it: ResNet-8, ResNet-44 (Bottleneck), the client-fused ResNet-8,
WideResNet-16-2 with dropout 0.3 (a generator-keyed mask source, whose
recompute replays the block's masks from the generator's state at
block entry, and an injected source, whose masks are kept), a
DenseNet-BC with dropout, and the transformer with dense and with flash
attention (the flash ``autograd.Function``'s forward runs again in the
recompute). At one thread and at two, since a recompute that read the
module's own parameters instead of the caller's once gave NaN only at
low thread counts. Then one FedAvg round with and without remat,
bitwise, and the JAX package's "has no effect" warning for the other
architectures.
"""
import warnings

import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401 (two torch threads a worker)
from torch_threads import threads
from fedtorch_tpu import config as jcfg
from fedtorch_tpu.models import define_model as jdefine
from fedtorch_tpu_torch import config as tcfg
from fedtorch_tpu_torch.algorithms import make_algorithm
from fedtorch_tpu_torch.data.batching import stack_partitions
from fedtorch_tpu_torch.models import define_fused_model, define_model
from fedtorch_tpu_torch.models.common import drop_source
from fedtorch_tpu_torch.parallel import FederatedTrainer


def _cfg(mod, remat, arch="resnet8", dataset="cifar10", **model):
    return mod.ExperimentConfig(
        data=mod.DataConfig(dataset=dataset, batch_size=4, augment=False),
        federated=mod.FederatedConfig(federated=True, num_clients=4,
                                      online_client_rate=0.5),
        model=mod.ModelConfig(arch=arch, **model),
        train=mod.TrainConfig(local_step=2),
        mesh=mod.MeshConfig(remat=remat)).finalize()


MODELS = {
    "resnet8": dict(),
    "resnet44": dict(arch="resnet44"),
    "wideresnet16_2_dropout": dict(arch="wideresnet16",
                                   wideresnet_widen_factor=2, drop_rate=0.3),
    "densenet22_bc_dropout": dict(arch="densenet22", densenet_bc_mode=True,
                                  densenet_growth_rate=4,
                                  densenet_compression=0.5, drop_rate=0.3),
    "transformer": dict(arch="transformer", dataset="shakespeare",
                        rnn_hidden_size=16, mlp_num_layers=2,
                        rnn_seq_len=32),
    "transformer_flash": dict(arch="transformer", dataset="shakespeare",
                              rnn_hidden_size=16, mlp_num_layers=2,
                              rnn_seq_len=32, attention="flash"),
}


def _inputs(model):
    gen = torch.Generator().manual_seed(1)
    shape = tuple(model.sample_input.shape)
    if model.sample_input.dtype == torch.int64:
        return torch.randint(0, 86, (3,) + shape[1:], generator=gen)
    return torch.randn((3,) + shape[1:], generator=gen)


def _logits_and_grads(model, params, x, rng):
    leaves = {n: v.detach().requires_grad_(True) for n, v in params.items()}
    out = model.apply(leaves, x, train=True, rng=rng)
    grads = torch.autograd.grad(out.float().square().mean(),
                                list(leaves.values()))
    return out.detach(), grads


def _recorded_source(seed):
    """An injected mask source (not generator-keyed): masks drawn from
    its own generator in call order."""
    gen = torch.Generator().manual_seed(seed)
    return lambda shape, keep: torch.rand(shape, generator=gen) < keep


@pytest.mark.parametrize("nthreads", [1, 2])
@pytest.mark.parametrize("name", sorted(MODELS))
def test_remat_gives_the_same_outputs_and_gradients(name, nthreads):
    kw = MODELS[name]
    plain = define_model(_cfg(tcfg, False, **kw), device="cpu")
    remat = define_model(_cfg(tcfg, True, **kw), device="cpu")
    assert remat.module.remat and not plain.module.remat
    params = plain.init(torch.Generator().manual_seed(0))
    x = _inputs(plain)
    # the dropout paths: a generator-keyed key, then an injected source
    sources = [(7, 7), (_recorded_source(3), _recorded_source(3))] \
        if plain.has_dropout else [(None, None)]
    with threads(nthreads):
        for a, b in sources:
            want_out, want_grads = _logits_and_grads(plain, params, x, a)
            got_out, got_grads = _logits_and_grads(remat, params, x, b)
            assert torch.equal(got_out, want_out)
            for n, g, w in zip(params, got_grads, want_grads):
                assert torch.isfinite(g).all(), n
                assert torch.equal(g, w), n


def test_the_recompute_replays_the_blocks_dropout_masks():
    """A generator source goes on drawing where the forward left it: the
    forward of a second step after a remat step draws the masks it draws
    without remat (the recompute drew from a generator of its own)."""
    kw = MODELS["wideresnet16_2_dropout"]
    plain = define_model(_cfg(tcfg, False, **kw), device="cpu")
    remat = define_model(_cfg(tcfg, True, **kw), device="cpu")
    params = plain.init(torch.Generator().manual_seed(0))
    x = _inputs(plain)
    for model in (plain, remat):
        drop = drop_source(11, "cpu")
        leaves = {n: v.detach().requires_grad_(True)
                  for n, v in params.items()}
        out = torch.func.functional_call(model.module, leaves, (x,),
                                         {"drop": drop})
        torch.autograd.grad(out.square().mean(), list(leaves.values()))
        # the generator's state after the forward and the backward
        after = drop.gen.get_state()
        if model is plain:
            want = after
    assert torch.equal(after, want)


def test_the_fused_resnet_remats_too():
    k = 2
    cfgs = [_cfg(tcfg, r, arch="resnet8") for r in (False, True)]
    fused = [define_fused_model(c, k, device="cpu") for c in cfgs]
    assert fused[1].remat and not fused[0].remat
    one = define_model(cfgs[0], device="cpu")
    stacked = {n: torch.stack([v, 0.5 * v]) for n, v in
               one.init(torch.Generator().manual_seed(0)).items()}
    x = torch.randn(k, 3, 32, 32, 3,
                    generator=torch.Generator().manual_seed(1))
    with threads(1):
        results = []
        for f in fused:
            leaves = {n: v.detach().requires_grad_(True)
                      for n, v in stacked.items()}
            out = torch.func.functional_call(f, leaves, (x,))
            results.append((out, torch.autograd.grad(
                out.square().mean(), list(leaves.values()))))
    (a, ga), (b, gb) = results
    assert torch.equal(a, b)
    assert all(torch.equal(u, v) for u, v in zip(ga, gb))


def test_a_round_with_remat_is_the_round_without():
    rng = np.random.RandomState(0)
    data = stack_partitions(rng.randn(32, 32, 32, 3).astype(np.float32),
                            rng.randint(0, 10, 32),
                            [np.arange(8 * i, 8 * i + 8) for i in range(4)])
    states = []
    for remat in (False, True):
        cfg = _cfg(tcfg, remat)
        t = FederatedTrainer(cfg, define_model(cfg, device="cpu"),
                             make_algorithm(cfg), data, device="cpu")
        server, clients = t.init_state(0)
        server, clients, _ = t.run_rounds(server, clients, 2)
        states.append((server, clients))
    (sa, ca), (sb, cb) = states
    for n in sa.params:
        assert torch.equal(sa.params[n], sb.params[n]), n
        assert torch.equal(ca.opt.in_buf[n], cb.opt.in_buf[n]), n


@pytest.mark.parametrize("arch, dataset", [("mlp", "cifar10"),
                                           ("cnn", "cifar10"),
                                           ("rnn", "shakespeare")])
def test_other_architectures_warn_as_the_jax_package_does(arch, dataset):
    with warnings.catch_warnings(record=True) as want:
        warnings.simplefilter("always")
        jdefine(_cfg(jcfg, True, arch=arch, dataset=dataset))
    with warnings.catch_warnings(record=True) as got:
        warnings.simplefilter("always")
        define_model(_cfg(tcfg, True, arch=arch, dataset=dataset),
                     device="cpu")
    text = [str(w.message) for w in want if "--remat" in str(w.message)]
    assert text and [str(w.message) for w in got
                     if "--remat" in str(w.message)] == text
