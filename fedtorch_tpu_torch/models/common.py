"""Shared model pieces: dataset dims, layers, the model definition API.

Port of ``fedtorch_tpu/models/common.py``. Module and parameter names
mirror the JAX package's flax auto-names (``Conv_0``,
``BatchStatsNorm_1``, ``Dense_0``), so a flax path maps onto a
``state_dict`` key by joining with '.' and renaming the leaf
(``bridge.py``). Layouts follow PyTorch: conv weights OIHW, dense
weights ``(out, in)``; activations run NCHW inside the models, while the
public ``forward`` takes the JAX package's NHWC batches.
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint

# flax's lecun_normal draws a standard normal truncated to [-2, 2] and
# rescales by this constant, the std of that truncated normal
_TRUNC_STD = 0.87962566103423978


# (num_features, num_classes) for convex models
# (ref: logistic_regression.py:34-72).
CONVEX_DIMS = {
    "epsilon": (2000, 2),
    "url": (3231961, 2),
    "rcv1": (47236, 2),
    "higgs": (28, 2),
    "mnist": (784, 10),
    "emnist": (784, 10),
    "emnist_full": (784, 62),
    "cifar10": (3072, 10),
    "cifar100": (3072, 100),
    "fashion_mnist": (784, 10),
    "synthetic": (60, 10),
    "adult": (14, 2),
}

# regression dims (ref: least_square.py:27-41); num_classes == 1.
REGRESSION_DIMS = {
    "epsilon": 2000,
    "url": 3231961,
    "rcv1": 47236,
    "MSD": 90,
    "synthetic": 60,
}


def num_classes_of(dataset: str) -> int:
    """ref: mlp.py:33-41 / cnn.py:31-37 / resnet.py ResNetBase."""
    table = {
        "cifar10": 10, "mnist": 10, "fashion_mnist": 10, "emnist": 10,
        "stl10": 10, "cifar100": 100, "emnist_full": 62, "adult": 2,
        "synthetic": 10, "higgs": 2, "epsilon": 2, "rcv1": 2,
        "shakespeare": 86, "imagenet": 1000,
    }
    if dataset not in table:
        raise ValueError(f"No class count known for dataset {dataset!r}")
    return table[dataset]


def flat_input_size(dataset: str) -> int:
    """ref: mlp.py:43-48."""
    if "cifar" in dataset or dataset == "stl10":
        return 32 * 32 * 3 if "cifar" in dataset else 96 * 96 * 3
    if "mnist" in dataset:
        return 28 * 28
    if dataset == "adult":
        return 14
    if dataset == "synthetic":
        return 60
    if dataset == "higgs":
        return 28
    if dataset == "epsilon":
        return 2000
    if dataset == "rcv1":
        return 47236
    raise NotImplementedError(f"No flat input size for {dataset!r}")


def image_shape(dataset: str):
    """NHWC sample shape for conv models."""
    if "cifar" in dataset:
        return (32, 32, 3)
    if "mnist" in dataset:
        return (28, 28, 1)
    if dataset == "stl10":
        return (96, 96, 3)
    raise NotImplementedError(f"No image shape for {dataset!r}")


def lecun_normal(shape, fan_in: int,
                 generator: torch.Generator) -> torch.Tensor:
    """flax's default kernel init: truncated normal, variance 1/fan_in
    (drawn on the CPU)."""
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    return nn.init.trunc_normal_(torch.empty(shape), std=std,
                                 a=-2.0 * std, b=2.0 * std,
                                 generator=generator)


def orthogonal(shape, generator: torch.Generator) -> torch.Tensor:
    """flax's ``initializers.orthogonal()`` law: the Q of a standard
    normal matrix's QR, its columns' signs fixed by R's diagonal (drawn
    on the CPU)."""
    rows, cols = shape
    a = torch.randn(max(rows, cols), min(rows, cols), generator=generator)
    q, r = torch.linalg.qr(a)
    q = q * torch.sign(torch.diagonal(r))
    return (q if rows >= cols else q.T).contiguous()


class Conv(nn.Module):
    """2-D convolution computed in ``dtype`` (the compute dtype: params
    stay float32, input, weight and bias are cast per call, as flax's
    ``nn.Conv(dtype=...)`` does). NCHW in and out; ``padding`` is the
    explicit symmetric pad (flax's 'SAME' for the 1x1 shortcut is 0).
    Bias-free unless ``bias`` (the LeNet ``cnn``'s convs), the bias
    starting at 0."""

    def __init__(self, cin: int, cout: int, kernel_size: int,
                 stride: int = 1, padding: int = 0,
                 dtype: torch.dtype = torch.float32, bias: bool = False):
        super().__init__()
        self.weight = nn.Parameter(
            torch.empty(cout, cin, kernel_size, kernel_size))
        if bias:
            self.bias = nn.Parameter(torch.empty(cout))
        else:
            self.register_parameter("bias", None)
        self.stride, self.padding, self.dtype = stride, padding, dtype

    def init_params(self, generator: torch.Generator) -> dict:
        cout, cin, kh, kw = self.weight.shape
        out = {"weight": lecun_normal(self.weight.shape, cin * kh * kw,
                                      generator)}
        if self.bias is not None:
            out["bias"] = torch.zeros(self.bias.shape)
        return out

    def forward(self, x):
        bias = None if self.bias is None else self.bias.to(self.dtype)
        return F.conv2d(x.to(self.dtype), self.weight.to(self.dtype), bias,
                        stride=self.stride, padding=self.padding)


class MatmulConv(Conv):
    """The im2col convolution (``conv_impl='matmul'``): the input's
    patches (``F.unfold``, features in (cin, kh, kw) order, as
    ``lax.conv_general_dilated_patches`` orders them) times the weight
    as one ``[B, P, cin*kh*kw] x [cin*kh*kw, cout]`` matmul, in
    ``dtype``. Same parameters and initializer as :class:`Conv`, so a
    params dict loads under either. The output is the NCHW view of
    ``[B, H, W, cout]`` memory, as the native conv gives it. The JAX
    package's ``MatmulConv`` is XLA code, not Pallas, so it stays torch
    ops here."""

    def forward(self, x):
        cout, cin, kh, kw = self.weight.shape
        B, _, H, W = x.shape
        ho = (H + 2 * self.padding - kh) // self.stride + 1
        wo = (W + 2 * self.padding - kw) // self.stride + 1
        patches = F.unfold(x.to(self.dtype), (kh, kw), padding=self.padding,
                           stride=self.stride)  # [B, cin*kh*kw, P]
        w = self.weight.to(self.dtype).reshape(cout, cin * kh * kw)
        y = torch.matmul(patches.transpose(1, 2), w.t())  # [B, P, cout]
        if self.bias is not None:
            y = y + self.bias.to(self.dtype)
        return y.reshape(B, ho, wo, cout).permute(0, 3, 1, 2)


def conv_of(impl: str):
    """The conv layer of a ``conv_impl``: 'conv' (the native conv) or
    'matmul' (:class:`MatmulConv`); both build the same params."""
    if impl == "conv":
        return Conv
    if impl == "matmul":
        return MatmulConv
    raise ValueError(f"unknown conv_impl {impl!r} "
                     "(expected 'conv' or 'matmul')")


class Dense(nn.Module):
    """Affine layer ``x W^T + b`` computed in ``dtype`` (flax's
    ``nn.Dense(dtype=...)``: params stay float32, input, weight and bias
    are cast per call); float32 by default, as the classifier heads run.
    ``bias=False`` drops the bias; ``kernel_init`` is flax's initializer
    of the weight: ``'lecun_normal'`` (flax's default), ``'zeros'`` or
    ``'orthogonal'`` (a GRU cell's hidden-to-hidden kernels)."""

    def __init__(self, cin: int, cout: int, bias: bool = True,
                 dtype: torch.dtype = torch.float32,
                 kernel_init: str = "lecun_normal"):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin))
        if bias:
            self.bias = nn.Parameter(torch.empty(cout))
        else:
            self.register_parameter("bias", None)
        self.dtype, self.kernel_init = dtype, kernel_init

    def init_params(self, generator: torch.Generator) -> dict:
        shape = self.weight.shape
        if self.kernel_init == "zeros":
            weight = torch.zeros(shape)
        elif self.kernel_init == "orthogonal":
            weight = orthogonal(shape, generator)
        else:
            weight = lecun_normal(shape, shape[1], generator)
        out = {"weight": weight}
        if self.bias is not None:
            out["bias"] = torch.zeros(self.bias.shape)
        return out

    def forward(self, x):
        bias = None if self.bias is None else self.bias.to(self.dtype)
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype), bias)


class Embed(nn.Module):
    """flax's ``nn.Embed``: a float32 ``[vocab, dim]`` table drawn from
    N(0, 1/dim) (flax's default embed init)."""

    def __init__(self, vocab: int, dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(vocab, dim))

    def init_params(self, generator: torch.Generator) -> dict:
        vocab, dim = self.weight.shape
        return {"weight": torch.randn(vocab, dim, generator=generator)
                / math.sqrt(dim)}

    def forward(self, tokens):
        return F.embedding(tokens, self.weight)


class BatchStatsNorm(nn.Module):
    """BatchNorm with ``track_running_stats=False`` semantics: always the
    current batch statistics with the BIASED variance, only the affine
    pair in params. Normalizes NCHW (or ``[B, C]``) over every axis but
    the channel."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(channels))
        self.bias = nn.Parameter(torch.empty(channels))
        self.eps = eps

    def init_params(self, generator: torch.Generator) -> dict:
        return {"weight": torch.ones(self.weight.shape),
                "bias": torch.zeros(self.bias.shape)}

    def forward(self, x):
        return F.batch_norm(x, None, None, self.weight, self.bias,
                            training=True, eps=self.eps)


class GroupNorm(nn.Module):
    """flax's ``nn.GroupNorm`` on NCHW (or ``[B, C]``) input: per sample
    and group of ``C / groups`` channels, float32 statistics with flax's
    fast variance ``max(E[x^2] - E[x]^2, 0)`` and epsilon 1e-6 (flax's
    default, not torch's 1e-5), then the per-channel affine pair."""

    def __init__(self, channels: int, groups: int, eps: float = 1e-6):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(channels))
        self.bias = nn.Parameter(torch.empty(channels))
        self.groups, self.eps = groups, eps

    def init_params(self, generator: torch.Generator) -> dict:
        return {"weight": torch.ones(self.weight.shape),
                "bias": torch.zeros(self.bias.shape)}

    def forward(self, x):
        B, C = x.shape[:2]
        g = x.to(torch.float32).reshape(B, self.groups, -1)
        mean = g.mean(dim=2)
        var = torch.clamp(torch.square(g).mean(dim=2) - torch.square(mean),
                          min=0.0)
        # per-channel stats, then flax's (x - mean) * (rsqrt * scale) + bias
        shape = (B, C) + (1,) * (x.dim() - 2)
        per = C // self.groups
        mean = mean.repeat_interleave(per, dim=1).reshape(shape)
        mul = torch.rsqrt(var.repeat_interleave(per, dim=1) + self.eps) \
            * self.weight
        return (x.to(torch.float32) - mean) * mul.reshape(shape) \
            + self.bias.reshape(shape[1:])


class _GN(nn.Module):
    """The JAX package's ``_GN``: a GroupNorm of 32 groups, halved until
    they divide the channels, as the child ``GroupNorm_0`` (flax's
    param path ``_GN_<i>/GroupNorm_0``)."""

    def __init__(self, channels: int):
        super().__init__()
        groups = 32
        while channels % groups != 0:
            groups //= 2
        self.GroupNorm_0 = GroupNorm(channels, max(groups, 1))

    def forward(self, x):
        return self.GroupNorm_0(x)


NORM_KINDS = {"bn": "BatchStatsNorm", "gn": "_GN"}


def make_norm(kind: str, channels: int) -> nn.Module:
    """Norm factory: 'bn' the batch-statistics norm, 'gn' GroupNorm."""
    if kind == "bn":
        return BatchStatsNorm(channels)
    if kind == "gn":
        return _GN(channels)
    raise ValueError(f"Unknown norm kind {kind!r}")


def norm_name(kind: str, i: int) -> str:
    """flax's auto-name of a parent's ``i``-th norm of ``kind``."""
    return f"{NORM_KINDS[kind]}_{i}"


class Normed(nn.Module):
    """A module whose norms are named as flax auto-names them for its
    ``norm`` kind (``BatchStatsNorm_<i>`` or ``_GN_<i>``):
    ``add_norm(i, channels)`` registers one, ``nrm(i)`` returns it."""

    def __init__(self, norm: str = "bn"):
        super().__init__()
        self.norm = norm

    def add_norm(self, i: int, channels: int) -> None:
        norm = make_norm(self.norm, channels)
        self.add_module(norm_name(self.norm, i), norm)

    def nrm(self, i: int) -> nn.Module:
        return getattr(self, norm_name(self.norm, i))


def dropout(x: torch.Tensor, rate: float, drop) -> torch.Tensor:
    """flax's ``nn.Dropout``: identity without ``drop`` (evaluation) or at
    rate 0; else each element kept with probability ``1 - rate`` and
    scaled by ``1 / (1 - rate)``, zero where dropped. ``drop(shape,
    keep)`` gives the bool keep mask (see :func:`drop_source`)."""
    if drop is None or rate == 0.0:
        return x
    if rate == 1.0:
        return torch.zeros_like(x)
    keep = 1.0 - rate
    return torch.where(drop(tuple(x.shape), keep), x / keep,
                       torch.zeros((), dtype=x.dtype, device=x.device))


_MASK64 = (1 << 64) - 1


def fold_key(key: int, n: int) -> int:
    """A new dropout key from ``key`` and ``n`` (splitmix64 of their
    sum): the port's counterpart of ``jax.random.fold_in`` for the
    personal and outer forwards' own masks."""
    z = (key + (n + 1) * 0x9E3779B97F4A7C15) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (z ^ (z >> 31)) >> 1  # a non-negative int64


_DROP_GENERATORS: dict = {}


class GeneratorDrop:
    """A keep-mask source on a generator: each call draws
    ``rand(shape) < keep`` on ``device``."""

    def __init__(self, gen: torch.Generator, device: torch.device):
        self.gen, self.device = gen, device

    def __call__(self, shape, keep):
        return torch.rand(shape, generator=self.gen,
                          device=self.device) < keep


def drop_source(key, device):
    """The keep-mask source of one training forward: from an integer
    ``key``, a generator on ``device`` reseeded with it, each mask
    ``rand(shape) < keep`` in the forward's call order (the same key
    gives the same masks); a callable ``key(shape, keep)`` is the source
    itself (the tests inject the JAX package's masks so)."""
    if callable(key):
        return key
    device = torch.device(device)
    gen = _DROP_GENERATORS.get(device)
    if gen is None:
        gen = _DROP_GENERATORS[device] = torch.Generator(device=device)
    gen.manual_seed(int(key))
    return GeneratorDrop(gen, device)


def _replayed_sources(drop):
    """The mask sources of a rematerialized block's calls: ``drop`` for
    its forward, then for each recompute a source that gives the same
    masks again. A generator source replays from its state at block
    entry (a fresh generator, so the forward's own draws go on from
    where they were); any other source's masks are kept and handed out
    again in call order."""
    if isinstance(drop, GeneratorDrop):
        state = drop.gen.get_state()
        yield drop
        while True:
            gen = torch.Generator(device=drop.device)
            gen.set_state(state)
            yield GeneratorDrop(gen, drop.device)
    masks = []

    def record(shape, keep):
        masks.append(drop(shape, keep))
        return masks[-1]
    yield record
    while True:
        it = iter(masks)
        yield lambda shape, keep: next(it)


def rematerialized(block, x, drop=None, **kwargs):
    """``block(x, **kwargs)`` (``block(x, drop, **kwargs)`` with a mask
    source) with per-block rematerialization (the JAX package's
    ``nn.remat``): the forward keeps only the block's input, and the
    backward recomputes the block from it (``torch.utils.checkpoint``,
    non-reentrant). The recompute draws the forward's dropout masks
    (:func:`_replayed_sources`), so outputs and gradients are the same as
    without it. ``kwargs`` (the transformer's ``attn_override``) reach
    both calls. Outside autograd (evaluation) it is the plain call."""
    if not torch.is_grad_enabled():
        return block(x, **kwargs) if drop is None \
            else block(x, drop, **kwargs)
    # the block's tensors as they are now: under ModelDef.apply's
    # functional_call they are the caller's params, and the recompute
    # runs in the backward, after functional_call has put the module's
    # own back
    tensors = dict(block.named_parameters())
    tensors.update(block.named_buffers())
    sources = None if drop is None else _replayed_sources(drop)

    def run(t):
        args = (t,) if sources is None else (t, next(sources))
        return functional_call(block, tensors, args, kwargs)
    # the models draw no global random numbers (dropout masks come from
    # the source), so there is no global generator state to stash
    return checkpoint(run, x, use_reentrant=False, preserve_rng_state=False)


class _Method(nn.Module):
    """``module.<name>`` as a module's forward, for :func:`call_method`."""

    def __init__(self, module: nn.Module, name: str):
        super().__init__()
        self.m, self.name = module, name

    def forward(self, *args, **kwargs):
        return getattr(self.m, self.name)(*args, **kwargs)


def call_method(module: nn.Module, params: dict, name: str, *args,
                **kwargs):
    """``module.<name>(*args, **kwargs)`` run on ``params`` (the flax
    ``module.apply(..., method=name)``): ``functional_call`` for a method
    other than ``forward``, so that a caller runs the model's own code
    (the transformer's ``embed``, ``head_apply`` and ``apply_block``)."""
    return functional_call(_Method(module, name),
                           {f"m.{k}": v for k, v in params.items()}, args,
                           kwargs)


def norm_f32(norm: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """Normalize in float32, return in the input's (compute) dtype."""
    return norm(x.to(torch.float32)).to(x.dtype)


# -- client-fused layers (cfg.mesh.client_fusion='fused') ------------------
#
# The k online clients packed into the channel axis: activations travel
# as NCHW views ``[B, k*C, H, W]`` of channels-last memory (the JAX
# package's ``[B, H, W, k, C]``; channel ``g*C + c`` is client g's
# channel c), and every conv is ONE ``F.conv2d(groups=k)``: group g sees
# exactly client g's channels and filters, so the math per client is the
# per-client layer's. Contract shared by every Fused* layer: its
# parameters are the per-client parameters stacked on a leading [k]
# axis under the same names, so ``functional_call(fused, stacked, (x,))``
# consumes the stacked tree the engine's ClientState holds, and the two
# client executions are checkpoint- and state-compatible. The convs are
# XLA code in the JAX package, not Pallas, so cuDNN's grouped conv
# computes them here.


class FusedConv(nn.Module):
    """k per-client :class:`Conv` layers as one grouped convolution: the
    stacked ``[k, cout, cin, kh, kw]`` weight is ``[k*cout, cin, kh,
    kw]`` with no transpose, the stacked ``[k, cout]`` bias ``[k*cout]``.
    ``[B, k*cin, H, W]`` in, ``[B, k*cout, H', W']`` out."""

    def __init__(self, num_clients: int, cin: int, cout: int,
                 kernel_size: int, stride: int = 1, padding: int = 0,
                 dtype: torch.dtype = torch.float32, bias: bool = False):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(
            num_clients, cout, cin, kernel_size, kernel_size))
        if bias:
            self.bias = nn.Parameter(torch.empty(num_clients, cout))
        else:
            self.register_parameter("bias", None)
        self.stride, self.padding, self.dtype = stride, padding, dtype

    def forward(self, x):
        k, cout = self.weight.shape[:2]
        w = self.weight.reshape((k * cout,) + tuple(self.weight.shape[2:]))
        bias = None if self.bias is None \
            else self.bias.reshape(-1).to(self.dtype)
        return F.conv2d(x.to(self.dtype), w.to(self.dtype), bias,
                        stride=self.stride, padding=self.padding, groups=k)


class FusedDense(nn.Module):
    """k per-client :class:`Dense` layers as one batched matmul:
    ``[B, k, cin]`` in, ``[B, k, cout]`` out, the stacked ``[k, cout,
    cin]`` weight and ``[k, cout]`` bias, computed in ``dtype``."""

    def __init__(self, num_clients: int, cin: int, cout: int,
                 bias: bool = True, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(num_clients, cout, cin))
        if bias:
            self.bias = nn.Parameter(torch.empty(num_clients, cout))
        else:
            self.register_parameter("bias", None)
        self.dtype = dtype

    def forward(self, x):
        y = torch.einsum("bki,koi->bko", x.to(self.dtype),
                         self.weight.to(self.dtype))
        if self.bias is not None:
            y = y + self.bias.to(self.dtype)
        return y


class FusedBatchStatsNorm(nn.Module):
    """Per-client :class:`BatchStatsNorm` on client-packed activations
    (``[B, k*C, H, W]`` or ``[B, k*C]``): the statistics of each
    (client, channel) over every other axis, the same element set as the
    per-client norm, with the stacked ``[k, C]`` affine pair."""

    def __init__(self, num_clients: int, channels: int, eps: float = 1e-5):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(num_clients, channels))
        self.bias = nn.Parameter(torch.empty(num_clients, channels))
        self.eps = eps

    def forward(self, x):
        return F.batch_norm(x, None, None, self.weight.reshape(-1),
                            self.bias.reshape(-1), training=True,
                            eps=self.eps)


def fused_norm(kind: str, num_clients: int, channels: int) -> nn.Module:
    """The client-packed counterpart of :func:`make_norm`; only 'bn' has
    a fused form (the fusion gate keeps the per-client execution for
    other norms)."""
    if kind != "bn":
        raise ValueError(
            f"client fusion supports norm='bn' only, got {kind!r}")
    return FusedBatchStatsNorm(num_clients, channels)


class FusedNormed(Normed):
    """A :class:`Normed` whose norms are client-packed (named as the
    per-client module names its norms)."""

    def __init__(self, num_clients: int, norm: str = "bn"):
        super().__init__(norm)
        self.num_clients = num_clients

    def add_norm(self, i: int, channels: int) -> None:
        self.add_module(norm_name(self.norm, i),
                        fused_norm(self.norm, self.num_clients, channels))


def fused_max_pool(x: torch.Tensor, window: int, stride: int) -> torch.Tensor:
    """Per-client max pool of client-packed activations (a pool is per
    channel, so every client's channels pool on their own)."""
    return F.max_pool2d(x, window, stride=stride)


def pack_clients(x: torch.Tensor) -> torch.Tensor:
    """``[k, B, H, W, C]`` stacked batches -> ``[B, k*C, H, W]``, the NCHW
    view of channels-last ``[B, H, W, k, C]`` memory (the fused layers'
    layout)."""
    k, B, H, W, C = x.shape
    return x.permute(1, 2, 3, 0, 4).reshape(B, H, W, k * C).permute(
        0, 3, 1, 2)


class ModelDef(NamedTuple):
    """A model as functions over a params dict (port of the JAX
    package's ``ModelDef``): ``init(generator)`` draws a fresh params
    dict and ``apply(params, x, carry, train=..., rng=...)`` runs the
    shared module with those params (``torch.func.functional_call``), so
    one module serves every client's weights. A recurrent model
    (``is_recurrent``, the char-GRU) takes its hidden state explicitly:
    ``apply(params, x, carry)`` returns ``(logits, new_carry)``, and
    ``init_carry(batch)`` is the fresh zero carry (None for a
    feed-forward model). A model with dropout (``has_dropout``) drops
    only in a training forward given ``rng``, a dropout key
    (:func:`drop_source`); a robust model (``has_noise_param``) carries
    the adversarial input noise as its ``noise`` param."""
    name: str
    module: Any
    sample_input: torch.Tensor
    is_regression: bool = False
    is_recurrent: bool = False
    has_noise_param: bool = False
    has_dropout: bool = False
    # the transformer with MoE blocks: its Switch load-balance loss
    # enters the local step's loss (apply_with_aux)
    has_aux_loss: bool = False

    def init(self, generator: torch.Generator) -> dict:
        """Fresh params (flax's default initializers): drawn on the CPU
        from ``generator`` so the draw is device independent, then moved
        to the module's device."""
        device = self.sample_input.device
        out = {}
        for name, mod in self.module.named_modules():
            if hasattr(mod, "init_params"):
                for pname, t in mod.init_params(generator).items():
                    out[f"{name}.{pname}" if name else pname] = t.to(device)
        return {k: out[k] for k, _ in self.module.named_parameters()}

    def apply(self, params: dict, x: torch.Tensor, carry=None,
              train: bool = False, rng=None):
        if self.is_recurrent:
            return functional_call(self.module, params, (x, carry))
        if self.has_dropout and train and rng is not None:
            return functional_call(self.module, params, (x,), {
                "drop": drop_source(rng, self.sample_input.device)})
        return functional_call(self.module, params, (x,))

    def apply_with_aux(self, params: dict, x: torch.Tensor,
                       train: bool = False, rng=None):
        """``(logits, aux)``: ``aux`` the sum over blocks of the Switch
        load-balance losses (the JAX package sums its ``aux_loss``
        collection, arXiv:2101.03961 §2.2), a float32 0-d tensor. The
        model with an aux loss (the MoE transformer) has no dropout, so
        ``train`` and ``rng`` change nothing."""
        del train, rng
        logits, aux = functional_call(self.module, params, (x,),
                                      {"with_aux": True})
        return logits, aux["load_balance"]

    def init_carry(self, batch_size: int):
        if not self.is_recurrent:
            return None
        return self.module.initial_carry(batch_size).to(
            self.sample_input.device)

    def forward(self, params: dict, x: torch.Tensor, train: bool = False,
                rng=None):
        """The logits of ``x``, a recurrent model's from a fresh zero
        carry: the forward of evaluation and of every auxiliary probe
        (the JAX package's ``forward_fn``; ``train``/``rng`` as for
        :meth:`apply`)."""
        if self.is_recurrent:
            return self.apply(params, x, self.init_carry(x.shape[0]))[0]
        return self.apply(params, x, train=train, rng=rng)
