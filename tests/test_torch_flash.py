"""Flash attention, port vs the JAX package, on the CPU.

The port's ``flash_attention`` takes its plain version on CPU tensors
(``flash_fwd_ref``, the port of ``_fwd_xla``) and the chunked backward
in torch ops; the JAX package's runs its Pallas kernel in interpret
mode (``force="interpret"``) or its XLA oracle and custom VJP
(``force="xla"``). Same numpy inputs through both.

Tolerances are the JAX package's own for its kernel against its oracle
(tests/test_flash_attention.py): outputs and logsumexp 2e-5 in float32,
3e-2 in bfloat16; gradients atol 5e-5, rtol 5e-4.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import torch_threads  # noqa: F401 (two torch threads a worker)
from fedtorch_tpu.ops.attention_dispatch import (
    FLASH_MIN_SEQ_LEN as J_MIN, resolve_attention as j_resolve,
)
from fedtorch_tpu.ops.pallas.flash_attention import (
    flash_attention as jflash, flash_attention_with_lse as jflash_lse,
)
from fedtorch_tpu_torch.ops.attention_dispatch import (
    FLASH_MIN_SEQ_LEN as T_MIN, resolve_attention as t_resolve,
)
from fedtorch_tpu_torch.ops.cuda import build, flash_attention as fa


def _qkv(B=2, T=256, H=4, D=64, seed=0):
    rng = np.random.RandomState(seed)
    return tuple(rng.randn(B, T, H, D).astype(np.float32) for _ in range(3))


def _port(arrays, dtype=torch.float32, grad=False):
    return tuple(torch.from_numpy(a).to(dtype).requires_grad_(grad)
                 for a in arrays)


def _np(t):
    return t.detach().float().numpy()


@pytest.mark.parametrize("causal, dtype, D", [
    pytest.param(c, d, 64, id=f"{c}-{d}") for d in ("float32", "bfloat16")
    for c in (False, True)] + [
    # the default transformer's heads (d_model 100: 4 of 25) and those of
    # d_model 512 (4 of 128), which the port's kernels take on the card;
    # past 256 (320: the TF32 kernel's column blocks; 512: d_model 2048's
    # heads)
    pytest.param(c, d, D, id=f"{c}-{d}-D{D}") for D in (25, 128, 320, 512)
    for d in ("float32", "bfloat16") for c in (False, True)])
def test_matches_the_interpret_kernel(causal, dtype, D):
    """T 256 in 128-blocks: the JAX kernel's multi-block online softmax
    and, causal, its block skip, against the port's plain version."""
    qkv = _qkv(D=D, seed=0 if D == 64 else D)
    jo, jl = jflash_lse(*(jnp.asarray(a, dtype) for a in qkv),
                        causal=causal, block_q=128, block_k=128,
                        force="interpret")
    to, tl = fa.flash_attention_with_lse(
        *_port(qkv, getattr(torch, dtype)), causal=causal)
    assert to.dtype == getattr(torch, dtype) and tl.dtype == torch.float32
    tol = 2e-5 if dtype == "float32" else 3e-2
    np.testing.assert_allclose(_np(to), np.asarray(jo, np.float32),
                               atol=tol, rtol=tol)
    np.testing.assert_allclose(_np(tl), np.asarray(jl), atol=tol, rtol=tol)


@pytest.mark.parametrize("T, D", [(32, 16), (100, 32), (200, 32),
                                  (257, 32)])
def test_ragged_lengths_match(T, D):
    """One block (T 32), and lengths no 128-block divides: the JAX
    package re-derives a divisor block, the port's kernel masks."""
    qkv = _qkv(T=T, D=D)
    jo = jflash(*qkv, causal=True, force="interpret")
    to = fa.flash_attention(*_port(qkv), causal=True)
    np.testing.assert_allclose(_np(to), np.asarray(jo), atol=2e-5,
                               rtol=2e-5)


@pytest.mark.parametrize("T, block_q", [(256, 64), (100, None)])
@pytest.mark.parametrize("causal", [False, True])
def test_gradients_match_the_custom_vjp(T, block_q, causal):
    """q, k, v gradients of a loss that consumes both outputs, so the
    backward carries the g_lse term; against the JAX custom VJP."""
    qkv = _qkv(T=T, D=32)
    rng = np.random.RandomState(1)
    w_o = rng.randn(*qkv[0].shape).astype(np.float32)
    w_l = rng.randn(2, T, 4).astype(np.float32)

    def jloss(q, k, v):
        o, lse = jflash_lse(q, k, v, causal=causal, block_q=block_q,
                            force="xla")
        return jnp.sum(o * w_o) + jnp.sum(lse * w_l)

    jg = jax.grad(jloss, argnums=(0, 1, 2))(*qkv)
    q, k, v = _port(qkv, grad=True)
    o, lse = fa.flash_attention_with_lse(q, k, v, causal=causal,
                                         block_q=block_q)
    loss = (o * torch.from_numpy(w_o)).sum() \
        + (lse * torch.from_numpy(w_l)).sum()
    tg = torch.autograd.grad(loss, (q, k, v))
    for name, j, t in zip("qkv", jg, tg):
        np.testing.assert_allclose(_np(t), np.asarray(j), atol=5e-5,
                                   rtol=5e-4, err_msg=f"d{name}")


def test_gradient_without_the_logsumexp():
    qkv = _qkv(T=64, D=16)
    jg = jax.grad(lambda q: jnp.sum(jflash(q, *qkv[1:], causal=True,
                                           force="xla") ** 2))(qkv[0])
    q, k, v = _port(qkv, grad=True)
    (fa.flash_attention(q, k, v, causal=True) ** 2).sum().backward()
    np.testing.assert_allclose(_np(q.grad), np.asarray(jg), atol=5e-5,
                               rtol=5e-4)


def test_unequal_shapes_raise_by_name():
    q = _port(_qkv(T=64, D=16))[0]
    k = _port(_qkv(T=32, D=16, seed=1))[0]
    with pytest.raises(ValueError, match="identical shape"):
        fa.flash_attention(q, k, k)
    with pytest.raises(ValueError, match="identical shape"):
        fa.flash_attention_with_lse(q, k, k)


def test_nonfinite_scores_follow_the_oracle():
    """A q row of NaN and a k row of +inf. The port's plain version (and
    so the kernel it holds on the card) equals the JAX package's oracle
    ``_fwd_xla``. The Pallas kernel itself drops every k-block before
    the one holding a non-finite running max (its corr is 0 there), so
    rows past the first q-block depart from the oracle; the port does
    not copy that."""
    q, k, v = _qkv()
    q[0, 5, 1] = np.nan
    k[1, 3, 2] = np.inf
    to, tl = fa.flash_attention_with_lse(*_port((q, k, v)), causal=True)
    jo, jl = jflash_lse(q, k, v, causal=True, force="xla")
    np.testing.assert_allclose(_np(to), np.asarray(jo), atol=2e-5,
                               rtol=2e-5)
    np.testing.assert_allclose(_np(tl), np.asarray(jl), atol=2e-5,
                               rtol=2e-5)
    # the NaN row attends to nothing: o = 0, lse = log(1e-30)
    assert not np.isnan(_np(to)).any()
    np.testing.assert_array_equal(_np(to)[0, 5, 1], 0.0)
    np.testing.assert_allclose(_np(tl)[0, 5, 1], np.log(1e-30), rtol=1e-6)
    po, _ = jflash_lse(q, k, v, causal=True, block_q=128, block_k=128,
                       force="interpret")
    gap = np.abs(np.asarray(po) - np.asarray(jo))[1, :, 2]
    assert gap[:128].max() < 2e-5 and gap[128:].max() > 0.1


@pytest.mark.parametrize("mode", ["auto", "dense", "flash"])
def test_dispatch_is_the_jax_packages(mode):
    assert T_MIN == J_MIN
    for T in (1, 50, 2048, J_MIN - 1, J_MIN, 8192):
        assert t_resolve(mode, T) == j_resolve(mode, T)


def test_unknown_attention_mode_raises():
    with pytest.raises(ValueError, match="attention must be"):
        t_resolve("sparse", 64)


@pytest.mark.parametrize("T, block, want", [(2048, 128, 128), (50, 128, 50),
                                            (200, 128, 200),
                                            (192, 128, 64), (8192, 512, 512)])
def test_backward_chunks_follow_the_jax_package(T, block, want):
    assert fa._default_blocks(T)[0] == block
    assert fa._divisor_block(T, block) == want


def test_every_source_has_its_flags():
    """The quantizer keeps --fmad=false; attention contracts freely."""
    names = sorted(p.name for p in build.CSRC_DIR.glob("*.cu"))
    assert names == sorted(build.SOURCE_FLAGS)
    for name, flags in build.SOURCE_FLAGS.items():
        assert ("--fmad=false" in flags) == name.startswith("qdq_")


def test_cpu_tensors_launch_nothing():
    before = fa.flash_launches
    fa.flash_attention(*_port(_qkv(T=16, D=16)), causal=True)
    assert fa.flash_launches == before
