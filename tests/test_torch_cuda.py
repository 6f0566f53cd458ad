"""The port on a CUDA device: each kernel against its plain version, and
small rounds on the card against the same rounds on the CPU.

Imports neither JAX nor the JAX package, so it also runs where only
PyTorch is installed; there the repo's conftest (which imports JAX) is
skipped:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Every test is marked ``cuda`` and skips without a CUDA device.
"""
import numpy as np
import pytest
import torch

from fedtorch_tpu_torch import config as tcfg
from fedtorch_tpu_torch.algorithms import make_algorithm
from fedtorch_tpu_torch.data.batching import stack_partitions
from fedtorch_tpu_torch.models import define_model
from fedtorch_tpu_torch.ops.cuda import flash_attention as fa
from fedtorch_tpu_torch.ops.cuda import quant_kernel as qk
from fedtorch_tpu_torch.parallel import FederatedTrainer

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _steps(x, bits):
    qmin, qmax = qk.qrange(bits)
    step = (x.max(1, keepdims=True) - x.min(1, keepdims=True)) \
        / (qmax - qmin)
    return np.where(step == 0, 1e-3, step)  # the scale floor


@pytest.mark.parametrize("n, bits", [(1, 8), (257, 8), (2304, 16),
                                     (36864, 8)])
def test_kernel_matches_plain_version(cuda, n, bits):
    rng = np.random.RandomState(n)
    x = torch.from_numpy(rng.randn(30, n).astype(np.float32)).to(cuda)
    got = qk.qdq_batch(x, bits).cpu().numpy()
    want = qk.qdq_batch_ref(x, bits).cpu().numpy()
    steps = _steps(x.cpu().numpy(), bits)
    # one step, plus the float32 rounding of the dequantized value
    assert np.all(np.abs(got - want)
                  <= steps * (1 + 1e-5) + 1e-6 * np.abs(want) + 1e-7)


def test_kernel_is_bitwise_on_exact_sums_and_propagates_nan(cuda):
    rng = np.random.RandomState(1)
    x = (rng.randint(-64, 65, size=(6, 512)) / 16.0).astype(np.float32)
    x[4] = 1.5       # constant row: the scale floor
    x[5, 9] = np.nan
    xt = torch.from_numpy(x).to(cuda)
    got = qk.qdq_batch(xt, 8).cpu().numpy()
    want = qk.qdq_batch_ref(xt, 8).cpu().numpy()
    np.testing.assert_array_equal(got, want)
    assert np.isnan(got[5]).all() and not np.isnan(got[:5]).any()


@pytest.mark.parametrize("rows, n, bits", [(3, 600_001, 8), (2, 921_600, 16),
                                           (5, 3 * 8192 + 101, 8),
                                           (4, 1000, 16)])
def test_pair_matches_plain_version(cuda, rows, n, bits):
    rng = np.random.RandomState(n + bits)
    x = torch.from_numpy(rng.randn(rows, n).astype(np.float32)).to(cuda)
    p = qk.qdq_tiled_stats(x)
    want_p = qk.qdq_tiled_stats_ref(x)
    # min and max are exact in any order, sums within float32 rounding
    assert torch.equal(p[..., :2], want_p[..., :2])
    torch.testing.assert_close(p[..., 2], want_p[..., 2], rtol=1e-5,
                               atol=1e-3)
    got = qk.qdq_tiled_apply(x, p, bits).cpu().numpy()
    want = qk.qdq_tiled_ref(x, bits).cpu().numpy()
    steps = _steps(x.cpu().numpy(), bits)
    assert np.all(np.abs(got - want)
                  <= steps * (1 + 1e-5) + 1e-6 * np.abs(want) + 1e-7)


def test_pair_is_bitwise_on_exact_sums_and_propagates_nan(cuda):
    rng = np.random.RandomState(2)
    n = 2 * 8192 + 33
    x = (rng.randint(-64, 65, size=(5, n)) / 16.0).astype(np.float32)
    x[3] = 1.5                  # constant row: the scale floor
    x[4, 3] = np.nan            # in the first chunk, survives the fold
    xt = torch.from_numpy(x).to(cuda)
    got = qk.qdq_tiled(xt, 8).cpu().numpy()
    np.testing.assert_array_equal(got, qk.qdq_tiled_ref(xt, 8).cpu().numpy())
    assert np.isnan(got[4]).all() and not np.isnan(got[:4]).any()
    np.testing.assert_array_equal(got[3], x[3])


@pytest.mark.parametrize("n", [1, 4097, 524_288, 524_289])
def test_single_tensor_entry_routes_and_matches(cuda, n):
    x = torch.from_numpy((np.random.RandomState(n).randint(
        -64, 65, size=n) / 16.0).astype(np.float32)).to(cuda)
    before = (qk.launches, qk.stats_launches, qk.apply_launches)
    got = qk.fused_quantize_dequantize(x, 8)
    after = (qk.launches, qk.stats_launches, qk.apply_launches)
    # at most 524,288 elements: one launch of the ragged pair
    row = n <= qk._MAX_ROW_ELEMS
    assert np.subtract(after, before).tolist() == (
        [1, 0, 0] if row else [0, 1, 1])
    plain = qk.qdq_batch_ref if row else qk.qdq_tiled_ref
    assert torch.equal(got, plain(x.view(1, -1), 8).view(-1))


def _row_path_shapes(arch, widen=None, k=10):
    """The ragged pair's uplink and downlink leaves on a main path: every
    parameter of at most ``_MAX_ROW_ELEMS`` elements, as [k, n] and
    [1, n]."""
    kw = {} if widen is None else dict(wideresnet_widen_factor=widen)
    if arch == "densenet100":  # DenseNet-BC-100, growth 12
        kw = dict(densenet_bc_mode=True, densenet_growth_rate=12,
                  densenet_compression=0.5)
    data = tcfg.DataConfig(dataset="shakespeare" if arch == "transformer"
                           else "cifar10")
    model = tcfg.ModelConfig(arch=arch, **kw) if arch != "transformer" \
        else tcfg.ModelConfig(arch=arch, rnn_hidden_size=128,
                              mlp_num_layers=4, rnn_seq_len=2048)
    cfg = tcfg.ExperimentConfig(data=data, model=model).finalize()
    ns = [v.numel() for _, v in
          define_model(cfg, device="cpu").module.named_parameters()]
    ns = [n for n in ns if n <= qk._MAX_ROW_ELEMS]
    return [(k, n) for n in ns], [(1, n) for n in ns]


def _assert_ragged_matches(leaves, bits, bitwise=False):
    """The pair against its plain version: the same NaN pattern, and each
    element within one step of its row (bitwise if asked)."""
    got = qk.qdq_ragged(leaves, bits)
    want = qk.qdq_ragged_ref(leaves, bits)
    for x, g, w in zip(leaves, got, want):
        assert g.shape == x.shape
        assert torch.equal(g.isnan(), w.isnan())
        if bitwise:
            assert bool(((g == w) | g.isnan()).all())
            continue
        x, g, w = (t.cpu().numpy() for t in (x, g, w))
        fin = np.where(np.isfinite(x), x, 0.0)
        steps = _steps(fin, bits)
        d = np.nan_to_num(np.abs(g - w), nan=0.0)
        assert np.all(d <= steps * (1 + 1e-5)
                      + 1e-6 * np.abs(np.nan_to_num(w)) + 1e-7)


@pytest.mark.parametrize("arch, widen", [("resnet20", None),
                                         ("wideresnet28", 10),
                                         ("transformer", None),
                                         ("densenet100", None)])
def test_ragged_pair_at_the_main_paths_row_trees(cuda, arch, widen):
    """One launch of each kernel per tree call at each main path's
    row-path trees, uplink (k = 10) and downlink; int8 random and int16
    bitwise on dyadic inputs. DenseNet-BC-100's 299 leaves take the
    large leaf table: still one launch of each (2,990 uplink rows)."""
    gen = torch.Generator(device=cuda).manual_seed(0)
    for shapes in _row_path_shapes(arch, widen):
        leaves = [torch.randn(s, generator=gen, device=cuda) * 1e-3
                  for s in shapes]
        before = (qk.ragged_stats_launches, qk.ragged_apply_launches)
        _assert_ragged_matches(leaves, 8)
        assert (qk.ragged_stats_launches - before[0],
                qk.ragged_apply_launches - before[1]) == (1, 1)
        dyadic = [torch.randint(-64, 65, s, generator=gen,
                                device=cuda).float() / 16 for s in shapes]
        _assert_ragged_matches(dyadic, 16, bitwise=True)


def test_ragged_pair_on_misaligned_and_non_finite_rows(cuda):
    """Rows of 1, 10 and 86 elements put later rows off 16-byte
    alignment; a leaf of rows spanning chunks has NaN in a first chunk,
    +inf in a middle one, -inf in a ragged last one and a constant row;
    a dyadic tree with NaN stays bitwise with the NaN pattern kept."""
    rng = np.random.RandomState(4)
    n = 3 * qk._CHUNK + 101
    edge = rng.randn(5, n).astype(np.float32)
    edge[1, 5] = np.nan
    edge[2, qk._CHUNK + 17] = np.inf
    edge[3, n - 1] = -np.inf
    edge[4] = 0.25
    leaves = [rng.randn(10, m).astype(np.float32) for m in (1, 10, 86)]
    leaves = [torch.from_numpy(x).to(cuda) for x in leaves + [edge]]
    for bits in (8, 16):
        _assert_ragged_matches(leaves, bits)
    got = qk.qdq_ragged(leaves, 8)
    assert torch.equal(got[3][4], leaves[3][4])
    assert bool(got[3][1:4].isnan().all())
    dy = [(rng.randint(-64, 65, size=s) / 16.0).astype(np.float32)
          for s in ((10, 86), (4, 2 * qk._CHUNK + 3))]
    dy[0][2, 7] = np.nan
    dy[1][3, qk._CHUNK + 1] = np.nan
    _assert_ragged_matches([torch.from_numpy(x).to(cuda) for x in dy], 8,
                           bitwise=True)


def test_a_tree_larger_than_one_table_takes_more_launches(cuda):
    leaves = [torch.randn(2, 1 + i, device=cuda)
              for i in range(qk._TABLE_LEAVES + 34)]
    before = (qk.ragged_stats_launches, qk.ragged_apply_launches)
    _assert_ragged_matches(leaves, 8)
    assert (qk.ragged_stats_launches - before[0],
            qk.ragged_apply_launches - before[1]) == (2, 2)


def test_dropout_draws_on_the_card_keep_at_the_rate(cuda):
    """A dropout key reseeds a generator on the card: the kept share
    within 4 sigma of 1 - rate, kept elements scaled by 1 / (1 - rate),
    the same key the same masks, another key others."""
    from fedtorch_tpu_torch.models.common import (
        drop_source, dropout, fold_key,
    )
    x = torch.rand(256, 1024, device=cuda) + 1.0
    out = dropout(x, 0.3, drop_source(11, cuda))
    kept = out != 0
    sigma = (0.3 * 0.7 / x.numel()) ** 0.5
    assert abs(float(kept.float().mean()) - 0.7) <= 4 * sigma
    assert torch.equal(out[kept], x[kept] / 0.7)
    assert torch.equal(out, dropout(x, 0.3, drop_source(11, cuda)))
    assert not torch.equal(out, dropout(x, 0.3,
                                        drop_source(fold_key(11, 1), cuda)))


def test_quantized_round_on_the_card_matches_the_cpu(cuda):
    """One quantized ResNet-8 round, same weights and plan, on the card
    (float32, TF32 off) and on the CPU: each leaf's update within two
    int8 downlink steps."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = tcfg.ExperimentConfig(
        data=tcfg.DataConfig(dataset="cifar10", batch_size=8),
        federated=tcfg.FederatedConfig(
            federated=True, num_clients=4, online_client_rate=0.5,
            sync_type="local_step", quantized=True),
        model=tcfg.ModelConfig(arch="resnet8"),
        optim=tcfg.OptimConfig(lr=0.1, in_momentum=True),
        train=tcfg.TrainConfig(local_step=2)).finalize()
    rng = np.random.RandomState(0)
    data = stack_partitions(rng.randn(64, 32, 32, 3).astype(np.float32),
                            rng.randint(0, 10, 64),
                            [np.arange(16 * i, 16 * i + 16)
                             for i in range(4)])
    out = {}
    for dev in ("cpu", cuda):
        tr = FederatedTrainer(cfg, define_model(cfg, 8, device=dev),
                              make_algorithm(cfg), data, device=dev)
        server, clients = tr.init_state(7)
        p0 = {k: v.cpu() for k, v in server.params.items()}
        plan = tr.draw_plan(server)
        before = qk.launches
        server, clients, m = tr.round_fn(server, clients, plan)
        if dev != "cpu":
            # one ragged pair launch per tree call: uplink and downlink
            assert qk.launches - before == 2
        out[str(dev)] = {k: v.cpu() - p0[k]
                         for k, v in server.params.items()}
    for k, u in out["cpu"].items():
        step = float(u.max() - u.min()) / 255.0
        assert float((out["cuda"][k] - u).abs().max()) <= 2 * step + 1e-7


def test_stream_plane_on_the_card_is_bitwise_the_resident_plane(cuda,
                                                                 tmp_path):
    """Quantized FedAvg on an MLP, 3 rounds from one seed: the stream
    plane (pinned feeds copied on a side stream, from the on-disk store,
    depth 1, then a window of 2) against the resident plane on the card,
    bitwise, the generator's state too; the feeds on the card."""
    from fedtorch_tpu_torch.data.streaming import save_client_store
    rng = np.random.RandomState(3)
    data = stack_partitions(rng.randn(96, 32, 32, 3).astype(np.float32),
                            rng.randint(0, 10, 96),
                            [np.arange(12 * i, 12 * i + 12)
                             for i in range(8)])
    save_client_store(str(tmp_path), data, clients_per_shard=3)
    finals = {}
    for plane in ("device", "stream"):
        cfg = tcfg.ExperimentConfig(
            data=tcfg.DataConfig(dataset="cifar10", batch_size=4,
                                 data_plane=plane,
                                 store="mmap" if plane == "stream"
                                 else "ram", store_dir=str(tmp_path)),
            federated=tcfg.FederatedConfig(
                federated=True, num_clients=8, online_client_rate=0.25,
                algorithm="fedavg", sync_type="local_step", quantized=True),
            model=tcfg.ModelConfig(arch="mlp", mlp_hidden_size=32),
            optim=tcfg.OptimConfig(lr=0.1),
            train=tcfg.TrainConfig(local_step=2)).finalize()
        tr = FederatedTrainer(cfg, define_model(cfg, 4, device=cuda),
                              make_algorithm(cfg), data, device=cuda)
        tr.stream_depth = 1
        tr.stream_timeout_s = 30.0
        server, clients = tr.init_state(11)
        server, clients, _ = tr.run_round(server, clients)
        server, clients, _ = tr.run_rounds(server, clients, 2)
        if plane == "stream":
            assert tr.stream_stats()["rounds_produced"] >= 3
        tr.close()
        finals[plane] = (server.params, server.rng.get_state())
    for k, p in finals["device"][0].items():
        assert torch.equal(p, finals["stream"][0][k]), k
    assert torch.equal(finals["device"][1], finals["stream"][1])


def test_quantized_fedgate_round_on_the_card_matches_the_cpu(cuda):
    """One FedCOMGATE round (FedGATE, int8 uplink and downlink through the
    ragged pair), same weights and plan, on the card (float32, TF32 off)
    and on the CPU: each leaf's update, and each online client's
    tracking variate, within two int8 downlink steps of the aggregate
    (the variate moves by (delta_i - d) / (lr K))."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = tcfg.ExperimentConfig(
        data=tcfg.DataConfig(dataset="cifar10", batch_size=8),
        federated=tcfg.FederatedConfig(
            federated=True, num_clients=4, online_client_rate=0.5,
            algorithm="fedgate", sync_type="local_step", quantized=True),
        model=tcfg.ModelConfig(arch="resnet8"),
        optim=tcfg.OptimConfig(lr=0.1),
        train=tcfg.TrainConfig(local_step=2)).finalize()
    rng = np.random.RandomState(0)
    data = stack_partitions(rng.randn(64, 32, 32, 3).astype(np.float32),
                            rng.randint(0, 10, 64),
                            [np.arange(16 * i, 16 * i + 16)
                             for i in range(4)])
    out, tracking, plan = {}, {}, None
    for dev in ("cpu", cuda):
        tr = FederatedTrainer(cfg, define_model(cfg, 8, device=dev),
                              make_algorithm(cfg), data, device=dev)
        server, clients = tr.init_state(7)
        p0 = {k: v.cpu() for k, v in server.params.items()}
        plan = plan or tr.draw_plan(server)
        before = (qk.ragged_stats_launches, qk.ragged_apply_launches)
        server, clients, _ = tr.round_fn(server, clients, plan)
        if dev != "cpu":
            assert (qk.ragged_stats_launches - before[0],
                    qk.ragged_apply_launches - before[1]) == (2, 2)
        out[str(dev)] = {k: v.cpu() - p0[k]
                         for k, v in server.params.items()}
        tracking[str(dev)] = {k: v[plan.idx].cpu()
                              for k, v in clients.aux["delta"].items()}
    lr_k = 0.1 * 2
    for k, u in out["cpu"].items():
        step = float(u.max() - u.min()) / 255.0
        assert float((out["cuda"][k] - u).abs().max()) <= 2 * step + 1e-7
        assert float((tracking["cuda"][k] - tracking["cpu"][k]).abs()
                     .max()) <= (2 * step + 1e-6) / lr_k, k


def test_topk_keeps_the_lower_index_among_ties_on_the_card(cuda):
    """x and -x tied at the k-th place, repeated magnitudes, zeros: the
    card keeps what the CPU keeps (the lower index), bitwise."""
    from fedtorch_tpu_torch.ops.topk import topk_roundtrip
    rng = np.random.RandomState(9)
    for n, ratio in ((8, 0.75), (4096, 0.1), (36_864, 1.0),
                     (100_003, 0.02)):
        x = torch.from_numpy((rng.randint(-4, 5, n) * 0.25).astype(
            np.float32))
        want = topk_roundtrip(x, ratio)
        got = topk_roundtrip(x.to(cuda), ratio).cpu()
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def _bf16_spacing(x):
    """bfloat16's spacing at |x| (8 significant bits)."""
    mag = x.abs().float().clamp_min(2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(mag)) - 7)


def _assert_bf16_close(o, ro):
    """The two float32 results within 2e-5, then each rounded once to
    bfloat16: within that plus one bfloat16 spacing, same NaN pattern."""
    got, want = o.float(), ro.float()
    assert torch.equal(got.isnan(), want.isnan())
    got, want = got.nan_to_num(0.0), want.nan_to_num(0.0)
    slack = _bf16_spacing(torch.maximum(got.abs(), want.abs())) \
        + 2e-5 + 2e-5 * want.abs()
    diff = (got - want).abs()
    assert bool((diff <= slack).all()), float((diff - slack).max())


_TC_CASES = [(torch.bfloat16, causal, T, D, 0)
             for T in (1, 63, 65, 300, 2048) for causal in (True, False)
             for D in (64, 128, 256)]
# the TF32 kernel: every padded head dim and the default model's 25
_TF32_CASES = [(dtype, causal, T, D, 0)
               for dtype in (torch.float32, torch.bfloat16)
               for causal in (True, False) for T in (1, 50, 257)
               for D in (8, 25, 100)]
# past head dim 128: both kernels' wide instances (bf16 at 192 and 256
# on the wgmma kernel, the rest on the TF32 kernel's 16-key tiles)
_WIDE_CASES = [(dtype, causal, T, D, 0)
               for dtype in (torch.float32, torch.bfloat16)
               for causal in (True, False) for T in (1, 129, 2048)
               for D in (136, 192, 200, 256)]
# past head dim 256: the TF32 kernel's clusters of 2 to 8 CTAs (both
# dtypes) and its chunked kernel past 2048, the wgmma kernel's D-512
# cluster (aligned bfloat16 at 512), and misaligned bfloat16 at 512 on
# the TF32 kernel
_PAST_256_CASES = [(dtype, causal, T, D, 0)
                   for dtype in (torch.float32, torch.bfloat16)
                   for causal in (True, False) for T in (1, 129, 300)
                   for D in (257, 320, 384, 512, 576, 1024, 2056)] + [
    (torch.bfloat16, True, 129, 512, 1), (torch.bfloat16, False, 300, 512, 2),
    (torch.float32, True, 2048, 512, 0), (torch.bfloat16, True, 2048, 512, 0),
    (torch.float32, False, 300, 2048, 0), (torch.float32, True, 129, 576, 1)]


@pytest.mark.parametrize("dtype, causal, T, D, offset", [
    (torch.float32, True, 257, 64, 0), (torch.float32, False, 50, 32, 0),
    (torch.bfloat16, True, 300, 64, 0), (torch.float32, True, 1, 16, 0),
    (torch.bfloat16, False, 129, 128, 0), (torch.float32, True, 129, 64, 1),
] + _TC_CASES + _TF32_CASES + _WIDE_CASES + _PAST_256_CASES + [
    (torch.bfloat16, True, 129, 64, 1), (torch.bfloat16, True, 129, 25, 2),
    (torch.bfloat16, True, 129, 256, 1), (torch.bfloat16, False, 300, 200, 2),
    (torch.float32, True, 2048, 128, 0), (torch.bfloat16, False, 2048, 25, 0)])
def test_flash_kernel_matches_plain_version(cuda, dtype, causal, T, D,
                                            offset):
    """On strided q, k, v chunks of one projection (``offset`` 1:
    misaligned, the element loads for bfloat16); float32 within 2e-5,
    bfloat16 o within that plus one bfloat16 spacing. TF32 off for the
    plain version. Aligned bfloat16 at a head dim of ``TC_HEAD_DIMS``
    takes the wgmma kernel, the rest the TF32 kernel."""
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.RandomState(T + D)
    x = torch.from_numpy(rng.randn(2, T, 3 * 4 * D + offset).astype(
        np.float32)).to(cuda, dtype)[..., offset:]
    q, k, v = (c.view(2, T, 4, D) for c in x.chunk(3, dim=-1))
    tc = dtype == torch.bfloat16 and D in fa.TC_HEAD_DIMS and offset == 0
    before = (fa.flash_launches, fa.flash_tc_launches,
              fa.flash_tf32_launches)
    o, lse = fa.flash_fwd(q, k, v, D ** -0.5, causal)
    assert (fa.flash_launches, fa.flash_tc_launches,
            fa.flash_tf32_launches) == (before[0] + 1, before[1] + int(tc),
                                        before[2] + int(not tc))
    ro, rl = fa.flash_fwd_ref(q, k, v, D ** -0.5, causal)
    assert o.dtype == dtype and lse.shape == (2, 4, T)
    torch.testing.assert_close(lse, rl, rtol=2e-5, atol=2e-5)
    if dtype == torch.float32:
        torch.testing.assert_close(o, ro, rtol=2e-5, atol=2e-5)
    else:
        _assert_bf16_close(o, ro)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_cluster_plans_fit_on_the_card(cuda, dtype):
    """Each cluster launch as its kernel reports it: ceil(D / 256) CTAs
    of the TF32 kernel from 257 to 2048 (218,624 B a CTA in float32,
    177,152 in bfloat16), two of the wgmma kernel at 512 (230,400 B),
    each with at least one cluster that fits on the card; no cluster
    below 257 or past 2048 (the chunked kernel)."""
    for D in (257, 512, 576, 1024, 2048):
        n, smem, active = fa.cluster_plan("tf32", dtype, D)
        assert n == -(-D // 256) and active >= 1
        assert smem == (218624 if dtype == torch.float32 else 177152)
    assert fa.cluster_plan("tf32", dtype, 256) is None
    assert fa.cluster_plan("tf32", dtype, 2049) is None
    if dtype == torch.bfloat16:
        n, smem, active = fa.cluster_plan("tc", dtype, 512)
        assert (n, smem) == (2, 230400) and active >= 1
        assert fa.cluster_plan("tc", dtype, 256) is None


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_follows_the_nonfinite_rules(cuda, dtype):
    """A q row of NaN attends to nothing (o = 0, lse = log 1e-30); a k
    row of +inf scores NaN and is skipped, as in the plain version. A
    -inf k element under q elements > 0 scores -inf: p = 0 and the
    running max stays where it was, so the scores of key 5 (>= 125) do
    not overflow exp. float32 goes through the TF32 kernel, bfloat16
    through the wgmma kernel; at head dim 64 and 512 (the TF32 kernel's
    column blocks, the wgmma kernel's D-512 instance)."""
    rng = np.random.RandomState(7)
    for D in (64, 512):
        q, k, v = (torch.from_numpy(rng.randn(2, 257, 4, D).astype(
            np.float32)).to(cuda, dtype) for _ in range(3))
        q[0, 5, 1] = float("nan")
        k[1, 3, 2] = float("inf")
        q[1, :, 3, 0] = q[1, :, 3, 0].abs() + 1
        k[1, 3, 3, 0] = float("-inf")
        k[1, 5, 3] = 0.0
        k[1, 5, 3, 0] = 1000.0
        before = fa.flash_tc_launches
        o, lse = fa.flash_fwd(q, k, v, D ** -0.5, True)
        assert fa.flash_tc_launches == before + int(dtype == torch.bfloat16)
        ro, rl = fa.flash_fwd_ref(q, k, v, D ** -0.5, True)
        torch.testing.assert_close(lse, rl, rtol=2e-5, atol=2e-5)
        if dtype == torch.float32:
            torch.testing.assert_close(o, ro, rtol=2e-5, atol=2e-5)
        else:
            _assert_bf16_close(o, ro)
        assert float(o[0, 5, 1].abs().max()) == 0.0
        assert bool(lse[1, 3].isfinite().all())
        assert bool(o[1, :, 3].isfinite().all())
    for D in (64, 128, 256, 512) if dtype == torch.bfloat16 \
            else (64, 256, 384, 512):
        _check_infinite_v(cuda, dtype, D)


def _check_infinite_v(cuda, dtype, D):
    """+inf and -inf v elements: only the hi product of p sees them (the
    TF32 kernel masks the cross products, the wgmma kernel's p_lo
    product reads a sanitized copy of the tile), so o is +-inf where the
    plain version's p > 0 meets them and NaN where it computes 0 inf,
    including the rows before the key, whose tiles past the diagonal the
    kernel skips (its pre-pass marks those columns); causal and not,
    over three query tiles, a column of V's last atom at D 128 and 256,
    and past 256 a column of the second column block (the TF32 kernel)
    or of the second warpgroup's half (the wgmma kernel at 512)."""
    rng = np.random.RandomState(8)
    q, k, v = (torch.from_numpy(rng.randn(2, 300, 4, D).astype(
        np.float32)).to(cuda, dtype) for _ in range(3))
    v[0, 0, 1, 11] = float("inf")
    v[0, 40, 1, 3] = float("inf")
    v[0, 100, 1, 3] = float("-inf")
    v[0, 100, 1, 7] = float("-inf")
    v[1, 200, 2, 9] = float("inf")
    v[1, 299, 3, 0] = float("-inf")
    v[1, 150, 0, D - 1] = float("inf")
    for causal in (True, False):
        before = fa.flash_tc_launches
        o, lse = fa.flash_fwd(q, k, v, D ** -0.5, causal)
        assert fa.flash_tc_launches == before + int(dtype == torch.bfloat16)
        ro, rl = fa.flash_fwd_ref(q, k, v, D ** -0.5, causal)
        torch.testing.assert_close(lse, rl, rtol=2e-5, atol=2e-5)
        assert torch.equal(o.isnan(), ro.isnan())
        assert torch.equal(o.isinf(), ro.isinf())
        assert torch.equal(o[o.isinf()], ro[ro.isinf()])
        fin = ro.isfinite()
        if dtype == torch.float32:
            torch.testing.assert_close(o[fin], ro[fin], rtol=2e-5,
                                       atol=2e-5)
        else:
            _assert_bf16_close(o[fin], ro[fin])
        assert bool((o[0, :, 1, 11] == float("inf")).all())
        assert bool(o[1, :299, 3, 0].isnan().all()) == causal
        assert bool(o[1, :150, 0, D - 1].isnan().all()) == causal
        assert bool((o[1, 150:, 0, D - 1] == float("inf")).all())


@pytest.mark.parametrize("what", ["mixed dtypes", "last-dim stride",
                                  "float16"])
def test_flash_kernel_refuses_by_name(cuda, what):
    """What no kernel takes, on the card (every head dim is taken): mixed
    dtypes, a last-dim stride other than 1, float16; refused by name,
    nothing launched."""
    q = torch.zeros(1, 8, 2, 512, device=cuda, dtype=torch.bfloat16)
    k = v = q
    if what == "mixed dtypes":
        k, match = q.float(), "one dtype"
    elif what == "last-dim stride":
        q = torch.zeros(1, 8, 2, 1024, device=cuda,
                        dtype=torch.bfloat16)[..., ::2]
        k = v = q
        match = "last-dim stride of 1"
    else:
        q = k = v = q.half()
        match = "float32 or bfloat16"
    before = fa.flash_launches
    with pytest.raises(ValueError, match=match):
        fa.flash_fwd(q, k, v, 1.0, True)
    assert fa.flash_launches == before


def test_flash_attention_gradients_on_the_card_match_the_cpu(cuda):
    """The kernel forward with the torch-op backward against the plain
    forward with the same backward on the CPU, through a loss that
    consumes the logsumexp."""
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.RandomState(3)
    arrays = [rng.randn(2, 200, 4, 32).astype(np.float32) for _ in range(4)]
    grads = {}
    for dev in ("cpu", cuda):
        q, k, v = (torch.from_numpy(a).to(dev).requires_grad_(True)
                   for a in arrays[:3])
        o, lse = fa.flash_attention_with_lse(q, k, v, causal=True)
        w = torch.from_numpy(arrays[3]).to(dev)
        ((o * w).sum() + lse.square().sum()).backward()
        grads[str(dev)] = [t.grad.cpu() for t in (q, k, v)]
    for got, want in zip(grads["cuda"], grads["cpu"]):
        torch.testing.assert_close(got, want, rtol=5e-4, atol=5e-5)


def test_tensor_core_forward_gradients_match_the_plain_forward(cuda,
                                                               monkeypatch):
    """bfloat16 at the model's layout: the tensor-core forward with the
    chunked backward against the plain forward with the same backward,
    both on the card, through a loss that consumes the logsumexp. The
    two forwards' o each round once to bfloat16 (at most one spacing
    apart), which moves delta = rowsum(g * o) in the backward, and the
    gradients round to bfloat16 at the end: each gradient within two
    bfloat16 spacings (rtol 2^-6) plus 1% of its largest magnitude."""
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.RandomState(5)
    x = rng.randn(2, 256, 3 * 4 * 64).astype(np.float32)
    w = torch.from_numpy(rng.randn(2, 256, 4, 64).astype(np.float32)).to(
        cuda)
    grads = {}
    for route in ("tc", "plain"):
        if route == "plain":
            monkeypatch.setattr(fa, "flash_fwd", fa.flash_fwd_ref)
        xt = torch.from_numpy(x).to(cuda, torch.bfloat16).requires_grad_(True)
        q, k, v = (c.view(2, 256, 4, 64) for c in xt.chunk(3, dim=-1))
        before = fa.flash_tc_launches
        o, lse = fa.flash_attention_with_lse(q, k, v, causal=True)
        assert fa.flash_tc_launches - before == int(route == "tc")
        ((o.float() * w).sum() + lse.square().sum()).backward()
        grads[route] = xt.grad.float()
    got, want = grads["tc"], grads["plain"]
    torch.testing.assert_close(got, want, rtol=2.0 ** -6,
                               atol=0.01 * float(want.abs().max()))
