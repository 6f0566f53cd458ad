"""The port on a CUDA device: kernel against its plain version, and a
small round on the card against the same round on the CPU.

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
    row = n <= qk._MAX_ROW_ELEMS
    assert np.subtract(after, before).tolist() == (
        [1, 0, 0] if row else [0, 1, 1])
    plain = qk.qdq_batch_ref if row else qk.qdq_tiled_ref
    assert torch.equal(got, plain(x.view(1, -1), 8).view(-1))


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
            assert qk.launches - before == 2 * len(
                {v.numel() for v in p0.values()})
        out[str(dev)] = {k: v.cpu() - p0[k]
                         for k, v in server.params.items()}
    for k, u in out["cpu"].items():
        step = float(u.max() - u.min()) / 255.0
        assert float((out["cuda"][k] - u).abs().max()) <= 2 * step + 1e-7
