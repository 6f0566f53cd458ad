"""Helpers shared by the port's lifecycle tests (checkpoints, supervisor,
preemption, host chaos, telemetry): a small CPU trainer, the CLI's
synthetic command line, and bitwise fingerprints of a state or of a
checkpoint file."""
import hashlib
import io
import os

import torch

from fedtorch_tpu_torch import config as tcfg
from fedtorch_tpu_torch.algorithms import make_algorithm
from fedtorch_tpu_torch.core.state import tree_leaves
from fedtorch_tpu_torch.data import build_federated_data
from fedtorch_tpu_torch.models import define_model
from fedtorch_tpu_torch.parallel import FederatedTrainer
from fedtorch_tpu_torch.utils.checkpoint import _unframe_payload

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def make_trainer(num_clients=6, plane="device", fault=None, ckpt=None,
                 arch="logistic_regression", **fed):
    """A synthetic trainer on the CPU: ``num_clients`` clients, half
    online, 2 local steps of batch 8."""
    cfg = tcfg.ExperimentConfig(
        data=tcfg.DataConfig(dataset="synthetic", synthetic_dim=10,
                             batch_size=8, data_plane=plane),
        federated=tcfg.FederatedConfig(
            federated=True, num_clients=num_clients, num_comms=4,
            online_client_rate=0.5, algorithm="fedavg",
            sync_type="local_step", **fed),
        model=tcfg.ModelConfig(arch=arch, mlp_hidden_size=16),
        optim=tcfg.OptimConfig(lr=0.1, weight_decay=0.0,
                               in_momentum=True),
        train=tcfg.TrainConfig(local_step=2),
        fault=tcfg.FaultConfig(**(fault or {})),
        checkpoint=tcfg.CheckpointConfig(**(ckpt or {})),
    ).finalize()
    data = build_federated_data(cfg)
    model = define_model(cfg, batch_size=cfg.data.batch_size, device="cpu")
    trainer = FederatedTrainer(cfg, model, make_algorithm(cfg), data.train,
                               device="cpu")
    trainer.stream_timeout_s = 20.0
    return trainer


def cli_argv(run_dir, rounds=4, arch="mlp", extra=()):
    """The port's (and the JAX package's) synthetic command line."""
    return ["-f", "true", "-d", "synthetic", "-a", arch, "--num_workers",
            "6", "--online_client_rate", "0.5", "--federated_sync_type",
            "local_step", "--local_step", "2", "-b", "8", "--lr", "0.1",
            "--in_momentum", "true", "--mlp_hidden_size", "16",
            "--num_comms", str(rounds), "--eval_freq", "1", "--debug",
            "false", "--run_dir", str(run_dir)] + list(extra)


def state_digest(server, clients=None) -> str:
    """sha256 over the server's tensors (params, opt, aux), its round
    and generator state, and (given) every client tensor."""
    h = hashlib.sha256()
    for t in tree_leaves((server.params, server.opt, server.aux)):
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    h.update(str(int(server.round)).encode())
    h.update(server.rng.get_state().numpy().tobytes())
    if clients is not None:
        for t in tree_leaves(clients):
            h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def load_payload(path) -> dict:
    with open(path, "rb") as f:
        data, bad = _unframe_payload(f.read())
    assert bad is None, (path, bad)
    return torch.load(io.BytesIO(data), weights_only=True)


def _plain_leaves(tree):
    if isinstance(tree, dict):
        for k in tree:
            yield from _plain_leaves(tree[k])
    elif isinstance(tree, list):
        for v in tree:
            yield from _plain_leaves(v)
    elif isinstance(tree, torch.Tensor):
        yield tree


def file_digest(path, with_clients=False) -> str:
    """:func:`state_digest` of the state a checkpoint file holds."""
    state = load_payload(path)
    s = state["server"]
    h = hashlib.sha256()
    for t in _plain_leaves([s["params"], s["opt"], s["aux"]]):
        h.update(t.contiguous().numpy().tobytes())
    h.update(str(int(s["round"])).encode())
    h.update(s["rng_state"].numpy().tobytes())
    if with_clients:
        for t in _plain_leaves(state["clients"]):
            h.update(t.contiguous().numpy().tobytes())
    return h.hexdigest()


def keep_digests(run_dir, with_clients=True) -> dict:
    """{round: digest} of every per-round keep in ``run_dir``."""
    out = {}
    for name in os.listdir(run_dir):
        if name.startswith("checkpoint_r") and name.endswith(".ckpt"):
            out[int(name[len("checkpoint_r"):-len(".ckpt")])] = \
                file_digest(os.path.join(run_dir, name), with_clients)
    return dict(sorted(out.items()))


def child_env():
    """A child process's environment: the repo on the path, torch at
    two threads (as ``torch_threads`` pins the test processes)."""
    env = dict(os.environ, OMP_NUM_THREADS="2")
    env["PYTHONPATH"] = os.pathsep.join([REPO, env.get("PYTHONPATH", "")])
    return env
