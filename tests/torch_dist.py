"""Spawned gloo process groups for the port's model-parallel tests.

:class:`Group` starts ``world`` processes (``spawn``), each at one torch
thread, joined through a ``FileStore`` in a directory the test gives
(never a fixed TCP port: the suite's workers run at once) with a 60 s
collective timeout, so that a hung collective fails instead of hanging
the suite. Each process runs every case in order and sends back its
results as numpy; a case that raises sends its traceback, and only its
test fails. ``Group.result(name)`` waits for the processes (at most
``JOIN_S``) and gives the case's result on each rank.

A case is ``(name, function, kwargs)``: a function of this module called
as ``function(mesh_of, **kwargs)``, ``mesh_of(shape, names)`` giving the
``DeviceMesh`` (made once per process). This module imports torch and
the port only, so that a spawned process starts quickly.
"""
import datetime
import multiprocessing
import os
import traceback

import numpy as np
import torch

COLLECTIVE_TIMEOUT_S = 60
JOIN_S = 300


def _numpy(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    if isinstance(x, dict):
        return {k: _numpy(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_numpy(v) for v in x]
    return x


def _worker(rank, world, store_path, cases, queue):
    torch.set_num_threads(1)
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    out = {}
    try:
        dist.init_process_group(
            "gloo", store=dist.FileStore(store_path, world), rank=rank,
            world_size=world,
            timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))
        meshes = {}

        def mesh_of(shape, names):
            key = (tuple(shape), tuple(names))
            if key not in meshes:
                meshes[key] = init_device_mesh("cpu", tuple(shape),
                                               mesh_dim_names=tuple(names))
            return meshes[key]

        for name, fn, kwargs in cases:
            try:
                out[name] = ("ok", _numpy(globals()[fn](mesh_of, **kwargs)))
            except Exception:  # reported as this case's failure
                out[name] = ("error", traceback.format_exc())
    except Exception:  # the group did not form: every case fails
        out = {name: ("error", traceback.format_exc())
               for name, _, _ in cases}
    finally:
        queue.put((rank, out))
        if dist.is_initialized():
            dist.destroy_process_group()


class Group:
    """``world`` spawned ranks running ``cases`` (started at once)."""

    def __init__(self, world, cases, store_dir):
        ctx = multiprocessing.get_context("spawn")
        self.world, self.queue = world, ctx.Queue()
        store = os.path.join(str(store_dir), f"store_{world}")
        self.procs = [ctx.Process(target=_worker,
                                  args=(r, world, store, cases, self.queue),
                                  daemon=True) for r in range(world)]
        for p in self.procs:
            p.start()
        self.results = None

    def _collect(self):
        """Every rank's results; a rank that died without sending them
        fails every case at once instead of after ``JOIN_S``."""
        import queue
        import time
        results, deadline = {}, time.monotonic() + JOIN_S
        try:
            while len(results) < self.world:
                try:
                    rank, out = self.queue.get(timeout=1.0)
                    results[rank] = out
                    continue
                except queue.Empty:
                    pass
                dead = [r for r, p in enumerate(self.procs)
                        if r not in results and p.exitcode is not None]
                if dead or time.monotonic() > deadline:
                    why = f"rank(s) {dead} exited without results" if dead \
                        else f"no results within {JOIN_S} s"
                    for r in range(self.world):
                        results.setdefault(r, {})
                    self.failure = why
                    break
        finally:
            self.close()
        return results

    def close(self):
        for p in self.procs:
            p.join(timeout=10)
            if p.is_alive():
                p.kill()
                p.join()

    def result(self, name):
        """The case's results, one a rank; raises with the first rank's
        traceback if the case failed."""
        if self.results is None:
            self.results = self._collect()
        per_rank = [self.results[r].get(
            name, ("error", getattr(self, "failure", "no result")))
            for r in range(self.world)]
        for status, value in per_rank:
            if status == "error":
                raise AssertionError(f"case {name} failed:\n{value}")
        return [value for _, value in per_rank]


# -- the cases ---------------------------------------------------------------

def _rows(a, rank, n):
    rows = a.shape[1] // n
    return torch.from_numpy(np.ascontiguousarray(
        a[:, rank * rows:(rank + 1) * rows]))


def _model(kwargs, params):
    from fedtorch_tpu_torch.models.transformer import TransformerLM
    module = TransformerLM(**kwargs)
    return module, {k: torch.from_numpy(v) for k, v in params.items()}


def attention(mesh_of, world, q, k, v, strategy, causal, block_impl,
              grad=False):
    """ring_attention or ulysses_attention on this rank's rows; with
    ``grad`` also the gradients of sum(out ** 2) over every rank."""
    from fedtorch_tpu_torch.parallel import ring_attention, ulysses_attention
    mesh = mesh_of((world,), ("sp",))
    rank = mesh.get_local_rank("sp")
    qkv = [_rows(t, rank, world).requires_grad_(grad) for t in (q, k, v)]
    fn = ring_attention if strategy == "ring" else ulysses_attention
    out = fn(*qkv, mesh, causal=causal, block_impl=block_impl)
    if not grad:
        return out
    grads = torch.autograd.grad(out.square().sum(), qkv)
    return [out, *grads]


def refusal(mesh_of, case, **kwargs):
    """The message of the ValueError that case ``case`` raises."""
    try:
        globals()[case](mesh_of, **kwargs)
    except ValueError as e:
        return str(e)
    raise AssertionError(f"{case} did not raise")


def long_context(mesh_of, world, model, params, tokens, strategy,
                 block_impl, grad=False):
    """long_context_apply's logits; with ``grad`` the gradients of the
    mean next-token cross-entropy."""
    from fedtorch_tpu_torch.core.losses import softmax_cross_entropy
    from fedtorch_tpu_torch.models.transformer import long_context_apply
    module, p = _model(model, params)
    p = {k: v.requires_grad_(grad) for k, v in p.items()}
    toks = torch.from_numpy(tokens)
    logits = long_context_apply(module, p, toks, mesh_of((world,), ("sp",)),
                                strategy=strategy, block_impl=block_impl)
    if not grad:
        return logits
    loss = softmax_cross_entropy(logits, torch.roll(toks, -1, dims=1))
    return dict(zip(p, torch.autograd.grad(loss, list(p.values()))))


def expert(mesh_of, world, params, x, capacity_factor):
    from fedtorch_tpu_torch.parallel import ep_moe_apply
    return ep_moe_apply({k: torch.from_numpy(v) for k, v in params.items()},
                        torch.from_numpy(x), mesh_of((world,), ("ep",)),
                        capacity_factor=capacity_factor)


def tensor(mesh_of, world, model, params, tokens, dp=False):
    """tp_apply on a 1-D ``tp`` mesh, or (``dp``) a ``(2, world/2)``
    ``(dp, tp)`` mesh, with the specs it applied."""
    from fedtorch_tpu_torch.parallel import tp_apply, transformer_tp_specs
    module, p = _model(model, params)
    mesh = mesh_of((2, world // 2), ("dp", "tp")) if dp \
        else mesh_of((world,), ("tp",))
    out = tp_apply(module, p, torch.from_numpy(tokens), mesh,
                   dp_axis="dp" if dp else None)
    specs = transformer_tp_specs(p, mesh=mesh)
    return dict(out=out, specs={k: str(s) for k, s in specs.items()})


def pipeline(mesh_of, world, model, params, tokens, num_microbatches):
    from fedtorch_tpu_torch.parallel import pipeline_apply
    module, p = _model(model, params)
    return pipeline_apply(module, p, torch.from_numpy(tokens),
                          mesh_of((world,), ("pp",)),
                          num_microbatches=num_microbatches)


# -- client sharding (parallel/podscale.py) -----------------------------------

def pod_cfg(source, dispatch, shards, *, num_clients=8, rate=0.5,
            store="ram", store_dir="", algorithm="fedavg", buffer_size=4,
            fault_kw=None, telemetry_kw=None, local_step=2, mod=None,
            fed_kw=None, optim_kw=None):
    """The JAX package's ``tests/test_podscale.py`` cell (``make_cfg``):
    synthetic 16 features, ``logistic_regression``, 8 clients at rate
    0.5, batch 8, 2 local steps (``local_step``); in the config module
    ``mod`` (the port's by default, or the JAX package's); ``fed_kw``
    and ``optim_kw`` add federated and optimizer fields."""
    if mod is None:
        from fedtorch_tpu_torch import config as mod
    c = mod
    return c.ExperimentConfig(
        data=c.DataConfig(dataset="synthetic", synthetic_dim=16,
                          batch_size=8, synthetic_alpha=0.5,
                          synthetic_beta=0.5,
                          data_plane="stream" if source == "feed"
                          else "device", store=store, store_dir=store_dir),
        federated=c.FederatedConfig(
            federated=True, num_clients=num_clients,
            online_client_rate=rate, algorithm=algorithm,
            sync_type="local_step",
            sync_mode="async" if dispatch == "commit" else "sync",
            async_buffer_size=buffer_size, async_concurrency=4,
            **(fed_kw or {})),
        model=c.ModelConfig(arch="logistic_regression"),
        optim=c.OptimConfig(**dict(dict(lr=0.3, weight_decay=0.0),
                                   **(optim_kw or {}))),
        train=c.TrainConfig(local_step=local_step),
        mesh=c.MeshConfig(client_shards=shards),
        fault=c.FaultConfig(**(fault_kw or {})),
        telemetry=c.TelemetryConfig(**(telemetry_kw or {}))).finalize()


def pod_trainer(cfg, data=None):
    """The cell's trainer on the CPU (with the validation split where
    the config builds one)."""
    from fedtorch_tpu_torch.algorithms import make_algorithm
    from fedtorch_tpu_torch.data import build_federated_data
    from fedtorch_tpu_torch.models import define_model
    from fedtorch_tpu_torch.parallel import FederatedTrainer
    val = None
    if data is None:
        fed = build_federated_data(cfg)
        data, val = fed.train, fed.val
    model = define_model(cfg, batch_size=cfg.data.batch_size, device="cpu")
    cls = FederatedTrainer
    if cfg.federated.sync_mode == "async":
        from fedtorch_tpu_torch.async_plane import AsyncFederatedTrainer
        cls = AsyncFederatedTrainer
    t = cls(cfg, model, make_algorithm(cfg), data, val_data=val,
            device="cpu")
    t.stream_timeout_s = COLLECTIVE_TIMEOUT_S
    return t


KINDS = ("seam", "exchange", "norms", "cohort", "layout")


def pod_run(trainer, dispatch, rounds=2, seed=3, state=None):
    """``rounds`` rounds (one ``run_rounds`` for 'scan'): the server
    params and aux, the client state (this rank's rows of its trees,
    ``rows``), the metrics, and the collectives each round issued: the
    client-shard seam's, the exchanges, the guards' norm gathers, the
    1-D mesh's cohort gathers and its layout broadcasts."""
    from fedtorch_tpu_torch.parallel import podscale
    server, clients = state if state is not None \
        else trainer.init_state(seed)
    metrics = []
    counts = {kind: [] for kind in KINDS}

    def note(n):
        for kind, c in counts.items():
            c.append(podscale.collective_count(kind) / n)
    try:
        if dispatch == "scan":
            podscale.reset_collective_count()
            server, clients, m = trainer.run_rounds(server, clients, rounds)
            metrics.append(m)
            note(rounds)
        else:
            for _ in range(rounds):
                podscale.reset_collective_count()
                server, clients, m = trainer.run_round(server, clients)
                metrics.append(m)
                note(1)
        gauges = trainer.telemetry_gauges()
    finally:
        trainer.invalidate_stream()
    return dict(params=server.params, aux=server.aux, clients=clients,
                metrics=metrics, collectives=counts["seam"],
                exchanges=counts["exchange"], norm_gathers=counts["norms"],
                cohort_gathers=counts["cohort"], layouts=counts["layout"],
                gauges=gauges, rng=server.rng.get_state(),
                rows=list(trainer.client_rows),
                block=list(trainer.cohort_rows(trainer.cohort_width)))


def podscale_cell(mesh_of, source, dispatch, shards, algorithm="fedavg",
                  fault_kw=None, local_step=2):
    """A cell at S=``shards`` and its armed S=1 twin on every rank."""
    kw = dict(algorithm=algorithm, fault_kw=fault_kw, local_step=local_step)
    got = pod_run(pod_trainer(pod_cfg(source, dispatch, shards, **kw)),
                  dispatch)
    twin = pod_run(pod_trainer(pod_cfg(source, dispatch, 1, **kw)),
                   dispatch)
    return dict(got=got, twin=twin)


def podscale_sum(mesh_of, shards, k, seed):
    """cohort_hierarchical_sum of a float and an integer leaf over this
    rank's rows (riders too), and over all k rows in one process."""
    from fedtorch_tpu_torch.config import MeshConfig
    from fedtorch_tpu_torch.parallel.mesh import local_cohort_rows, make_mesh
    from fedtorch_tpu_torch.parallel.podscale import (
        cohort_hierarchical_sum, gathered_bytes, reset_collective_count,
    )
    rng = np.random.RandomState(seed)
    payloads = {"w": torch.from_numpy(
        (rng.randn(k, 5, 3) * 10.0 ** rng.uniform(-3, 3, (k, 1, 1))
         ).astype(np.float32)),
        "n": torch.from_numpy(rng.randint(0, 9, (k,)).astype(np.int32))}
    riders = {"loss": torch.from_numpy(rng.randn(k).astype(np.float32)),
              "step": torch.arange(k, dtype=torch.int64)}
    mesh = make_mesh(MeshConfig(client_shards=shards))
    lo, hi = local_cohort_rows(mesh, k, shards)
    reset_collective_count()
    got, ride = cohort_hierarchical_sum(
        {n: v[lo:hi] for n, v in payloads.items()}, mesh, shards,
        {n: v[lo:hi] for n, v in riders.items()})
    return dict(got=got, ride=ride, twin=cohort_hierarchical_sum(payloads),
                riders=riders, rows=[lo, hi], gathered=gathered_bytes())


def podscale_save(mesh_of, store_dir):
    """2 rounds at S=2 and a checkpoint of them into ``store_dir``'s
    ``ckpt_s2``, and by the async writer into ``ckpt_s2_async`` (every
    rank joins each gather, rank 0 writes)."""
    import torch.distributed as dist
    from fedtorch_tpu_torch.utils.checkpoint import (
        AsyncCheckpointer, save_checkpoint,
    )
    cfg = pod_cfg("resident", "round", 2)
    t = pod_trainer(cfg)
    server, clients = t.init_state(7)
    for _ in range(2):
        server, clients, _ = t.run_round(server, clients)
    save_checkpoint(os.path.join(str(store_dir), "ckpt_s2"), server,
                    clients, cfg, 0.5, False)
    writer = AsyncCheckpointer()
    writer.save(os.path.join(str(store_dir), "ckpt_s2_async"), server,
                clients, cfg, 0.5, False)
    writer.close()
    dist.barrier()
    return dict(rows=list(t.client_rows))


def podscale_supervisor(mesh_of):
    """The supervisor's snapshot at S=2 before a round and its rollback
    after it: this rank's client rows before, after the round and after
    the rollback, and the local rows the snapshot saved."""
    from fedtorch_tpu_torch.core.state import tree_map
    from fedtorch_tpu_torch.robustness.supervisor import RoundSupervisor
    t = pod_trainer(pod_cfg("resident", "round", 2))
    server, clients = t.init_state(3)
    server, clients, _ = t.run_round(server, clients)

    def copy(c):
        return _numpy(tree_map(torch.clone, c))
    before = copy(clients)
    sup = RoundSupervisor(t)
    snap = sup._snapshot(server, clients)
    after_round, clients, _ = t.run_round(server, clients)
    changed = copy(clients)
    _, clients = sup._restore(snap, after_round, clients)
    return dict(before=before, changed=changed, after=copy(clients),
                saved=[idx for idx, _ in snap.rows],
                rows=list(t.client_rows))


def podscale_resume(mesh_of, store_dir):
    """2 rounds at S=4, a checkpoint (rank 0 writes), 2 rounds resumed at
    S=2 on the same 4 ranks; the S=1 run of 4 rounds; and which ranks'
    own checkpoint calls wrote a file."""
    import torch.distributed as dist
    from fedtorch_tpu_torch.utils.checkpoint import (
        maybe_resume, save_checkpoint,
    )
    ref = pod_run(pod_trainer(pod_cfg("resident", "round", 1)), "round",
                  rounds=4, seed=7)
    cfg4 = pod_cfg("resident", "round", 4)
    t4 = pod_trainer(cfg4)
    server, clients = t4.init_state(7)
    for _ in range(2):
        server, clients, _ = t4.run_round(server, clients)
    shared = os.path.join(str(store_dir), "ckpt")
    save_checkpoint(shared, server, clients, cfg4, 0.25, False)
    own = os.path.join(str(store_dir), f"own{dist.get_rank()}")
    save_checkpoint(own, server, clients, cfg4, 0.25, False)
    dist.barrier()
    cfg2 = pod_cfg("resident", "round", 2)
    t2 = pod_trainer(cfg2)
    s2, c2 = t2.init_state(1)
    s2, c2, best, resumed = maybe_resume(shared, s2, c2, cfg2, None)
    got = pod_run(t2, "round", rounds=2, state=(s2, c2))
    return dict(ref=ref, got=got, resumed=resumed, best=best,
                shards=t2.client_shards, wrote=os.path.exists(own))


def podscale_torn(mesh_of, store_dir):
    """Per-rank packing from an mmap store whose x shards tear: the
    failure chain's messages; then, healed, 2 rounds against an
    untouched twin."""
    import torch.distributed as dist
    from fedtorch_tpu_torch.data import build_federated_data
    from fedtorch_tpu_torch.data.streaming import save_client_store
    from fedtorch_tpu_torch.robustness.host_recovery import HostSeamError
    root = os.path.join(str(store_dir), "torn")
    cfg = pod_cfg("feed", "round", 2, store="mmap", store_dir=root,
                  fault_kw=dict(host_retry_backoff_s=0.0))
    data = build_federated_data(cfg).train
    if dist.get_rank() == 0:
        save_client_store(root, data, clients_per_shard=3)
    dist.barrier()
    ref = pod_run(pod_trainer(cfg, data), "round", seed=5)
    t = pod_trainer(cfg, data)
    rows = t.cohort_rows(t.k_dispatch)
    server, clients = t.init_state(5)
    paths = sorted(p for p in os.listdir(root) if p.startswith("x."))
    whole = {p: open(os.path.join(root, p), "rb").read() for p in paths}
    dist.barrier()
    if dist.get_rank() == 0:
        for p, b in whole.items():
            with open(os.path.join(root, p), "wb") as f:
                f.write(b[:16])
    dist.barrier()
    chain, seam = [], None
    try:
        for _ in range(3):
            server, clients, _ = t.run_round(server, clients)
    except HostSeamError as e:
        seam, exc = e.seam, e
        while exc is not None:
            chain.append(str(exc))
            exc = exc.__cause__
    dist.barrier()
    if dist.get_rank() == 0:
        for p, b in whole.items():
            with open(os.path.join(root, p), "wb") as f:
                f.write(b)
    dist.barrier()
    t.invalidate_stream()
    got = pod_run(t, "round", state=(server, clients))
    return dict(ref=ref, got=got, seam=seam, chain=" | ".join(chain),
                rows=list(rows), rank=dist.get_rank())


# -- the 1-D mesh (client_shards 0 on several ranks) -------------------------

def flat_cell(mesh_of, source, dispatch, rounds=2, seed=3, **kw):
    """A cell at ``client_shards`` 0 on this group's ranks (``kw``:
    :func:`pod_cfg`'s): what :func:`pod_run` returns."""
    return pod_run(pod_trainer(pod_cfg(source, dispatch, 0, **kw)),
                   dispatch, rounds=rounds, seed=seed)


def flat_cell_s1(mesh_of, source, dispatch, **kw):
    """The same cell at ``client_shards`` 1 on this group's ranks."""
    return pod_run(pod_trainer(pod_cfg(source, dispatch, 1, **kw)),
                   dispatch)


def flat_save(mesh_of, store_dir):
    """2 rounds at S=0 and a checkpoint of them into ``store_dir``'s
    ``ckpt_s0`` (every rank joins the gather, rank 0 writes)."""
    import torch.distributed as dist
    from fedtorch_tpu_torch.utils.checkpoint import save_checkpoint
    cfg = pod_cfg("resident", "round", 0)
    t = pod_trainer(cfg)
    server, clients = t.init_state(7)
    for _ in range(2):
        server, clients, _ = t.run_round(server, clients)
    save_checkpoint(os.path.join(str(store_dir), "ckpt_s0"), server,
                    clients, cfg, 0.5, False)
    dist.barrier()
    return dict(rows=list(t.client_rows))


def flat_resume(mesh_of, store_dir):
    """The S=0 checkpoint of :func:`flat_save` (written by the group of
    2 before) resumed at S=2 for 2 rounds."""
    from fedtorch_tpu_torch.utils.checkpoint import maybe_resume
    path = os.path.join(str(store_dir), "ckpt_s0")
    cfg = pod_cfg("resident", "round", 2)
    t = pod_trainer(cfg)
    server, clients = t.init_state(1)
    server, clients, best, resumed = maybe_resume(path, server, clients,
                                                  cfg, None)
    got = pod_run(t, "round", rounds=2, state=(server, clients))
    return dict(got=got, resumed=resumed, best=best)


def flat_refusal(mesh_of, algorithm):
    """What the personal evaluation says on this group's ranks, after a
    round of ``algorithm`` at S=0 (which runs)."""
    from fedtorch_tpu_torch.parallel.evaluate import evaluate_personal
    t = pod_trainer(pod_cfg("resident", "round", 0, algorithm=algorithm))
    server, clients = t.init_state(3)
    server, clients, _ = t.run_round(server, clients)
    try:
        evaluate_personal(t.model, clients.aux, clients.params, t.val_data,
                          algorithm)
    except ValueError as e:
        return str(e)
    raise AssertionError("evaluate_personal ran on several ranks")


def local_sgd_cfg(*, num_clients=4, avg_model=True, reshuffle=False,
                  growing=False, num_epochs=2, local_step=2, mod=None):
    """Local-SGD mode on the JAX package's ``test_mesh_padding.py``
    task: ``logistic_regression`` on 12 synthetic features, batch 10;
    ``growing`` batches of base 2 up to 16 in iteration mode."""
    if mod is None:
        from fedtorch_tpu_torch import config as mod
    c = mod
    data = dict(dataset="synthetic", synthetic_dim=12, batch_size=10,
                reshuffle_per_epoch=reshuffle)
    train = dict(num_epochs=num_epochs, local_step=local_step,
                 avg_model=avg_model)
    if growing:
        data.update(growing_batch_size=True, base_batch_size=2,
                    max_batch_size=16)
        train.update(stop_criteria="iteration", num_iterations=12)
    return c.ExperimentConfig(
        data=c.DataConfig(**data),
        federated=c.FederatedConfig(federated=False,
                                    num_clients=num_clients),
        model=c.ModelConfig(arch="logistic_regression"),
        optim=c.OptimConfig(lr=0.2, weight_decay=0.0),
        train=c.TrainConfig(**train)).finalize()


def local_sgd_data():
    """The pooled synthetic task (4 tasks of 12 features)."""
    from fedtorch_tpu_torch.data.synthetic import generate_synthetic
    d = generate_synthetic(num_tasks=4, alpha=0.0, beta=0.0, num_dim=12)
    return np.concatenate(d.client_x), np.concatenate(d.client_y)


def bridged(trainer, weights):
    """``trainer.init_state`` starting from ``weights`` (the JAX
    package's, flattened by name)."""
    from fedtorch_tpu_torch.bridge import params_from_jax
    init_state = trainer.init_state

    def init(rng):
        server, clients = init_state(rng)
        params = params_from_jax(weights, expect=server.params,
                                 module=trainer.model.module)
        for n, p in clients.params.items():
            p[:] = params[n]
        return server._replace(params=params), clients
    trainer.init_state = init


def flat_replay(mesh_of, weights, plans, **kw):
    """The resident round at ``client_shards`` 0 from ``weights``, each
    round on its injected plan: each round's server params and metrics,
    and this rank's client rows at the end."""
    t = pod_trainer(pod_cfg("resident", "round", 0, **kw))
    bridged(t, weights)
    server, clients = t.init_state(3)
    rounds = []
    for plan in plans:
        server, clients, m = t.round_fn(server, clients, plan)
        rounds.append(dict(params=server.params, metrics=m))
    return dict(rounds=rounds, clients=clients, rows=list(t.client_rows))


def local_sgd_fit(mesh_of, seed=0, plans=None, weights=None, **kw):
    """``build_local_sgd`` -> ``fit`` on this group's ranks (``plans``:
    round r on ``plans[r]``; ``weights``: from these): each round's
    server params, this rank's client rows, the replicated epochs and
    local indices, every round's metrics and the collectives of each
    kind."""
    from fedtorch_tpu_torch.models import define_model
    from fedtorch_tpu_torch.parallel import podscale
    from fedtorch_tpu_torch.parallel.local_sgd import build_local_sgd
    cfg = local_sgd_cfg(**kw)
    feats, labels = local_sgd_data()
    t = build_local_sgd(cfg, define_model(cfg, batch_size=10,
                                          device="cpu"),
                        feats, labels, device="cpu")
    if plans is not None:
        t.draw_plan = lambda server: plans[server.round]
    if weights is not None:
        bridged(t, weights)
    podscale.reset_collective_count()
    steps = []
    server, clients, history = t.fit(seed, callback=lambda s, c, m: (
        steps.append({n: v.clone() for n, v in s.params.items()})))
    return dict(params=server.params, clients=clients, metrics=history,
                steps=steps, rows=list(t.client_rows),
                counts={k: podscale.collective_count(k) for k in KINDS},
                rounds=len(history))
