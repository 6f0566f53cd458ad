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
        results = {}
        try:
            for _ in self.procs:
                rank, out = self.queue.get(timeout=JOIN_S)
                results[rank] = out
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
        per_rank = [self.results[r][name] for r in range(self.world)]
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
