"""Data parallelism over ``torch.distributed``: one process per card.

Counterpart of ``disentangledcolorization_tpu/parallel/mesh.py``. JAX gets its
data-parallel semantics from a mesh without writing them: parameters
replicated, the batch sharded, gradients averaged by collectives that XLA
inserts, BatchNorm statistics over the global batch, metrics as global means.
The port writes each of them:

* one process per card (torch's idiom; JAX runs one process per host). Rank
  r takes ``cuda:<LOCAL_RANK>``, else ``cuda:<r % device_count>``
  (:func:`rank_device`). Each rank loads ``batch_size`` images a step, so the
  global batch is ``batch_size x world_size``, JAX's ``batch_size x n_dev``;
* :func:`initialize_distributed` joins the process group (NCCL for the card,
  gloo for the CPU, or as the caller says);
* :func:`replicate` broadcasts rank 0's parameters and buffers;
* :func:`all_reduce_gradients` averages the gradients over the ranks, in one
  buffer per dtype;
* ``models/layers.py::BatchNorm`` all-reduces its statistics and their
  gradient sums (:func:`all_reduce_sum`) when the world size is above 1;
* :func:`mean_reduce_metrics` turns per-rank metric means into global means;
* :func:`shard_batch` gives this rank's rows of a global batch (JAX's
  ``shard_batch`` and ``host_local_batch_to_global``: the port's ranks load
  their own rows, so the global batch is never assembled);
* :func:`local_devices` lists the cards a data-parallel ``Colorizer`` or
  ``cli/infer.py`` spreads a batch over (JAX's ``jax.devices()``).

Only ``all_reduce``, ``broadcast`` and ``barrier`` are used: they are the
collectives that gloo offers for CUDA tensors, so two ranks can share one card
over gloo (NCCL refuses two ranks on one device). gloo has no
``ReduceOp.AVG``: means are sums divided by the world size.

JAX's ``make_hierarchical_mesh`` (slices x chips, the all-reduce over ICI
first and DCN after) has no counterpart: NCCL picks its own rings and trees
over NVLink and the network.
"""

from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist


def initialize_distributed(coordinator: str | None = None, num_processes: int | None = None,
                           process_id: int | None = None, backend: str | None = None, device=None,
                           timeout: float | None = None) -> bool:
    """Join the process group (JAX ``initialize_distributed``, ``:21-60``).

    * No coordinator and ``num_processes`` in (None, 1): a single-process
      run; nothing happens and False is returned.
    * Otherwise ``torch.distributed.init_process_group`` at
      ``tcp://<coordinator>`` (a ``host:port``; a URL with ``://``, such as
      ``env://`` under torchrun or ``file://``, is passed as it is; no
      coordinator means ``env://``). A missing ``num_processes`` or
      ``process_id`` is read from torchrun's ``WORLD_SIZE``/``RANK``, and
      raises where those are absent too.

    ``backend`` defaults to NCCL for a CUDA ``device`` (None means the card)
    and gloo for the CPU; ``timeout`` (seconds) bounds the rendezvous and
    every collective. A second call once a group exists is a no-op that
    returns False. Every other failure propagates (a bad address, a rendezvous
    timeout, an id out of range): a swallowed one would strand the job as an
    accidental single-process run. Returns True when this call made the
    group."""
    if coordinator is None and num_processes in (None, 1):
        return False
    if dist.is_initialized():
        return False
    world = num_processes if num_processes is not None else _env_int("WORLD_SIZE", "--num_processes")
    rank = process_id if process_id is not None else _env_int("RANK", "--process_id")
    if not 0 <= rank < world:
        raise ValueError(f"process id {rank} out of range for {world} processes")
    if coordinator is None:
        init_method = "env://"
    else:
        init_method = coordinator if "://" in coordinator else f"tcp://{coordinator}"
    dev = torch.device("cuda" if device is None else device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    kwargs = {} if timeout is None else {"timeout": datetime.timedelta(seconds=timeout)}
    dist.init_process_group(backend, init_method=init_method, world_size=world, rank=rank, **kwargs)
    return True


def _env_int(name: str, flag: str) -> int:
    if name not in os.environ:
        raise ValueError(f"multi-process run without {flag}: pass it, or launch under torchrun (which sets {name})")
    return int(os.environ[name])


def shutdown_distributed() -> None:
    """Leave the process group, if there is one."""
    if dist.is_initialized():
        dist.destroy_process_group()


def world_size() -> int:
    """Ranks in the process group; 1 without one."""
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    """This process's rank; 0 without a group (JAX ``jax.process_index()``)."""
    return dist.get_rank() if dist.is_initialized() else 0


def is_main() -> bool:
    """Rank 0: the process that logs and writes checkpoints."""
    return process_index() == 0


def rank_device(device) -> torch.device:
    """This rank's card: ``device`` as it is unless it is ``cuda`` without an
    index and a group exists; then ``cuda:<LOCAL_RANK>``, or
    ``cuda:<rank % device_count>``. Made the current device."""
    device = torch.device(device)
    if device.type != "cuda" or device.index is not None or not dist.is_initialized():
        return device
    local = os.environ.get("LOCAL_RANK")
    index = int(local) if local is not None else process_index() % torch.cuda.device_count()
    torch.cuda.set_device(index)
    return torch.device("cuda", index)


def local_devices(device) -> list[torch.device]:
    """The devices of this process that data-parallel serving spreads a batch
    over (JAX ``jax.devices()``): every visible card for ``cuda`` without an
    index, else ``device`` alone."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [device]


def barrier() -> None:
    """Wait for every rank; nothing without a group."""
    if dist.is_initialized():
        dist.barrier()


def all_reduce_sum(tensor: torch.Tensor) -> torch.Tensor:
    """Sum ``tensor`` over the ranks, in place; returns it."""
    dist.all_reduce(tensor, op=dist.ReduceOp.SUM)
    return tensor


def shard_batch(batch, rank: int | None = None, world: int | None = None):
    """This rank's rows of a global batch (a tensor or a dict of them):
    rows ``[rank * b, (rank + 1) * b)`` with ``b = n / world``."""
    rank = process_index() if rank is None else rank
    world = world_size() if world is None else world

    def rows(x):
        n = x.shape[0]
        if n % world:
            raise ValueError(f"a global batch of {n} does not split over {world} ranks")
        b = n // world
        return x[rank * b:(rank + 1) * b]

    return {k: rows(v) for k, v in batch.items()} if isinstance(batch, dict) else rows(batch)


def replicate(module: torch.nn.Module) -> torch.nn.Module:
    """Broadcast rank 0's parameters and buffers to every rank, in place
    (JAX ``replicate``); nothing at world size 1."""
    if world_size() > 1:
        with torch.no_grad():
            for t in list(module.parameters()) + list(module.buffers()):
                dist.broadcast(t.data, src=0)
    return module


def _flat_by_dtype(tensors):
    groups: dict = {}
    for t in tensors:
        groups.setdefault(t.dtype, []).append(t)
    return groups.values()


def all_reduce_gradients(params) -> None:
    """Average the ``.grad`` of ``params`` over the ranks: one flat buffer per
    dtype, all-reduced with SUM and divided by the world size, in place.
    Runs whenever a group exists, at world size 1 too (a sum over one rank is
    the identity, bit for bit). Parameters without a gradient are left out;
    which ones have one must be the same on every rank."""
    if not dist.is_initialized():
        return
    world = world_size()
    for grads in _flat_by_dtype([p.grad for p in params if p.grad is not None]):
        flat = torch.cat([g.reshape(-1) for g in grads])
        all_reduce_sum(flat)
        if world > 1:
            flat.div_(world)
        offset = 0
        for g in grads:
            g.copy_(flat[offset:offset + g.numel()].view_as(g))
            offset += g.numel()


def mean_reduce_metrics(metrics: dict) -> dict:
    """Per-rank metric means (0-d tensors) -> global means, in one all-reduce
    (JAX's metrics are global under pjit). The identity at world size 1."""
    world = world_size()
    if world == 1 or not metrics:
        return metrics
    keys = list(metrics)
    flat = all_reduce_sum(torch.stack([metrics[k].detach().float() for k in keys]))
    return dict(zip(keys, flat / world))


def any_rank(flag: bool, device) -> bool:
    """True on every rank when ``flag`` is True on any (a shutdown request
    that must stop all ranks at the same step); ``flag`` at world size 1."""
    if world_size() == 1:
        return bool(flag)
    t = torch.tensor([1.0 if flag else 0.0], device=device)
    return bool(all_reduce_sum(t).item() > 0)
