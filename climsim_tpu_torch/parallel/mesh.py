"""Process groups, device meshes and data-parallel helpers.

Counterpart of ``climsim_tpu/parallel/mesh.py``. JAX runs one controller
over a ``jax.sharding.Mesh`` of named axes and lets XLA insert the
collectives; PyTorch runs one process per device (torchrun's ranks) over a
``torch.distributed.device_mesh.DeviceMesh`` with named dimensions, and
the collectives are explicit. Axis names follow the JAX package:

  'data'     batch/column data parallelism
  'ensemble' model-replica axis for ensembles
  'col'      latitude bands of the proxy grid with halo exchange

Every rank runs the same code: a function here that JAX applies to a
global array takes, on each rank, what that rank holds.
"""
from __future__ import annotations

import os

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ..ops import resolve_device


def local_device(device=None) -> torch.device:
    """This rank's device: ``cuda:{LOCAL_RANK}`` for ``device=None`` or
    ``"cuda"`` (raising without a card), else ``device``."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    return dev


def init_distributed(init_method: str | None = None,
                     world_size: int | None = None, rank: int | None = None,
                     device=None) -> tuple[int, int]:
    """Join (or create) the default process group; returns (rank,
    world_size).

    Reads torchrun's environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``
    and ``MASTER_ADDR``/``MASTER_PORT``) unless ``init_method`` with
    ``world_size`` and ``rank`` is given. Without either, a one-rank group
    is made in this process, so one process runs the same code path. The
    backend is NCCL on the card (``device=None`` or ``"cuda"``, after
    ``torch.cuda.set_device(local_rank)``) and gloo for ``device="cpu"``.
    Where the default group exists already, returns its rank and size."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    dev = local_device(device)
    env = os.environ
    if rank is None:
        rank = int(env.get("RANK", 0))
    if world_size is None:
        world_size = int(env.get("WORLD_SIZE", 1))
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if init_method is None and "MASTER_ADDR" in env and "MASTER_PORT" in env:
        init_method = "env://"
    if init_method is not None:
        dist.init_process_group(backend, init_method=init_method,
                                world_size=world_size, rank=rank)
    elif world_size == 1:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)
    else:
        raise ValueError(f"world_size {world_size} without torchrun's "
                         "MASTER_ADDR/MASTER_PORT: pass init_method")
    return dist.get_rank(), dist.get_world_size()


def _device_type() -> str:
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_global_mesh(axes: dict[str, int] | None = None) -> DeviceMesh:
    """A mesh over all ranks. ``axes``: name -> size, their product the
    world size; by default one 'data' axis."""
    world = dist.get_world_size()
    if axes is None:
        axes = {"data": world}
    n = 1
    for size in axes.values():
        n *= size
    if n != world:
        raise ValueError(f"mesh {axes} holds {n} ranks, the world {world}")
    return init_device_mesh(_device_type(), tuple(axes.values()),
                            mesh_dim_names=tuple(axes))


def make_mesh(n_devices: int | None = None, axis: str = "data") -> DeviceMesh:
    """A one-axis mesh named ``axis`` over every rank; ``n_devices``, where
    given, must be the world size (each rank is one device)."""
    world = dist.get_world_size()
    if n_devices is not None and n_devices != world:
        raise ValueError(f"n_devices {n_devices}: the world has {world} "
                         "ranks, one device each")
    return make_global_mesh({axis: world})


def make_mesh_2d(n_data: int, n_ens: int) -> DeviceMesh:
    """A (data, ensemble) mesh of n_data x n_ens ranks."""
    return make_global_mesh({"data": n_data, "ensemble": n_ens})


def axis_rank(mesh: DeviceMesh, axis: str) -> tuple[int, int]:
    """(this rank's index along ``axis``, the axis's size)."""
    return (mesh.get_local_rank(axis),
            mesh.size(mesh.mesh_dim_names.index(axis)))


def shard_batch(mesh: DeviceMesh, *arrays, axis: str = "data"):
    """This rank's equal block of each array's leading dimension (every
    rank holds the global arrays)."""
    idx, n = axis_rank(mesh, axis)
    out = []
    for a in arrays:
        if a.shape[0] % n:
            raise ValueError(f"leading dimension {a.shape[0]} does not "
                             f"divide over {n} ranks of '{axis}'")
        b = a.shape[0] // n
        out.append(a[idx * b:(idx + 1) * b])
    return out[0] if len(out) == 1 else tuple(out)


def _tensors(tree):
    if isinstance(tree, torch.nn.Module):
        yield from tree.parameters()
        yield from tree.buffers()
    elif isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def replicate(mesh: DeviceMesh, tree):
    """Broadcast every tensor of ``tree`` (a module, a state dict, or
    nested dicts, lists and tuples of tensors) in place from the mesh's
    first rank to all; returns ``tree``."""
    src = int(mesh.mesh.flatten()[0])
    with torch.no_grad():
        for t in _tensors(tree):
            dist.broadcast(t.data, src=src)
    return tree


def data_parallel_step(model: torch.nn.Module, optimizer, loss_fn,
                       mesh: DeviceMesh, axis: str = "data"):
    """Wrap ``model``, its ``optimizer`` and ``loss_fn(prediction, y)`` as
    ``step(x_local, y_local) -> loss``: forward and backward on this rank's
    block of the batch, every gradient all-reduced to its mean over
    ``axis`` (the psum JAX's sharded jit inserts; one collective for all
    gradients and the loss), then the optimizer's step. Returns the global
    mean loss. The parameters start equal on every rank (``replicate``) and
    stay so. The reduction follows the backward rather than DDP's hooks,
    so it composes with ``torch.utils.checkpoint``."""
    group = mesh.get_group(axis)
    params = [p for p in model.parameters() if p.requires_grad]

    def step(x_local, y_local):
        optimizer.zero_grad()
        loss = loss_fn(model(x_local), y_local)
        loss.backward()
        loss = all_reduce_mean_(params, loss.detach(), group)
        optimizer.step()
        return loss

    return step


def all_reduce_mean_(params, loss: torch.Tensor, group) -> torch.Tensor:
    """Average the gradients of ``params`` (those that have one; every
    rank has the same set) and ``loss`` over the ranks of ``group`` in one
    ``all_reduce``; the gradients are replaced in place. Returns the mean
    loss."""
    grads = [p.grad for p in params if p.grad is not None]
    flat = torch.cat([g.reshape(-1) for g in grads]
                     + [loss.reshape(1).to(grads[0].dtype)])
    dist.all_reduce(flat, group=group)
    flat /= dist.get_world_size(group)
    off = 0
    for p in params:
        if p.grad is not None:
            n = p.grad.numel()
            p.grad = flat[off:off + n].view_as(p.grad)
            off += n
    return flat[-1]
