"""A one-axis mesh over the processes of ``torch.distributed`` and the
sharding helpers (port of ``parallel/mesh.py``).

The JAX package shards arrays over a named device mesh and lets XLA insert
the collectives; here each process holds one card, the mesh is its (rank,
world size) pair on one named axis (``dp`` by default: env data
parallelism; the weak-scaling script names it ``s`` and shards the samples
axis of ``[E, S, H+1, A]``), and the collectives are explicit:
:func:`shard_batch` keeps this rank's contiguous slice of every tensor
whose sharded axis has the batch size, :func:`replicate` broadcasts every
tensor from rank 0 and :func:`gather_batch` all-gathers slices back along
the axis.  Without a process group the mesh is one process and the helpers
only move tensors to its device.

The reductions of data-parallel training, JAX's ``pmean`` / ``psum`` over
the mesh axis inside ``shard_map``: :func:`pmean` and :func:`all_sum` reduce
a list of tensors with one ``all_reduce`` of one flat buffer.  They run the
collective whenever a process group is up, a world of one included, and
return their input unchanged only on a one-process mesh without a group.  A
collective that fails raises.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Callable, List, Optional, Sequence

import torch
import torch.distributed as dist

from ..utils.device import resolve_device


@dataclass(frozen=True)
class Mesh:
    axis_name: str
    rank: int
    size: int
    device: torch.device


def make_mesh(n_devices: Optional[int] = None, axis_name: str = "dp", device="cuda") -> Mesh:
    """The mesh of every process of the group (``n_devices``, if given,
    must be the world size: one card per process)."""
    size = dist.get_world_size() if dist.is_initialized() else 1
    if n_devices is not None and n_devices != size:
        raise ValueError(f"a mesh of {n_devices} devices needs a world of {n_devices} processes "
                         f"(one card each), not {size}")
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return Mesh(axis_name, dist.get_rank() if dist.is_initialized() else 0, size, dev)


def _map(fn: Callable[[torch.Tensor], torch.Tensor], tree: Any) -> Any:
    """``fn`` over the tensors of nested dicts, lists, tuples and
    dataclasses; other values pass through."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        items = [_map(fn, v) for v in tree]
        return type(tree)(*items) if hasattr(tree, "_fields") else type(tree)(items)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{f.name: _map(fn, getattr(tree, f.name))
                                            for f in dataclasses.fields(tree) if f.init})
    return tree


def shard_batch(tree: Any, mesh: Mesh, batch_size: int, axis: int = 0) -> Any:
    """This rank's slice of every tensor whose ``axis`` has ``batch_size``
    entries (the batch, divided evenly over the mesh); the other tensors
    whole.  All on the mesh's device."""
    if batch_size % mesh.size:
        raise ValueError(f"batch {batch_size} does not divide over {mesh.size} processes")
    n = batch_size // mesh.size

    def place(x):
        x = x.to(mesh.device)
        if x.dim() > axis and x.shape[axis] == batch_size:
            return x.narrow(axis, mesh.rank * n, n).contiguous()
        return x
    return _map(place, tree)


def replicate(tree: Any, mesh: Mesh) -> Any:
    """Every tensor of ``tree`` as rank 0 holds it, on every rank."""
    def bcast(x):
        x = x.to(mesh.device).clone()
        if mesh.size > 1:
            dist.broadcast(x, src=0)
        return x
    return _map(bcast, tree)


def gather_batch(x: torch.Tensor, mesh: Mesh, axis: int = 0) -> torch.Tensor:
    """The ranks' slices of ``x`` concatenated along ``axis`` in rank order
    (the inverse of :func:`shard_batch` for one tensor)."""
    if mesh.size == 1:
        return x
    parts = [torch.empty_like(x) for _ in range(mesh.size)]
    dist.all_gather(parts, x.contiguous())
    return torch.cat(parts, dim=axis)


def _group_up(mesh: Mesh) -> bool:
    """Whether the reductions run a collective: a process group is up (over
    the whole world, which must be the mesh)."""
    if not dist.is_initialized():
        if mesh.size != 1:
            raise RuntimeError(f"a mesh of {mesh.size} processes without a process group")
        return False
    if dist.get_world_size() != mesh.size:
        raise RuntimeError(f"a mesh of {mesh.size} processes in a world of "
                           f"{dist.get_world_size()}")
    return True


def _all_reduce(tensors: Sequence[torch.Tensor], mesh: Mesh, divide: bool) -> List[torch.Tensor]:
    tensors = list(tensors)
    if not tensors or not _group_up(mesh):
        return tensors
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM)
    if divide:
        flat = flat / mesh.size
    parts = torch.split(flat, [t.numel() for t in tensors])
    return [p.view(t.shape).to(t.dtype) for p, t in zip(parts, tensors)]


def pmean(tensors: Sequence[torch.Tensor], mesh: Mesh) -> List[torch.Tensor]:
    """The mean over the mesh's processes of each tensor (JAX's
    ``lax.pmean``): one ``all_reduce`` of their concatenation, divided by
    the world size."""
    return _all_reduce(tensors, mesh, divide=True)


def all_sum(tensors: Sequence[torch.Tensor], mesh: Mesh) -> List[torch.Tensor]:
    """The sum over the mesh's processes of each tensor (``lax.psum``), in
    one ``all_reduce``."""
    return _all_reduce(tensors, mesh, divide=False)


def broadcast_object(obj: Any, mesh: Mesh) -> Any:
    """Rank 0's picklable ``obj`` on every rank (the others' is ignored)."""
    if not _group_up(mesh):
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]
