"""Map a function over the tensors of nested dataclasses (the part of
``jax.tree.map`` the port needs)."""
from __future__ import annotations

import dataclasses

import torch


def tree_map(fn, obj, *rest):
    """Apply ``fn`` leaf-wise to ``obj`` (and matching ``rest``).  Leaves are
    tensors; ``None`` stays ``None``; other values pass through."""
    if isinstance(obj, torch.Tensor):
        return fn(obj, *rest)
    if obj is None:
        return None
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        changes = {f.name: tree_map(fn, getattr(obj, f.name), *(getattr(r, f.name) for r in rest))
                   for f in dataclasses.fields(obj)}
        return dataclasses.replace(obj, **changes)
    return obj
