"""Map a function over the tensors of nested dataclasses and tuples, and
flatten such trees (the parts of ``jax.tree`` the port needs)."""
from __future__ import annotations

import dataclasses

import torch


def tree_map(fn, obj, *rest):
    """Apply ``fn`` leaf-wise to ``obj`` (and matching ``rest``).  Leaves are
    tensors; ``None`` stays ``None``; tuples and dataclasses are walked; other
    values pass through (a named tuple keeps its type)."""
    if isinstance(obj, torch.Tensor):
        return fn(obj, *rest)
    if obj is None:
        return None
    if isinstance(obj, tuple):
        items = [tree_map(fn, o, *(r[i] for r in rest)) for i, o in enumerate(obj)]
        return type(obj)(*items) if hasattr(obj, "_fields") else tuple(items)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        changes = {f.name: tree_map(fn, getattr(obj, f.name), *(getattr(r, f.name) for r in rest))
                   for f in dataclasses.fields(obj)}
        return dataclasses.replace(obj, **changes)
    return obj


def tree_flatten(obj):
    """``(leaves, rebuild)``: the tensors of ``obj`` in ``jax.tree.flatten``'s
    order (dict keys sorted, dataclass fields and tuple items in order,
    ``None`` dropped) and a function that rebuilds ``obj``'s structure from
    a list of new leaves."""
    if isinstance(obj, torch.Tensor):
        return [obj], lambda ls: ls[0]
    if obj is None:
        return [], lambda ls: None
    if isinstance(obj, dict):
        keys = sorted(obj)
        parts = [tree_flatten(obj[k]) for k in keys]
    elif isinstance(obj, tuple):
        keys = None
        parts = [tree_flatten(o) for o in obj]
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        keys = [f.name for f in dataclasses.fields(obj)]
        parts = [tree_flatten(getattr(obj, k)) for k in keys]
    else:
        raise TypeError(f"not a tree of tensors: {type(obj).__name__}")
    counts = [len(p[0]) for p in parts]
    leaves = [l for p in parts for l in p[0]]

    def rebuild(ls):
        items, i = [], 0
        for (_, sub), c in zip(parts, counts):
            items.append(sub(ls[i:i + c]))
            i += c
        if isinstance(obj, dict):
            return dict(zip(keys, items))
        if isinstance(obj, tuple):
            return type(obj)(*items) if hasattr(obj, "_fields") else tuple(items)
        return dataclasses.replace(obj, **dict(zip(keys, items)))

    return leaves, rebuild
