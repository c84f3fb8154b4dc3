"""Dataclass configuration system (port of ``utils/config.py``).

Configs are plain mutable dataclasses; robot variants override fields by
assignment or subclassing, like the reference's nested config classes.
"""
from __future__ import annotations

import copy
import dataclasses
from dataclasses import dataclass, field, fields, is_dataclass
from typing import Any, Dict, Type, TypeVar

T = TypeVar("T")


def configclass(cls: Type[T]) -> Type[T]:
    """Dataclass decorator that accepts mutable defaults: list, dict and
    dataclass-instance defaults become deep-copying ``default_factory``s."""
    for name in list(getattr(cls, "__annotations__", {})):
        if name.startswith("_"):
            continue
        default = getattr(cls, name, dataclasses.MISSING)
        if default is dataclasses.MISSING or isinstance(default, type):
            continue
        if isinstance(default, (list, dict, set)) or is_dataclass(default):
            setattr(cls, name, field(default_factory=_make_copier(default)))
    return dataclass(cls)


def _make_copier(value):
    def _copy():
        return copy.deepcopy(value)

    return _copy


def class_to_dict(obj: Any) -> Any:
    """Recursively convert a config to nested dicts, including attributes
    added to an instance by plain assignment (``cfg.rewards.scales.x = 1``)."""
    if is_dataclass(obj) and not isinstance(obj, type):
        out = {f.name: class_to_dict(getattr(obj, f.name)) for f in fields(obj)}
        for k, v in vars(obj).items():
            if k not in out and not k.startswith("_"):
                out[k] = class_to_dict(v)
        return out
    if isinstance(obj, (list, tuple)):
        return type(obj)(class_to_dict(v) for v in obj)
    if isinstance(obj, dict):
        return {k: class_to_dict(v) for k, v in obj.items()}
    return obj


def update_class_from_dict(obj: Any, d: Dict[str, Any]) -> Any:
    """Update a config in place from a nested dict (``class_to_dict``'s
    shape): a dict value updates a nested config group field by field, any
    other value replaces the field; keys the config lacks are skipped."""
    for key, value in d.items():
        if not hasattr(obj, key):
            continue
        attr = getattr(obj, key)
        if is_dataclass(attr) and isinstance(value, dict):
            update_class_from_dict(attr, value)
        else:
            setattr(obj, key, value)
    return obj
