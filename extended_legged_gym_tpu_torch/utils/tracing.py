"""The port's own profiler ranges: ``span(name)`` marks a phase of the
control step, the rollout step or the MPC solve as ``elg:<name>``.

While a ``torch.profiler`` records in this process, a span is a
``torch.profiler.record_function`` range: Kineto stamps it on the host clock
it aligns the device's activity to, so every device kernel and idle interval
of the trace can be put down to the phase the host was in, and spans nest by
call order on their thread.  Otherwise a span costs one check of the
profiler's enabled flag and does nothing.  A span never synchronises, reads
no device value and changes nothing that is computed.

    with span("env.reward"):
        ...

    @span("mpc.polish")
    def polish_fd(...): ...

To see them, trace any call of the port, e.g.
``with torch.profiler.profile() as prof: env.step(state, actions)``, then
``prof.export_chrome_trace(path)``: the ranges appear as ``elg:env.step``
and its children.
"""
from __future__ import annotations

import functools

import torch
from torch._C._autograd import _profiler_enabled

PREFIX = "elg:"


class _Idle:
    """A span while no profiler records: nothing to open or close.  As a
    decorator it decides at each call whether to open a range."""

    __slots__ = ("name",)

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def __call__(self, fn):
        name = self.name

        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            if not _profiler_enabled():
                return fn(*args, **kwargs)
            with _Range(name):
                return fn(*args, **kwargs)
        return wrapped


class _Range(_Idle):
    """An open ``record_function`` range for one ``with`` block."""

    __slots__ = ("_rf",)

    def __enter__(self):
        self._rf = torch.profiler.record_function(PREFIX + self.name)
        self._rf.__enter__()
        return self

    def __exit__(self, *exc):
        self._rf.__exit__(*exc)
        return False


_IDLE = {}


def span(name: str):
    """The range ``elg:<name>`` while a profiler records, else a shared
    no-op; a context manager, or a decorator of a function."""
    if _profiler_enabled():
        return _Range(name)
    idle = _IDLE.get(name)
    if idle is None:
        idle = _IDLE[name] = _Idle(name)
    return idle
