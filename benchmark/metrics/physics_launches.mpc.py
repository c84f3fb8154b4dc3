"""Launches of the fused physics kernels per ``mpc_step``: the program's
``DecimatedEnvStep.launches`` and ``rough_launches`` counters over the traced
window, per step."""


def read(ctx):
    n = ctx["counters"].get("physics_launches")
    return n / ctx["steps"] if n else None
