"""Device kernels launched per PPO iteration (copies and sets left out),
counted in the profiler's trace of the window."""


def read(ctx):
    tr = ctx["trace"]
    return tr.kernel_count() / ctx["steps"] if tr is not None else None
