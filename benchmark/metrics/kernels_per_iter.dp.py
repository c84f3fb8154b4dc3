"""Device kernels launched per data-parallel PPO iteration on rank 0's card
(copies and sets left out), from the profiler's trace."""


def read(ctx):
    tr = ctx["trace"]
    return tr.kernel_count() / ctx["steps"] if tr is not None else None
