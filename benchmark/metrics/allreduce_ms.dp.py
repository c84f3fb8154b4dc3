"""Milliseconds of NCCL all-reduce kernels per PPO iteration on rank 0's
card (the gradient, KL and loss-check reductions of every minibatch step,
the advantage moments and the episode metrics), from the profiler's trace
of the window."""

KERNELS = ("AllReduce",)


def read(ctx):
    tr = ctx["trace"]
    if tr is None:
        return None
    s = tr.kernel_seconds(KERNELS)
    return 1e3 * s / ctx["steps"] if s > 0 else None
