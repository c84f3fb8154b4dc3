"""The physics kernel's share of its roofline in ``mpc_step``, in %: the
least time the steps' physics work could take on an H100 (the larger of its
operations over the float32 peak and its bytes over the memory rate; env
control steps of the diffusion rollouts, the fd polish, the main step and
the near-fall re-plans the window ran, times ``flops.py``'s counts per step)
over the device time of the kernels named in ``KERNELS``."""
from benchmark.flops import PEAK_BYTES_S, PEAK_F32

KERNELS = ("decimated_step_kernel",)


def read(ctx):
    tr = ctx["trace"]
    if tr is None:
        return None
    busy = tr.kernel_seconds(KERNELS)
    if busy <= 0:
        return None
    w = ctx["work"]
    steps = ctx["steps"] * w["env_steps"] + tr.range_count("replan") * w["replan_env_steps"]
    least = max(steps * w["flops_per_env_step"] / PEAK_F32,
                steps * w["bytes_per_env_step"] / PEAK_BYTES_S)
    return 100.0 * least / busy
