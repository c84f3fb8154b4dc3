"""The physics kernel's share of its roofline on rank 0's card of a data-
parallel run, in %: the least time of that card's physics work (its envs'
control steps times ``flops.py``'s counts) over the device time of the
kernels named in ``KERNELS``."""
from benchmark.flops import PEAK_BYTES_S, PEAK_F32

KERNELS = ("decimated_step_kernel",)


def read(ctx):
    tr = ctx["trace"]
    if tr is None:
        return None
    busy = tr.kernel_seconds(KERNELS)
    if busy <= 0:
        return None
    w, n = ctx["work"], ctx["steps"]
    least = max(n * w["physics_flops"] / PEAK_F32, n * w["physics_bytes"] / PEAK_BYTES_S)
    return 100.0 * least / busy
