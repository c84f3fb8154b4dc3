"""The physics kernel's share of its roofline in a PPO iteration, in %: the
least time the iterations' physics work could take on an H100 (the larger
of its operations over the float32 peak and its bytes over the memory
rate; env control steps the algorithm needs times ``flops.py``'s counts per
step) over the device time of the kernels named in ``KERNELS``."""
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
