"""The whole ``mpc_step``'s share of the card's float32 peak, in %: the
physics operations the window's steps need (as ``physics_roofline.mpc``
counts them) over the traced window's seconds times the peak."""
from benchmark.flops import PEAK_F32


def read(ctx):
    tr = ctx["trace"]
    if tr is None:
        return None
    w = ctx["work"]
    steps = ctx["steps"] * w["env_steps"] + tr.range_count("replan") * w["replan_env_steps"]
    return 100.0 * steps * w["flops_per_env_step"] / (tr.window_s * PEAK_F32)
