"""The whole PPO iteration's share of the card's peak, in %: the operations
the window's iterations need (the networks forward and backward, counted
from the widths, and the physics, from ``flops.py``) over the traced
window's seconds times the peak of the precision the matrix products run in
(float32, or TF32 where PyTorch allows it)."""
from benchmark.flops import matmul_peak


def read(ctx):
    tr = ctx["trace"]
    if tr is None:
        return None
    w = ctx["work"]
    ops = ctx["steps"] * (w["network_flops"] + w["physics_flops"])
    return 100.0 * ops / (tr.window_s * matmul_peak())
