"""A data-parallel PPO iteration's share of one card's peak on rank 0's card,
in %: the operations of that card's share (networks forward and backward
from the widths, physics from ``flops.py``) over the traced window's seconds
times the peak of the precision the matrix products run in."""
from benchmark.flops import matmul_peak


def read(ctx):
    tr = ctx["trace"]
    if tr is None:
        return None
    w = ctx["work"]
    ops = ctx["steps"] * (w["network_flops"] + w["physics_flops"])
    return 100.0 * ops / (tr.window_s * matmul_peak())
