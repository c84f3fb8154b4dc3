"""The data-parallel PPO update's milliseconds per iteration on rank 0's card
(its NCCL reductions included): the mean of ``last_times["update_s"]``."""


def read(ctx):
    s = ctx["spans"].get("update_s")
    return 1e3 * sum(s) / len(s) if s else None
