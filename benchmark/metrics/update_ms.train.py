"""The PPO update's milliseconds per iteration: the mean of the runner's
synchronised host span ``OnPolicyRunner.last_times["update_s"]`` over the
traced window's iterations."""


def read(ctx):
    s = ctx["spans"].get("update_s")
    return 1e3 * sum(s) / len(s) if s else None
