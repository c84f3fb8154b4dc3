"""Collection's milliseconds per PPO iteration: the mean of the runner's
synchronised host span ``OnPolicyRunner.last_times["collection_s"]`` over the
traced window's iterations."""


def read(ctx):
    s = ctx["spans"].get("collection_s")
    return 1e3 * sum(s) / len(s) if s else None
