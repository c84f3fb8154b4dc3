"""Share of the traced window of PPO iterations in which nothing runs on the
device (the complement of the union of its activity intervals), in %."""


def read(ctx):
    tr = ctx["trace"]
    return 100.0 * (1.0 - tr.busy_s / tr.window_s) if tr is not None else None
