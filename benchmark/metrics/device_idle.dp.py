"""Share of the traced window in which nothing runs on rank 0's card of a data-
parallel run, in %."""


def read(ctx):
    tr = ctx["trace"]
    return 100.0 * (1.0 - tr.busy_s / tr.window_s) if tr is not None else None
