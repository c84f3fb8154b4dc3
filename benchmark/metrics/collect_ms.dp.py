"""Collection's milliseconds per PPO iteration on rank 0's card of a data-
parallel run: the mean of the runner's synchronised host span
``last_times["collection_s"]``."""


def read(ctx):
    s = ctx["spans"].get("collection_s")
    return 1e3 * sum(s) / len(s) if s else None
