"""Milliseconds of the plan's optimisation per ``mpc_step``: the harness's
timer between two synchronisations around the env's
``optimize_all_trajectories`` (diffusion sweep and fd polish), averaged over
the traced window's steps."""


def read(ctx):
    s = ctx["spans"].get("optimize_s")
    return 1e3 * sum(s) / len(s) if s else None
