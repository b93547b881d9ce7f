"""ms_per_step: the window's wall time (host clock, ended by a device
synchronise) over the steps completed in it."""


def read(ctx):
    steps = ctx["counters"]["steps"]
    return 1e3 * ctx["host"]["window_s"] / steps if steps else None
