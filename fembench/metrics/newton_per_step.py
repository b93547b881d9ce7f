"""newton_per_step: Newton iterations per step over the window
(SimState.stats.iterations)."""


def read(ctx):
    c = ctx["counters"]
    return c["newton"] / c["steps"] if c["steps"] else None
