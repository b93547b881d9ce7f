"""cg_per_newton: linear-solver iterations per Newton iteration over the
window (SimState.stats.solver_iters)."""


def read(ctx):
    c = ctx["counters"]
    return c["cg"] / c["newton"] if c["newton"] else None
