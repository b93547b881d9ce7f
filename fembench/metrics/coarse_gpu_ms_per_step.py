"""coarse_gpu_ms_per_step: device ms of the operations launched inside the span
`newton.coarse_refresh`, per step of the traced episode."""


def read(ctx):
    tr = ctx["trace"]
    if not tr or not tr["steps"] or "newton.coarse_refresh" not in tr["span_s"]:
        return None
    return 1e3 * tr["span_s"]["newton.coarse_refresh"] / tr["steps"]
