"""update_gpu_ms_per_newton: device ms of the operations launched inside the span
`newton.update`, per Newton iteration of the traced episode."""


def read(ctx):
    tr = ctx["trace"]
    if not tr or not tr["newton"] or "newton.update" not in tr["span_s"]:
        return None
    return 1e3 * tr["span_s"]["newton.update"] / tr["newton"]
