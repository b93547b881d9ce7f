"""device_idle_pct: the share of the traced episode in which no device
operation ran, in %."""


def read(ctx):
    tr = ctx["trace"]
    if not tr or not tr["window_s"]:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
