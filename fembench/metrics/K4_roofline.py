"""K4_roofline: K4 banded_sum's share of its roofline, in %: the bytes of
its calls by row width (the program's launch counters banded_sum_m<m>
over the traced episode, fembench/kernels.py) over the HBM peak, over its
device time in the traced episode."""

from fembench import kernels, peaks


def read(ctx):
    tr, sh = ctx["trace"], ctx["shapes"]
    hits = [v for k, v in (tr or {}).get("kernels", {}).items()
            if "banded_sum_kernel" in k]
    n, s = sum(v["n"] for v in hits), sum(v["s"] for v in hits)
    by_m = {int(k[len("banded_sum_m"):]): c
            for k, c in (tr or {}).get("launches", {}).items()
            if k.startswith("banded_sum_m")}
    if not n or not s or sum(by_m.values()) != n:
        return None
    moved = sum(c * kernels.k4_bytes(sh["E"], sh["nv"], sh["k"], m,
                                     sh["value_bytes"])
                for m, c in by_m.items())
    return 100.0 * moved / peaks.HBM_BYTES_PER_S / s
