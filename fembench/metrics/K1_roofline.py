"""K1_roofline: K1 element_apply's share of its roofline, in %: the bytes
its calls must move (fembench/kernels.py, from the cell's shapes) over
the HBM peak, over its device time in the traced episode. Bytes bound it:
about 1.3 flops a byte in float32, far under the H100's ridge."""

from fembench import kernels, peaks


def read(ctx):
    tr, sh = ctx["trace"], ctx["shapes"]
    hits = [v for k, v in (tr or {}).get("kernels", {}).items()
            if "element_apply_kernel" in k]
    n, s = sum(v["n"] for v in hits), sum(v["s"] for v in hits)
    if not n or not s:
        return None
    per_call = kernels.k1_bytes(sh["E"], sh["nv"], sh["k"], sh["d"], sh["N"],
                                sh["value_bytes"])
    return 100.0 * n * per_call / peaks.HBM_BYTES_PER_S / s
