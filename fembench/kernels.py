"""The bytes that a hand kernel's call must move, from the call's shapes: a
frozen copy of the bound-byte formulas of the program's kernel table
(each input byte read once, each output byte written once, whatever the
kernel reads again).

Shapes: E elements of k corners in d dimensions with N stretch values,
nv vertices, `b` bytes a value, int32 ids.
"""

from __future__ import annotations


def k1_bytes(E: int, nv: int, k: int, d: int, N: int, b: int) -> int:
    """K1 element_apply: per-corner rows (M_e + Gw_e^T Gw_e) P p_e. In: T
    (E, k) ids, Gw (E, N, k, d), the mass blocks (E, k, k), the free mask
    (nv,), p (nv, d); out: (E, k, d)."""
    return E * k * 4 + E * N * k * d * b + E * k * k * b + nv * b \
        + nv * d * b + E * k * d * b


def k4_bytes(E: int, nv: int, k: int, m: int, b: int) -> int:
    """K4 banded_sum at row width m: the E k corner rows (E k, m), one
    int32 vertex id a row, the sums (nv, m)."""
    return E * k * (m * b + 4) + nv * m * b
