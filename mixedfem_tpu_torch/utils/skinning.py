"""Linear-blend skinning of a render surface in the simulation's tets
(port of mixedfem_tpu/utils/skinning.py, host numpy).

Each render vertex is embedded in the tet that contains it (or, outside
the mesh, the tet whose most negative barycentric coordinate is largest)
and advected as V_render = sum_k bary_k x[tet_k].
"""

from __future__ import annotations

import numpy as np


def embed_in_tets(Vr: np.ndarray, V: np.ndarray, T: np.ndarray):
    """Barycentric embedding: (tet_id (nr,), bary (nr, 4))."""
    a = V[T[:, 0]]
    Dm = np.stack([V[T[:, 1]] - a, V[T[:, 2]] - a, V[T[:, 3]] - a], axis=-1)
    Dmi = np.linalg.inv(Dm)

    nr = len(Vr)
    tet_id = np.zeros(nr, np.int32)
    bary = np.zeros((nr, 4))
    # chunks bound the (chunk, E, 3) intermediates
    chunk = max(1, int(2e7 // max(len(T), 1)))
    for s in range(0, nr, chunk):
        P = Vr[s : s + chunk]
        rel = P[:, None, :] - a[None, :, :]
        b123 = np.einsum("eij,pej->pei", Dmi, rel)
        b0 = 1.0 - b123.sum(axis=-1)
        ball = np.concatenate([b0[..., None], b123], axis=-1)  # (p, E, 4)
        best = ball.min(axis=-1).argmax(axis=-1)
        tet_id[s : s + chunk] = best
        bary[s : s + chunk] = ball[np.arange(len(P)), best]
    return tet_id, bary


def apply_skinning(x: np.ndarray, T: np.ndarray, tet_id, bary) -> np.ndarray:
    """Render vertices (nr, 3) from simulation positions (nv, 3)."""
    return np.einsum("rk,rkd->rd", bary, x[T[tet_id]])
