"""Host bandwidth-reducing vertex reordering, reverse Cuthill-McKee (a copy
of mixedfem_tpu/parallel/reorder.py; the arrays are the JAX package's).

The vertex-partitioned path (parallel/halo.py, parallel/vp_step.py) needs a
banded vertex order: every element's vertices must fall inside the halo
window of the rank that owns it. Structured generator meshes are banded by
construction; arbitrary meshes are not, and this pass makes them so.

Rank-count limit: 1D banded partitioning supports D <~ nv / bandwidth. For
compact 3D meshes the RCM bandwidth grows about as nv^(2/3), so D grows as
nv^(1/3). The element-sharded step (parallel/sharding.py) has no such
limit.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
from scipy.sparse.csgraph import reverse_cuthill_mckee


def banded_vertex_order(nv: int, T: np.ndarray) -> np.ndarray:
    """Return old->new vertex index map minimizing adjacency bandwidth."""
    T = np.asarray(T)
    k = T.shape[1]
    rows, cols = [], []
    for i in range(k):
        for j in range(k):
            if i != j:
                rows.append(T[:, i])
                cols.append(T[:, j])
    rows = np.concatenate(rows)
    cols = np.concatenate(cols)
    A = sp.coo_matrix(
        (np.ones(len(rows), np.int8), (rows, cols)), shape=(nv, nv)
    ).tocsr()
    order = reverse_cuthill_mckee(A, symmetric_mode=True)  # new->old
    old_to_new = np.empty(nv, np.int64)
    old_to_new[order] = np.arange(nv)
    return old_to_new


def bandwidth(T: np.ndarray, old_to_new: np.ndarray | None = None) -> int:
    """Max index spread within any element (after optional reordering)."""
    T = np.asarray(T)
    if old_to_new is not None:
        T = old_to_new[T]
    return int((T.max(axis=1) - T.min(axis=1)).max())


def reorder_mesh_arrays(V: np.ndarray, T: np.ndarray, *vertex_fields):
    """Apply the RCM order: returns (V', T', old_to_new, fields'...)."""
    old_to_new = banded_vertex_order(len(V), T)
    inv = np.argsort(old_to_new)  # new->old
    V2 = np.asarray(V)[inv]
    T2 = old_to_new[np.asarray(T)]
    out = [np.asarray(f)[inv] for f in vertex_fields]
    return (V2, T2, old_to_new, *out)
