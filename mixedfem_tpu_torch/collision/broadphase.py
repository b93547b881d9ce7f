"""Host broadphase: candidate contact frames within a distance margin
(port of mixedfem_tpu/collision/broadphase.py).

A uniform grid hash over surface primitives gives padded candidate arrays:

  frames: (C, 4) int32 vertex ids (full-mesh indexing)
  types:  (C,)   int32 (distances.PT / EE / PE)

3D: point-triangle (surface vertex x face, excluding incident faces) and
edge-edge (surface edge pairs, excluding pairs that share a vertex).
2D: point-edge (boundary vertex x boundary edge, excluding incident
edges), frames (v, e0, e1, -1).
Candidates whose distance bound exceeds `margin` are dropped; the arrays
are padded to a fixed capacity with inert frames.

The grid hash is one vectorized numpy pass: integer cell keys, one sorted
table of the second point set's keys, and a searchsorted of it for each of
the 27 (2D: 9) neighbour offsets. Pairs come out ordered by (first point,
offset, second point), the order of the JAX package's native grid hash
(csrc/native.cpp), so both packages build the same frames in the same
order.
"""

from __future__ import annotations

import numpy as np

from mixedfem_tpu_torch.collision.distances import EE, PE, PP, PT

# neighbour offsets in the native hash's order: x fastest, then y, then z
_OFFSETS = {
    3: np.stack([np.arange(27) % 3, (np.arange(27) // 3) % 3,
                 np.arange(27) // 9], axis=1) - 1,
    2: np.stack([np.arange(9) % 3, np.arange(9) // 3], axis=1) - 1,
}


def _grid_pairs(P0: np.ndarray, P1, cell: float, keep):
    """All (i, j) with P1[j]'s cell in the 27-neighbourhood (2D: 9) of
    P0[i]'s, and keep(i, j) true: (i, j) int64 arrays ordered by (i,
    offset, j). With P1 None (3D only) the set is P0 against itself and only
    pairs i < j are made: each unordered pair is found once, from the 13
    offsets of one half and within a cell, and then oriented."""
    sym = P1 is None
    P1 = P0 if sym else P1
    c0 = np.floor(P0 / cell).astype(np.int64)
    c1 = np.floor(P1 / cell).astype(np.int64)
    lo = np.minimum(c0.min(axis=0), c1.min(axis=0)) - 1
    ext = np.maximum(c0.max(axis=0), c1.max(axis=0)) - lo + 2
    if float(np.prod(ext.astype(np.float64))) >= 2.0**62:
        raise ValueError(f"a grid of {ext.tolist()} cells of {cell}")

    offsets = _OFFSETS[P0.shape[1]]

    def key(c):
        c = c - lo
        k = c[:, 0]
        for j in range(1, c.shape[1]):
            k = k * ext[j] + c[:, j]
        return k

    order = np.argsort(key(c1), kind="stable")
    table = key(c1)[order]
    rows = np.arange(len(P0))
    out_i, out_o, out_j = [], [], []
    # offset o and its mirror 26 - o; offsets 14-26 are the far half
    for o in range(14 if sym else len(offsets)):
        q = key(c0 + offsets[o])
        a = np.searchsorted(table, q, side="left")
        n = np.searchsorted(table, q, side="right") - a
        total = int(n.sum())
        if total == 0:
            continue
        ii = np.repeat(rows, n)
        jj = order[np.arange(total) + np.repeat(a - (np.cumsum(n) - n), n)]
        oo = np.full(total, o)
        if sym:
            first = ii < jj
            if o == 13:              # within a cell: each pair twice
                ii, jj, oo = ii[first], jj[first], oo[first]
            else:
                ii, jj = np.where(first, ii, jj), np.where(first, jj, ii)
                oo = np.where(first, o, 26 - o)
        m = keep(ii, jj)
        out_i.append(ii[m])
        out_j.append(jj[m])
        out_o.append(oo[m])
    if not out_i:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    ii, oo, jj = (np.concatenate(a) for a in (out_i, out_o, out_j))
    s = np.lexsort((jj, oo, ii))
    return ii[s], jj[s]


def _seg_midpoints(V, E):
    return 0.5 * (V[E[:, 0]] + V[E[:, 1]])


def _seg_radius(V, E):
    return 0.5 * np.linalg.norm(V[E[:, 0]] - V[E[:, 1]], axis=1)


def _tri_centroid(V, F):
    return (V[F[:, 0]] + V[F[:, 1]] + V[F[:, 2]]) / 3.0


def _tri_radius(V, F):
    c = _tri_centroid(V, F)
    return np.max(
        [np.linalg.norm(V[F[:, k]] - c, axis=1) for k in range(3)], axis=0
    )


def candidates_3d(V, F_srf, E_srf, surf_verts, margin: float):
    """3D candidate frames: (frames (C, 4) int32, types (C,) int32)."""
    frames, types = [], []

    # point-triangle
    Pv = V[surf_verts]
    tc = _tri_centroid(V, F_srf)
    tr = _tri_radius(V, F_srf)

    def keep_pt(ii, jj):
        v, f = surf_verts[ii], F_srf[jj]
        apart = (f[:, 0] != v) & (f[:, 1] != v) & (f[:, 2] != v)  # not incident
        dist_ub = np.linalg.norm(Pv[ii] - tc[jj], axis=1) - tr[jj]
        return apart & (dist_ub < margin)

    ii, jj = _grid_pairs(Pv, tc, max(margin + tr.max(), 1e-8), keep_pt)
    if len(ii):
        frames.append(np.concatenate([surf_verts[ii][:, None], F_srf[jj]],
                                     axis=1).astype(np.int32))
        types.append(np.full(len(ii), PT, np.int32))

    # edge-edge, each unordered pair once
    em = _seg_midpoints(V, E_srf)
    er = _seg_radius(V, E_srf)

    def keep_ee(ii, jj):
        e0, e1 = E_srf[ii], E_srf[jj]
        shared = ((e0[:, 0] == e1[:, 0]) | (e0[:, 0] == e1[:, 1])
                  | (e0[:, 1] == e1[:, 0]) | (e0[:, 1] == e1[:, 1]))
        dist_ub = np.linalg.norm(em[ii] - em[jj], axis=1) - er[ii] - er[jj]
        return ~shared & (dist_ub < margin)

    ii, jj = _grid_pairs(em, None, max(margin + 2 * er.max(), 1e-8), keep_ee)
    if len(ii):
        frames.append(np.concatenate([E_srf[ii], E_srf[jj]],
                                     axis=1).astype(np.int32))
        types.append(np.full(len(ii), EE, np.int32))

    if frames:
        return np.concatenate(frames), np.concatenate(types)
    return np.zeros((0, 4), np.int32), np.zeros(0, np.int32)


def candidates_2d(V, E_srf, surf_verts, margin: float):
    """2D candidate frames: point-edge (v, e0, e1, -1); (frames (C, 4)
    int32, types (C,) int32)."""
    Pv = V[surf_verts]
    em = _seg_midpoints(V, E_srf)
    er = _seg_radius(V, E_srf)

    def keep_pe(ii, jj):
        v, e = surf_verts[ii], E_srf[jj]
        apart = (e[:, 0] != v) & (e[:, 1] != v)  # not incident
        dist_ub = np.linalg.norm(Pv[ii] - em[jj], axis=1) - er[jj]
        return apart & (dist_ub < margin)

    ii, jj = _grid_pairs(Pv, em, max(margin + er.max(), 1e-8), keep_pe)
    frames = np.concatenate(
        [surf_verts[ii][:, None], E_srf[jj], np.full((len(ii), 1), -1)],
        axis=1).astype(np.int32)
    return frames, np.full(len(ii), PE, np.int32)


def capacity(n: int, max_frames: int = 0) -> int:
    """Padded capacity for n candidates: `max_frames` when set, else the
    next power of two, at least 256 (bounded shapes across steps)."""
    return max_frames or max(256, 1 << int(np.ceil(np.log2(n))))


def pad_candidates(frames, types, cap: int):
    """Pad to `cap` with inert frames (ids 0, type PP, mask 0)."""
    C = len(frames)
    if C > cap:
        raise ValueError(f"contact candidate overflow: {C} > capacity {cap}")
    out_f = np.zeros((cap, 4), np.int32)
    out_t = np.full(cap, PP, np.int32)
    mask = np.zeros(cap, np.float64)
    out_f[:C] = np.where(frames[:C] < 0, 0, frames[:C])
    out_t[:C] = types
    mask[:C] = 1.0
    return out_f, out_t, mask
