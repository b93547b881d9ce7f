"""A box of hexahedral cells, 5 tets each: a frozen, vectorised copy of
mixedfem_tpu_torch/mesh/generators.py:box_tet_mesh (the same vertices and
tets in the same order), so that the benchmark's inputs do not change
when the program does. A configuration's object names it as

    "mesh": {"recipe": "box_tets", "cells": [nx, ny, nz],
             "size": [sx, sy, sz], "origin": [ox, oy, oz]}
"""

from __future__ import annotations

import numpy as np

# the 5-tet split of a cube, mirrored on cells of odd parity so that faces
# conform; corners numbered (dx, dy, dz) -> dx + 2 dy + 4 dz
_EVEN = np.array([(0, 1, 2, 4), (1, 2, 3, 7), (1, 4, 5, 7), (2, 4, 6, 7),
                  (1, 2, 4, 7)])
_ODD = np.array([(0, 1, 3, 5), (0, 2, 3, 6), (0, 4, 5, 6), (3, 5, 6, 7),
                 (0, 3, 5, 6)])


def box_tet_mesh(nx: int, ny: int, nz: int, size=(1.0, 1.0, 1.0),
                 origin=(0.0, 0.0, 0.0)):
    """A box of nx x ny x nz cubes, 5 tets each: (V (nv, 3) float64, T
    (5 nx ny nz, 4) int32), positively oriented, cells in (i, j, k) order."""
    xs = np.linspace(0, size[0], nx + 1) + origin[0]
    ys = np.linspace(0, size[1], ny + 1) + origin[1]
    zs = np.linspace(0, size[2], nz + 1) + origin[2]
    X, Y, Z = np.meshgrid(xs, ys, zs, indexing="ij")
    V = np.stack([X.ravel(), Y.ravel(), Z.ravel()], axis=-1)

    i, j, k = (a.ravel() for a in np.meshgrid(
        np.arange(nx), np.arange(ny), np.arange(nz), indexing="ij"))

    def vid(a, b, c):
        return (a * (ny + 1) + b) * (nz + 1) + c

    corners = np.stack([vid(i + dx, j + dy, k + dz)
                        for dz in (0, 1) for dy in (0, 1) for dx in (0, 1)],
                       axis=1)  # (cells, 8)
    odd = ((i + j + k) % 2 == 1)[:, None, None]
    pat = np.where(odd, _ODD[None], _EVEN[None])  # (cells, 5, 4)
    T = np.take_along_axis(corners[:, None, :], pat, axis=2)
    T = T.reshape(-1, 4).astype(np.int32)

    a, b, c, d = V[T[:, 0]], V[T[:, 1]], V[T[:, 2]], V[T[:, 3]]
    flip = np.einsum("ij,ij->i", np.cross(b - a, c - a), d - a) < 0
    T[flip, 2], T[flip, 3] = T[flip, 3].copy(), T[flip, 2].copy()
    return V, T


def make(cells, size=(1.0, 1.0, 1.0), origin=(0.0, 0.0, 0.0)):
    """The object's (V, T) from its configuration's "mesh" entry."""
    return box_tet_mesh(*cells, size=tuple(size), origin=tuple(origin))
