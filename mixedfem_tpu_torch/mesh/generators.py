"""Procedural mesh generators (host-side numpy), a copy of
mixedfem_tpu/mesh/generators.py (box_tet_mesh, grid_tri_mesh) kept here so
the port does not import the JAX package."""

from __future__ import annotations

import numpy as np


def box_tet_mesh(nx: int, ny: int, nz: int, size=(1.0, 1.0, 1.0), origin=(0.0, 0.0, 0.0)):
    """Regular (nx,ny,nz)-cell box, each cube split into 5 tets.

    Returns (V (nv,3) f64, T (ntet,4) i32) with ntet = 5*nx*ny*nz.
    Alternating cube parity keeps faces conforming.
    """
    xs = np.linspace(0, size[0], nx + 1) + origin[0]
    ys = np.linspace(0, size[1], ny + 1) + origin[1]
    zs = np.linspace(0, size[2], nz + 1) + origin[2]
    X, Y, Z = np.meshgrid(xs, ys, zs, indexing="ij")
    V = np.stack([X.ravel(), Y.ravel(), Z.ravel()], axis=-1)

    def vid(i, j, k):
        return (i * (ny + 1) + j) * (nz + 1) + k

    tets = []
    # 5-tet decomposition, mirrored on odd-parity cells for conformity
    even = [
        (0, 1, 2, 4),
        (1, 2, 3, 7),
        (1, 4, 5, 7),
        (2, 4, 6, 7),
        (1, 2, 4, 7),
    ]
    odd = [
        (0, 1, 3, 5),
        (0, 2, 3, 6),
        (0, 4, 5, 6),
        (3, 5, 6, 7),
        (0, 3, 5, 6),
    ]
    for i in range(nx):
        for j in range(ny):
            for k in range(nz):
                c = [
                    vid(i, j, k),
                    vid(i + 1, j, k),
                    vid(i, j + 1, k),
                    vid(i + 1, j + 1, k),
                    vid(i, j, k + 1),
                    vid(i + 1, j, k + 1),
                    vid(i, j + 1, k + 1),
                    vid(i + 1, j + 1, k + 1),
                ]
                pat = even if (i + j + k) % 2 == 0 else odd
                for t in pat:
                    tets.append([c[t[0]], c[t[1]], c[t[2]], c[t[3]]])
    T = np.asarray(tets, dtype=np.int32)

    # positive orientation keeps the sign conventions of the reference
    a, b, cc, d = V[T[:, 0]], V[T[:, 1]], V[T[:, 2]], V[T[:, 3]]
    vol6 = np.einsum(
        "ij,ij->i", np.cross(b - a, cc - a), d - a
    )
    flip = vol6 < 0
    T[flip, 2], T[flip, 3] = T[flip, 3].copy(), T[flip, 2].copy()
    return V, T


def grid_tri_mesh(nx: int, ny: int, size=(1.0, 1.0), origin=(0.0, 0.0)):
    """Regular 2D triangle grid: (V (nv, 2) f64, T (2 nx ny, 3) i32), each
    cell split along alternating diagonals."""
    xs = np.linspace(0, size[0], nx + 1) + origin[0]
    ys = np.linspace(0, size[1], ny + 1) + origin[1]
    X, Y = np.meshgrid(xs, ys, indexing="ij")
    V = np.stack([X.ravel(), Y.ravel()], axis=-1)

    def vid(i, j):
        return i * (ny + 1) + j

    tris = []
    for i in range(nx):
        for j in range(ny):
            v00, v10 = vid(i, j), vid(i + 1, j)
            v01, v11 = vid(i, j + 1), vid(i + 1, j + 1)
            if (i + j) % 2 == 0:
                tris.append([v00, v10, v11])
                tris.append([v00, v11, v01])
            else:
                tris.append([v00, v10, v01])
                tris.append([v10, v11, v01])
    return V, np.asarray(tris, dtype=np.int32)
