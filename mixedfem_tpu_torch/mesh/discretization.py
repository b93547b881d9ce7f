"""Host-side (numpy, f64) discretization precompute of linear tets, 2D
triangles and 3D membrane triangles (shells): a copy of
mixedfem_tpu/mesh/discretization.py, with its surface extraction
(boundary_facets, edges).

Conventions (identical to the reference):
- F_e = sum_k x[T[e,k]] dphi_k/dX^T, i.e. F[r,c] = sum_k x_k[r] dphidX[k,c].
- volumes are |tet volume| in 3D and DOUBLE triangle areas in 2D (the
  reference weights every 2D element quantity by 2A).
"""

from __future__ import annotations

import numpy as np


def tet_volumes(V: np.ndarray, T: np.ndarray) -> np.ndarray:
    """Absolute tetrahedron volumes."""
    a, b, c, d = V[T[:, 0]], V[T[:, 1]], V[T[:, 2]], V[T[:, 3]]
    M = np.stack([b - a, c - a, d - a], axis=-2)
    return np.abs(np.linalg.det(M)) / 6.0


def tri_double_areas(V: np.ndarray, T: np.ndarray) -> np.ndarray:
    """Double triangle areas (igl::doublearea)."""
    a, b, c = V[T[:, 0]], V[T[:, 1]], V[T[:, 2]]
    e1, e2 = b - a, c - a
    if V.shape[1] == 2:
        return np.abs(e1[:, 0] * e2[:, 1] - e1[:, 1] * e2[:, 0])
    return np.linalg.norm(np.cross(e1, e2), axis=-1)


def tet_dphidX(V: np.ndarray, T: np.ndarray) -> np.ndarray:
    """(E, 4, 3) shape-function gradients for linear tets.

    F = Ds Dm^{-1}: rows 1..3 are rows of Dm^{-1}, row 0 = -sum(rows).
    """
    a = V[T[:, 0]]
    Dm = np.stack([V[T[:, 1]] - a, V[T[:, 2]] - a, V[T[:, 3]] - a], axis=-1)
    Dmi = np.linalg.inv(Dm)  # (E, 3, 3)
    dphi = np.empty((len(T), 4, 3), dtype=V.dtype)
    dphi[:, 1:, :] = Dmi
    dphi[:, 0, :] = -Dmi.sum(axis=1)
    return dphi


def tri2d_dphidX(V: np.ndarray, T: np.ndarray) -> np.ndarray:
    """(E, 3, 2) shape-function gradients for linear 2D triangles."""
    a = V[T[:, 0]]
    Dm = np.stack([V[T[:, 1]] - a, V[T[:, 2]] - a], axis=-1)  # (E, 2, 2)
    Dmi = np.linalg.inv(Dm)
    dphi = np.empty((len(T), 3, 2), dtype=V.dtype)
    dphi[:, 1:, :] = Dmi
    dphi[:, 0, :] = -Dmi.sum(axis=1)
    return dphi


def tri3d_dphidX(V: np.ndarray, T: np.ndarray) -> np.ndarray:
    """(E, 3, 3) in-plane shape-function gradients of 3D membrane
    triangles: grad phi_{1,2} are the columns of Dm (Dm^T Dm)^{-1}, and
    grad phi_0 = -(grad phi_1 + grad phi_2)."""
    e1 = V[T[:, 1]] - V[T[:, 0]]
    e2 = V[T[:, 2]] - V[T[:, 0]]
    Dm = np.stack([e1, e2], axis=-1)  # (E, 3, 2)
    G2 = np.linalg.inv(np.einsum("eik,eil->ekl", Dm, Dm))  # (E, 2, 2)
    grad12 = np.einsum("eik,ekl->eil", Dm, G2)  # (E, 3, 2) columns
    dphi = np.empty((len(T), 3, 3), dtype=V.dtype)
    dphi[:, 1, :] = grad12[:, :, 0]
    dphi[:, 2, :] = grad12[:, :, 1]
    dphi[:, 0, :] = -(dphi[:, 1] + dphi[:, 2])
    return dphi


def tri3d_rest_normals(V: np.ndarray, T: np.ndarray) -> np.ndarray:
    """(E, 3) unit normals of 3D triangles at rest."""
    n = np.cross(V[T[:, 1]] - V[T[:, 0]], V[T[:, 2]] - V[T[:, 0]])
    return n / np.linalg.norm(n, axis=1, keepdims=True)


def consistent_mass_coeff(vols: np.ndarray, density: np.ndarray, k: int = 4,
                          shell: bool = False):
    """(E, k, k) per-element consistent mass blocks (scalar per vertex pair;
    the d-dim block is coeff * I_d):
      tets (k=4):      M_kl = rho * vol * (1 + delta_kl) / 20
      triangles (k=3): M_kl = rho * area * (1 + delta_kl) / 12, with
                       area = vols / 2, as vols holds DOUBLE areas
      shells (k=3):    M_kl = rho * vols * (1 + delta_kl) / 12, vols
                       already carrying the thickness factor."""
    if k not in (3, 4) or (shell and k != 3):
        raise ValueError(f"no consistent mass of {k}-corner elements"
                         + (" (shells are triangles)" if shell else ""))
    base = 1.0 + np.eye(k)
    if k == 4:
        w = density * vols / 20.0
    elif shell:
        w = density * vols / 12.0
    else:
        w = density * (vols / 2.0) / 12.0
    return w[:, None, None] * base[None]


def boundary_facets(T: np.ndarray) -> np.ndarray:
    """Boundary faces of a tet mesh, or boundary edges of a triangle mesh:
    facets occurring exactly once (igl::boundary_facets), oriented outward
    for positive tets."""
    if T.shape[1] == 4:
        faces = np.concatenate(
            [T[:, [1, 3, 2]], T[:, [0, 2, 3]], T[:, [0, 3, 1]],
             T[:, [0, 1, 2]]],
            axis=0,
        )
    elif T.shape[1] == 3:
        faces = np.concatenate([T[:, [1, 2]], T[:, [2, 0]], T[:, [0, 1]]],
                               axis=0)
    else:
        raise NotImplementedError("only linear tets and triangles are ported")
    key = np.sort(faces, axis=1)
    _, inv, counts = np.unique(key, axis=0, return_inverse=True,
                               return_counts=True)
    return faces[counts[inv.reshape(-1)] == 1].astype(np.int32)


def edges(F: np.ndarray) -> np.ndarray:
    """Unique undirected edges of a triangle list (igl::edges)."""
    E = np.concatenate([F[:, [0, 1]], F[:, [1, 2]], F[:, [2, 0]]], axis=0)
    return np.unique(np.sort(E, axis=1), axis=0).astype(np.int32)
