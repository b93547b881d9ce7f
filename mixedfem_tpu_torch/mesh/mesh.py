"""MeshData and the element-level operations of the solid paths: 3D linear
tets and 2D linear triangles (port of mixedfem_tpu/mesh/mesh.py, its
solids).

Everything is matrix-free: deformation gradients are per-element gathers
plus small contractions, and every element-to-vertex sum goes through the
mesh's static incidence plan (ops/assembly.py, kernel K2 on the card).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from mixedfem_tpu_torch.device import resolve_device
from mixedfem_tpu_torch.mesh import discretization as disc
from mixedfem_tpu_torch.ops import assembly


@dataclasses.dataclass
class MeshData:
    """Static per-simulation discretization data, on one device."""

    V0: torch.Tensor          # (nv, d) rest positions
    T: torch.Tensor           # (E, k) int32 element vertex ids
    dphidX: torch.Tensor      # (E, k, d) shape function gradients
    vols: torch.Tensor        # (E,) element volumes (2D: double areas)
    mass_coeff: torch.Tensor  # (E, k, k) consistent mass blocks (scalar x I_d)
    mass_lumped: torch.Tensor  # (nv,) row-sum mass
    mass_diag: torch.Tensor   # (nv,) diagonal of the consistent mass
    free_mask: torch.Tensor   # (nv,) 1.0 free, 0.0 pinned
    mu: torch.Tensor          # (E,) Lame mu
    lam: torch.Tensor         # (E,) Lame lambda
    model_id: torch.Tensor    # (E,) int32 index into `models`
    ext_force: torch.Tensor   # (nv, d) external acceleration
    obj_id: torch.Tensor      # (nv,) int32 object index per vertex
    F_srf: torch.Tensor       # boundary facets, 3D (nf, 3), 2D (ne, 2) int32
    E_srf: torch.Tensor       # (ne, 2) int32 boundary edges (2D: F_srf)
    plan: assembly.IncidencePlan  # vertex <- (element, corner) slots
    models: Tuple[str, ...] = ()
    dim: int = 3

    @property
    def nv(self) -> int:
        return self.V0.shape[0]

    @property
    def nelem(self) -> int:
        return self.T.shape[0]

    @property
    def device(self) -> torch.device:
        return self.V0.device


def mesh_from_arrays(
    *, V0, T, dphidX, vols, mass_coeff, mass_lumped, mass_diag, free_mask,
    mu, lam, model_id, ext_force, obj_id, F_srf, E_srf, models, dtype, device,
) -> MeshData:
    """MeshData from host arrays already in their final values (cast to
    `dtype` on `device`); builds the incidence plan from T."""
    T = np.asarray(T, np.int32)
    dim = np.asarray(V0).shape[1]
    if T.ndim != 2 or (T.shape[1], dim) not in ((4, 3), (3, 2)):
        raise NotImplementedError(
            "only 3D linear tets and 2D linear triangles are ported")

    def f(a):
        return torch.tensor(np.asarray(a), dtype=dtype, device=device)

    return MeshData(
        V0=f(V0),
        T=torch.tensor(T, device=device),
        dphidX=f(dphidX),
        vols=f(vols),
        mass_coeff=f(mass_coeff),
        mass_lumped=f(mass_lumped),
        mass_diag=f(mass_diag),
        free_mask=f(free_mask),
        mu=f(mu),
        lam=f(lam),
        model_id=torch.tensor(np.asarray(model_id, np.int32), device=device),
        ext_force=f(ext_force),
        obj_id=torch.tensor(np.asarray(obj_id, np.int32), device=device),
        F_srf=torch.tensor(np.asarray(F_srf, np.int32).reshape(-1, dim),
                           device=device),
        E_srf=torch.tensor(np.asarray(E_srf, np.int32).reshape(-1, 2),
                           device=device),
        plan=assembly.build_incidence_plan(T, len(np.asarray(V0)), device),
        models=tuple(models),
        dim=dim,
    )


def build_mesh_data(
    V: np.ndarray,
    T: np.ndarray,
    *,
    density: np.ndarray,
    mu: np.ndarray,
    lam: np.ndarray,
    model_id: np.ndarray,
    models: Tuple[str, ...],
    is_fixed: np.ndarray,
    ext_force: np.ndarray,
    obj_id: np.ndarray | None = None,
    dtype=torch.float64,
    device="cuda",
) -> MeshData:
    """Build MeshData from host arrays (f64 precompute, then cast to
    `dtype` on `device`): tets with V (nv, 3), triangles with V (nv, 2)."""
    dev = resolve_device(device)
    V = np.asarray(V, dtype=np.float64)
    T = np.asarray(T, dtype=np.int32)
    E = len(T)
    if V.shape[1] == 3:
        vols = disc.tet_volumes(V, T)
        dphidX = disc.tet_dphidX(V, T)
    else:
        vols = disc.tri_double_areas(V, T)
        dphidX = disc.tri2d_dphidX(V, T)
    density = np.broadcast_to(np.asarray(density, np.float64), (E,))
    mass_coeff = disc.consistent_mass_coeff(vols, density, T.shape[1])
    lumped = np.zeros(len(V))
    np.add.at(lumped, T.reshape(-1), mass_coeff.sum(axis=2).reshape(-1))
    mdiag = np.zeros(len(V))
    np.add.at(
        mdiag, T.reshape(-1), np.diagonal(mass_coeff, axis1=1, axis2=2).reshape(-1)
    )
    F_srf = disc.boundary_facets(T)
    return mesh_from_arrays(
        V0=V, T=T, dphidX=dphidX, vols=vols, mass_coeff=mass_coeff,
        mass_lumped=lumped, mass_diag=mdiag,
        free_mask=(~np.asarray(is_fixed, bool)).astype(np.float64),
        mu=np.broadcast_to(mu, (E,)), lam=np.broadcast_to(lam, (E,)),
        model_id=np.broadcast_to(model_id, (E,)), ext_force=ext_force,
        obj_id=np.zeros(len(V)) if obj_id is None else obj_id,
        F_srf=F_srf, E_srf=disc.edges(F_srf) if V.shape[1] == 3 else F_srf,
        models=models, dtype=dtype, device=dev,
    )


def def_grad(mesh: MeshData, x: torch.Tensor) -> torch.Tensor:
    """Deformation gradients (E, d, d): F[r, c] = sum_k x[T[e,k], r] dphidX[e, k, c]."""
    xe = x[mesh.T]
    return torch.einsum("ekr,ekc->erc", xe, mesh.dphidX)


def def_grad_adjoint(mesh: MeshData, Y: torch.Tensor, plan=None) -> torch.Tensor:
    """Adjoint of def_grad: (E, d, d) co-gradients -> (nv, d), J^T y. The
    corner rows dphidX Y^T are summed per vertex in a fixed order: over a
    banded plan (K4 on the card) when `plan` is one, else over the mesh's
    incidence plan (K2)."""
    from mixedfem_tpu_torch.solvers import operator as opmod

    return opmod.assemble(mesh, plan,
                          torch.einsum("ekc,erc->ekr", mesh.dphidX, Y))


def mass_matvec(mesh: MeshData, x: torch.Tensor) -> torch.Tensor:
    """Consistent mass product M x, matrix-free (nv, d) -> (nv, d)."""
    ye = torch.einsum("ekl,eld->ekd", mesh.mass_coeff, x[mesh.T])
    return assembly.segment_sum(mesh.plan, ye)


def project_free(mesh: MeshData, x: torch.Tensor) -> torch.Tensor:
    """Zero out rows at pinned vertices."""
    return x * mesh.free_mask[:, None]
