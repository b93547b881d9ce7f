"""MeshData and its element-level operations (port of
mixedfem_tpu/mesh/mesh.py): 3D linear tets, 2D linear triangles, shells
(3D triangle membranes, `shell`) and rods (3D segments, `rod`,
mesh/rod.py).

Everything is matrix-free: deformation gradients are per-element gathers
plus small contractions, and every element-to-vertex sum goes through the
mesh's static incidence plan (ops/assembly.py, kernel K2 on the card).
A shell's F adds the outer product of the current unit normal with the
rest normal to its in-plane part; a rod's is mesh/rod.py's. Their
Jacobians dF/dx (shell_def_grad_jacobian, rod.rod_def_grad_jacobian) give
the mixed-stretch G.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from mixedfem_tpu_torch.device import resolve_device
from mixedfem_tpu_torch.mesh import discretization as disc
from mixedfem_tpu_torch.mesh import rod as rodmod
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
    # shells: (E, 3) rest normals; rods: rest frame rows [t0; N0; B0]
    # (E, 3, 3) and rest lengths (E,); None otherwise
    rest_normal: Optional[torch.Tensor] = None
    rod_frames: Optional[torch.Tensor] = None
    rod_L: Optional[torch.Tensor] = None
    shell: bool = False
    rod: bool = False

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
    shell=False, rod=False, rest_normal=None, rod_frames=None, rod_L=None,
) -> MeshData:
    """MeshData from host arrays already in their final values (cast to
    `dtype` on `device`); builds the incidence plan from T. Solids are tets
    (k=4) in 3D and triangles (k=3) in 2D; `shell` takes triangles in 3D
    with their rest normals, `rod` segments (k=2) in 3D with their rest
    frames and lengths."""
    T = np.asarray(T, np.int32)
    dim = np.asarray(V0).shape[1]
    shape = (T.shape[1], dim) if T.ndim == 2 else None
    want = (3, 3) if shell else (2, 3) if rod else None
    if shell and rod:
        raise ValueError("a mesh is a shell or a rod, not both")
    if want is not None and shape != want:
        raise ValueError(f"{'shells' if shell else 'rods'} take elements of "
                         f"{want[0]} corners in 3D, got {shape}")
    if want is None and shape not in ((4, 3), (3, 2)):
        raise NotImplementedError(
            f"elements of shape {shape}: solids are 3D tets and 2D "
            "triangles; 3D triangles are shells (shell=True) and 3D "
            "segments rods (rod=True)")

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
        rest_normal=f(rest_normal) if shell else None,
        rod_frames=f(rod_frames) if rod else None,
        rod_L=f(rod_L) if rod else None,
        shell=bool(shell),
        rod=bool(rod),
    )


def _lumped_and_diag(nv, T, mass_coeff):
    lumped = np.zeros(nv)
    np.add.at(lumped, T.reshape(-1), mass_coeff.sum(axis=2).reshape(-1))
    mdiag = np.zeros(nv)
    np.add.at(
        mdiag, T.reshape(-1), np.diagonal(mass_coeff, axis1=1, axis2=2).reshape(-1)
    )
    return lumped, mdiag


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
    shell: bool = False,
    thickness: float = 1e-3,
) -> MeshData:
    """Build MeshData from host arrays (f64 precompute, then cast to
    `dtype` on `device`): tets with V (nv, 3), triangles with V (nv, 2), or
    with `shell` 3D triangle membranes of `thickness` (volumes are double
    areas x thickness / 2; the surface is the shell itself)."""
    dev = resolve_device(device)
    V = np.asarray(V, dtype=np.float64)
    T = np.asarray(T, dtype=np.int32)
    E = len(T)
    rest_normal = None
    if shell:
        if V.shape[1] != 3 or T.shape[1] != 3:
            raise ValueError("shells are triangles in 3D")
        vols = disc.tri_double_areas(V, T) * (thickness / 2.0)
        dphidX = disc.tri3d_dphidX(V, T)
        rest_normal = disc.tri3d_rest_normals(V, T)
    elif V.shape[1] == 3:
        vols = disc.tet_volumes(V, T)
        dphidX = disc.tet_dphidX(V, T)
    else:
        vols = disc.tri_double_areas(V, T)
        dphidX = disc.tri2d_dphidX(V, T)
    density = np.broadcast_to(np.asarray(density, np.float64), (E,))
    mass_coeff = disc.consistent_mass_coeff(vols, density, T.shape[1],
                                            shell=shell)
    lumped, mdiag = _lumped_and_diag(len(V), T, mass_coeff)
    if shell:
        F_srf, E_srf = T.copy(), disc.edges(T)
    else:
        F_srf = disc.boundary_facets(T)
        E_srf = disc.edges(F_srf) if V.shape[1] == 3 else F_srf
    return mesh_from_arrays(
        V0=V, T=T, dphidX=dphidX, vols=vols, mass_coeff=mass_coeff,
        mass_lumped=lumped, mass_diag=mdiag,
        free_mask=(~np.asarray(is_fixed, bool)).astype(np.float64),
        mu=np.broadcast_to(mu, (E,)), lam=np.broadcast_to(lam, (E,)),
        model_id=np.broadcast_to(model_id, (E,)), ext_force=ext_force,
        obj_id=np.zeros(len(V)) if obj_id is None else obj_id,
        F_srf=F_srf, E_srf=E_srf, models=models, dtype=dtype, device=dev,
        shell=shell, rest_normal=rest_normal,
    )


def build_rod_mesh_data(
    V: np.ndarray,
    E: np.ndarray,
    *,
    density: np.ndarray,
    mu: np.ndarray,
    lam: np.ndarray,
    model_id: np.ndarray,
    models: Tuple[str, ...],
    is_fixed: np.ndarray,
    ext_force: np.ndarray,
    radius: float = 1e-2,
    dtype=torch.float64,
    device="cuda",
) -> MeshData:
    """Build MeshData of rods, segments E (nseg, 2) over V (nv, 3) of
    circular cross-section `radius`: volumes are pi r^2 L, dphidX the
    linear-stretch rows (-t0/L, t0/L), and the rest frames of mesh/rod.py
    ride along. Rods have no faces; their edges are the segments."""
    dev = resolve_device(device)
    V = np.asarray(V, np.float64)
    E = np.asarray(E, np.int32)
    if V.shape[1] != 3 or E.ndim != 2 or E.shape[1] != 2:
        raise ValueError("rods are segments in 3D")
    t0, L, N0, B0 = rodmod.rod_rest_frames(V, E)
    vols = np.pi * radius * radius * L
    dphidX = np.stack([-t0 / L[:, None], t0 / L[:, None]], axis=1)
    density = np.broadcast_to(np.asarray(density, np.float64), (len(E),))
    mass_coeff = rodmod.rod_mass_coeff(L, density, radius)
    lumped, mdiag = _lumped_and_diag(len(V), E, mass_coeff)
    n = len(E)
    return mesh_from_arrays(
        V0=V, T=E, dphidX=dphidX, vols=vols, mass_coeff=mass_coeff,
        mass_lumped=lumped, mass_diag=mdiag,
        free_mask=(~np.asarray(is_fixed, bool)).astype(np.float64),
        mu=np.broadcast_to(mu, (n,)), lam=np.broadcast_to(lam, (n,)),
        model_id=np.broadcast_to(model_id, (n,)), ext_force=ext_force,
        obj_id=np.zeros(len(V)), F_srf=np.zeros((0, 3), np.int32), E_srf=E,
        models=models, dtype=dtype, device=dev, rod=True,
        rod_frames=np.stack([t0, N0, B0], axis=1), rod_L=L,
    )


def _face_normals(xe: torch.Tensor):
    """(E, 3, 3) shell element corners -> (unit normal (E, 3), unnormalized
    normal, its length, the edges v1 and v2)."""
    v1 = xe[:, 1] - xe[:, 0]
    v2 = xe[:, 2] - xe[:, 0]
    nr = torch.linalg.cross(v1, v2, dim=-1)
    ln = torch.sqrt(torch.sum(nr * nr, dim=-1) + 1e-30)
    return nr / ln[:, None], nr, ln, v1, v2


def _rod_args(mesh: MeshData):
    f = mesh.rod_frames
    return mesh.T, f[:, 0], f[:, 1], f[:, 2], mesh.rod_L


def def_grad(mesh: MeshData, x: torch.Tensor) -> torch.Tensor:
    """Deformation gradients (E, d, d). Solids: F[r, c] = sum_k x[T[e,k],
    r] dphidX[e, k, c]. Shells: that plus n(x) N_rest^T. Rods:
    rod.rod_def_grad."""
    if mesh.rod:
        return rodmod.rod_def_grad(x, *_rod_args(mesh))
    xe = x[mesh.T]
    F = torch.einsum("ekr,ekc->erc", xe, mesh.dphidX)
    if mesh.shell:
        n = _face_normals(xe)[0]
        F = F + n[:, :, None] * mesh.rest_normal[:, None, :]
    return F


def _skew(v: torch.Tensor) -> torch.Tensor:
    z = torch.zeros_like(v[..., 0])
    return torch.stack([
        torch.stack([z, -v[..., 2], v[..., 1]], dim=-1),
        torch.stack([v[..., 2], z, -v[..., 0]], dim=-1),
        torch.stack([-v[..., 1], v[..., 0], z], dim=-1),
    ], dim=-2)


def shell_def_grad_jacobian(mesh: MeshData, x: torch.Tensor) -> torch.Tensor:
    """(E, k, r, a, c) tensor dF_ac/dx_kr of shells at x: the in-plane part
    delta_ar dphidX[k, c] plus (P dn/dx_kr / |n|)_a N_rest[c], P = I - n
    n^T, with dn/dx from the cross-product matrices of the edges."""
    xe = x[mesh.T]
    n, _, ln, v1, v2 = _face_normals(xe)
    eye = torch.eye(3, dtype=x.dtype, device=x.device)
    P = eye - n[:, :, None] * n[:, None, :]
    dx1, dx2 = _skew(v1), _skew(v2)
    # dn/dq per corner: corner 0 dx2 - dx1, corner 1 -dx2, corner 2 dx1;
    # rows are the normal's components, columns the coordinates
    dndq = torch.stack([dx2 - dx1, -dx2, dx1], dim=1)   # (E, k, 3, 3)
    dn = torch.einsum("eab,ekbr,e->ekra", P, dndq, 1.0 / ln)
    base = eye[None, None, :, :, None] * mesh.dphidX[:, :, None, None, :]
    shellterm = dn[:, :, :, :, None] * mesh.rest_normal[:, None, None, None, :]
    return base + shellterm


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


def safe_vols(mesh: MeshData) -> torch.Tensor:
    """The element volumes with 1 in place of 0: the divisor of the paths
    that divide by an element's volume. The padded elements of a rank's
    slice (parallel/sharding.py) have zero volume and zero rows, which then
    stay zero instead of becoming 0/0; a real element's volume is
    positive and kept as it is."""
    return torch.where(mesh.vols > 0, mesh.vols, torch.ones_like(mesh.vols))


def project_free(mesh: MeshData, x: torch.Tensor) -> torch.Tensor:
    """Zero out rows at pinned vertices."""
    return x * mesh.free_mask[:, None]
