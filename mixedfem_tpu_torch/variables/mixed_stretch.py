"""MixedStretch, the per-element symmetric stretch variable
(port of mixedfem_tpu/variables/mixed_stretch.py: tets, triangles, shells
and rods; N = 6 in 3D, 3 in 2D).

Per Newton iteration `update` produces the coefficients of the condensed
SPD system:

  G[e]  = ds/dF . dphi/dx          (N x k x d constraint jacobian)
  H[e]  = psd_fix(h^2 psi''(s))    (N x N)
  g[e]  = h^2 psi'(s)              (N,)
  Sv[e] = sym-vec of S(x)          (N,)
  Gw[e] = sqrt(vol) H^1/2 G        (A_e = Gw^T Gw)

and the condensed system is
  element stiffness   A_e  = vol_e G^T H G
  rhs                 b_e  = -vol_e G^T (H (Sv - s) + g)
  local solve         ds_e = (Sv - s) + G : dx_e,  la_e = Syminv (H ds_e + g)
"""

from __future__ import annotations

import dataclasses

import torch

from mixedfem_tpu_torch.materials import models as mat
from mixedfem_tpu_torch.mesh import mesh as meshmod
from mixedfem_tpu_torch.mesh import rod as rodmod
from mixedfem_tpu_torch.ops import assembly, psd, rotation, smallops, sym


@dataclasses.dataclass
class StretchCoeffs:
    """Per-Newton-iteration linearization data (all per-element)."""

    G: torch.Tensor          # (E, N, k, d) ds/dx element jacobian
    Gw: torch.Tensor         # (E, N, k, d) sqrt(vol) H^{1/2} G
    H: torch.Tensor          # (E, N, N) PSD-fixed h^2 psi''
    Hinv: torch.Tensor       # (E, N, N)
    g: torch.Tensor          # (E, N) h^2 psi'
    Sv: torch.Tensor         # (E, N) current stretch of F(x)
    R: torch.Tensor          # (E, d, d) rotations
    max_evals: torch.Tensor  # (E,) max clamped eigenvalue


def stretch_of_x(mesh: meshmod.MeshData, x: torch.Tensor):
    """Polar stretch sym-vec of the current deformation (E, N), and R."""
    R, S = rotation.polar(meshmod.def_grad(mesh, x), mesh.dim)
    return sym.pack(S), R


def _material_terms(s, mu, lam, model_id, models, dt):
    h2 = dt * dt
    H, Hinv, Hs, evals = psd.psd_fix_sqrt(
        h2 * mat.hess_s_all(s, mu, lam, model_id, models), tol=1e-8
    )
    g = h2 * mat.grad_s_all(s, mu, lam, model_id, models)
    return H, Hinv, Hs, evals, g


def coeffs_from_FG(F, G, R, Sv, s, vols, mu, lam, model_id, models, dt):
    """Coefficient build from a precomputed G (the JAX package's shared
    entry for its vertex-partitioned path, and the shells' and rods'):
    Gw = sqrt(vol) Hs G by smallops.contract_Gw, kernel K7 on the card
    (its shell and rod instances; a solid's G and Gw come from K3 in
    `update`). F is unused, as there."""
    H, Hinv, Hs, evals, g = _material_terms(s, mu, lam, model_id, models, dt)
    Gw = smallops.contract_Gw(Hs, G, vols)
    return StretchCoeffs(
        G=G, Gw=Gw, H=H, Hinv=Hinv, g=g, Sv=Sv, R=R, max_evals=evals
    )


def update(mesh: meshmod.MeshData, x: torch.Tensor, s: torch.Tensor, dt,
           R_prev: torch.Tensor | None = None):
    """Rotations and derivatives at (x, s). For solids G and Gw come from
    one fused per-element pass (smallops.contract_G_Gw, kernel K3 on the
    card). For shells and rods G = D : dF/dx, the Jacobian of their F
    (mesh.shell_def_grad_jacobian, rod.rod_def_grad_jacobian), and Gw comes
    from coeffs_from_FG (K7). R_prev (E, 3, 3) seeds the warm-started
    polar (rotation.polar_warm) in 3D, shells and rods included, whose F is
    3x3; without it, or in 2D, the polar is the stateless one."""
    F = meshmod.def_grad(mesh, x)
    if R_prev is not None and mesh.dim == 3:
        R, S = rotation.polar_warm(F, R_prev)
    else:
        R, S = rotation.polar(F, mesh.dim)
    Sv = sym.pack(S)
    D = rotation.dsdF(R, S, mesh.dim)                      # (E, N, d, d)
    if mesh.shell or mesh.rod:
        if mesh.shell:
            JT = meshmod.shell_def_grad_jacobian(mesh, x)  # (E, k, r, a, c)
        else:
            JT = rodmod.rod_def_grad_jacobian(x, *meshmod._rod_args(mesh))
        G = torch.einsum("eiac,ekrac->eikr", D, JT)
        return coeffs_from_FG(F, G, R, Sv, s, mesh.vols, mesh.mu, mesh.lam,
                              mesh.model_id, mesh.models, dt)
    H, Hinv, Hs, evals, g = _material_terms(
        s, mesh.mu, mesh.lam, mesh.model_id, mesh.models, dt
    )
    G, Gw = smallops.contract_G_Gw(D, mesh.dphidX, Hs, mesh.vols)
    return StretchCoeffs(
        G=G, Gw=Gw, H=H, Hinv=Hinv, g=g, Sv=Sv, R=R, max_evals=evals
    )


def rhs_contrib(mesh: meshmod.MeshData, c: StretchCoeffs, s: torch.Tensor):
    """Per-element-corner rhs contributions (E, k, d) (pre-assembly)."""
    y = torch.einsum("eij,ej->ei", c.H, c.Sv - s) + c.g
    return -torch.einsum("eikr,ei,e->ekr", c.G, y, mesh.vols)


def rhs(mesh: meshmod.MeshData, c: StretchCoeffs, s: torch.Tensor):
    """Condensed-system right-hand side (nv, d), summed per vertex over the
    mesh's incidence plan (K2 on the card), zero at pinned vertices."""
    return meshmod.project_free(
        mesh, assembly.segment_sum(mesh.plan, rhs_contrib(mesh, c, s)))


def diag_blocks_contrib(mesh: meshmod.MeshData, c: StretchCoeffs):
    """Per-corner (d, d) diagonal-block contributions (E, k, d, d)."""
    return torch.einsum("eikr,eiks->ekrs", c.Gw, c.Gw)


def diag_blocks(mesh: meshmod.MeshData, c: StretchCoeffs):
    """Per-vertex (d, d) diagonal blocks of the stretch stiffness, summed
    over the mesh's incidence plan (K2 on the card)."""
    return assembly.segment_sum(mesh.plan, diag_blocks_contrib(mesh, c))


def local_solve(
    mesh: meshmod.MeshData, c: StretchCoeffs, s: torch.Tensor, dx: torch.Tensor
):
    """Recover (ds, la) from the displacement update dx (nv, d):
    ds = (S(x) - s) + G : dx,  la = Syminv (H ds + g)."""
    ds = (c.Sv - s) + torch.einsum("eikr,ekr->ei", c.G, dx[mesh.T])
    syminv = sym.syminv_weights(mesh.dim, dtype=s.dtype, device=s.device)
    la = syminv * (torch.einsum("eij,ej->ei", c.H, ds) + c.g)
    return ds, la


def gradient_x(mesh: meshmod.MeshData, c: StretchCoeffs, la: torch.Tensor):
    """x-gradient of the constraint term, vol G^T (Sym la) summed per vertex
    over the mesh's incidence plan (K2 on the card), masked (nv, d)."""
    w = sym.sym_weights(mesh.dim, dtype=la.dtype, device=la.device)
    y = torch.einsum("eikr,ei,e->ekr", c.G, w * la, mesh.vols)
    return meshmod.project_free(mesh, assembly.segment_sum(mesh.plan, y))


def energy(mesh: meshmod.MeshData, s: torch.Tensor):
    """Elastic energy sum_e vol psi(s_e), unscaled by h^2."""
    e = mat.psi_s_all(s, mesh.mu, mesh.lam, mesh.model_id, mesh.models)
    return torch.sum(mesh.vols * e)


def constraint_value(
    mesh: meshmod.MeshData, x: torch.Tensor, s: torch.Tensor, la: torch.Tensor,
    Sv: torch.Tensor | None = None,
):
    """sum_e vol la^T Sym (S(x) - s); pass `Sv` when S(x) is already known
    at this x to skip the polar decomposition."""
    if Sv is None:
        Sv, _ = stretch_of_x(mesh, x)
    w = sym.sym_weights(mesh.dim, dtype=s.dtype, device=s.device)
    return torch.sum(mesh.vols * torch.einsum("ei,ei->e", la, w * (Sv - s)))


def reset(mesh: meshmod.MeshData, x: torch.Tensor):
    """Initial (s, la) from the initial positions."""
    Sv, _ = stretch_of_x(mesh, x)
    return Sv, torch.zeros_like(Sv)
