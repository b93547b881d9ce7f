"""The vanilla stretch variable: displacement-only elasticity in F-space,
the non-mixed baseline (port of mixedfem_tpu/variables/stretch.py).

Per element H = h^2 vol Jloc^T psi''(F) Jloc and g = h^2 vol Jloc^T
psi'(F), with F-space densities from materials/models.py. Every vertex sum
runs through mesh.def_grad_adjoint or operator.assemble: K2 over the
mesh's incidence plan, or K4 over a banded plan when `plan` is one (m=3
for gradients and products, m=9 for the diagonal blocks). The convergence
harness reads the vanilla gradient norm at the mixed iterates
(gradient_at).
"""

from __future__ import annotations

import dataclasses

import torch

from mixedfem_tpu_torch.materials import models as mat
from mixedfem_tpu_torch.mesh import mesh as meshmod
from mixedfem_tpu_torch.solvers import operator as opmod


@dataclasses.dataclass
class VanillaCoeffs:
    g: torch.Tensor   # (E, d, d) h^2 vol psi'(F)
    H: torch.Tensor   # (E, d*d, d*d) h^2 vol psi''(F), row-major F order


def update(mesh: meshmod.MeshData, x: torch.Tensor, dt) -> VanillaCoeffs:
    F = meshmod.def_grad(mesh, x)
    h2v = (dt * dt) * mesh.vols
    g = mat.grad_F_all(F, mesh.mu, mesh.lam, mesh.model_id, mesh.models)
    H = mat.hess_F_all(F, mesh.mu, mesh.lam, mesh.model_id, mesh.models)
    return VanillaCoeffs(g=h2v[:, None, None] * g, H=h2v[:, None, None] * H)


def energy(mesh: meshmod.MeshData, x: torch.Tensor):
    """sum_e vol psi(F_e), unscaled by h^2 (the optimizer applies it)."""
    F = meshmod.def_grad(mesh, x)
    e = mat.psi_F_all(F, mesh.mu, mesh.lam, mesh.model_id, mesh.models)
    return torch.sum(mesh.vols * e)


def gradient(mesh: meshmod.MeshData, c: VanillaCoeffs, plan=None):
    """Assembled masked gradient (nv, d)."""
    return meshmod.project_free(mesh, meshmod.def_grad_adjoint(mesh, c.g, plan))


def gradient_at(mesh: meshmod.MeshData, x: torch.Tensor, dt, plan=None):
    """The h^2-scaled elastic gradient at x (no Hessian), masked."""
    F = meshmod.def_grad(mesh, x)
    g = mat.grad_F_all(F, mesh.mu, mesh.lam, mesh.model_id, mesh.models)
    h2v = (dt * dt) * mesh.vols
    return meshmod.project_free(
        mesh, meshmod.def_grad_adjoint(mesh, h2v[:, None, None] * g, plan))


def matvec(mesh: meshmod.MeshData, c: VanillaCoeffs, p: torch.Tensor,
           plan=None):
    """Elastic-Hessian product P (sum_e J^T H J) P^T p."""
    p = meshmod.project_free(mesh, p)
    out = opmod.assemble(mesh, plan, opmod.vanilla_rows(mesh, c.H, p[mesh.T]))
    return meshmod.project_free(mesh, out)


def diag_blocks(mesh: meshmod.MeshData, c: VanillaCoeffs, plan=None):
    """Per-vertex (d, d) diagonal blocks of the elastic Hessian:
    block_k[r, r'] = sum_{c, c'} dphidX[k,c] H[(r,c),(r',c')] dphidX[k,c']."""
    d = mesh.dim
    Hm = c.H.reshape(c.H.shape[0], d, d, d, d)  # [r, c, r', c']
    B = torch.einsum("ekc,ercsf,ekf->ekrs", mesh.dphidX, Hm, mesh.dphidX)
    return opmod.assemble(mesh, plan, B)
