"""Displacement variable: inertia target, energy, gradient and its
per-corner contributions (port of mixedfem_tpu/variables/displacement.py).

The inertia term is 1/2 ||x - x_tilde - h^2 f_ext||^2_M with the full
consistent mass matrix; the blend factor applies to the gradient only.
"""

from __future__ import annotations

import torch

from mixedfem_tpu_torch.integrators import bdf as bdfmod
from mixedfem_tpu_torch.mesh import mesh as meshmod


def target(mesh: meshmod.MeshData, bdf: bdfmod.BDFState, blend: float = 1.0):
    """x_tilde + dt^2 * blend * f_ext (nv, d)."""
    dt = bdfmod.bdf_dt(bdf)
    return bdfmod.bdf_x_tilde(bdf) + (dt * dt * blend) * mesh.ext_force


def energy(mesh: meshmod.MeshData, bdf: bdfmod.BDFState, x: torch.Tensor):
    """1/2 ||x - x_tilde - dt^2 f||^2_M over all dofs, reduced per element
    (sum_e diff_e^T Mc_e diff_e), so it needs no scatter."""
    de = (x - target(mesh, bdf, blend=1.0))[mesh.T]
    return 0.5 * torch.sum(torch.einsum("ekd,ekl,eld->e", de, mesh.mass_coeff, de))


def gradient(
    mesh: meshmod.MeshData, bdf: bdfmod.BDFState, x: torch.Tensor, blend: float = 1.0
):
    """Masked inertia gradient P M (x - target) (nv, d); the vertex sum
    runs over the mesh's incidence plan (K2 on the card)."""
    diff = x - target(mesh, bdf, blend)
    return meshmod.project_free(mesh, meshmod.mass_matvec(mesh, diff))


def gradient_contrib(
    mesh: meshmod.MeshData, bdf: bdfmod.BDFState, x: torch.Tensor, blend: float = 1.0
):
    """Per-element-corner contributions (E, k, d) of M (x - target); their
    assembly, masked, is the inertia gradient."""
    diff = x - target(mesh, bdf, blend)
    return torch.einsum("ekl,eld->ekd", mesh.mass_coeff, diff[mesh.T])
