"""Displacement-only IPC collision barrier (port of
mixedfem_tpu/variables/collision.py).

Per active frame the potential kappa b(D(x)^2, dhat^2); the energy is
divided by h^2 (the optimizer multiplies it back), the gradient and the
PSD-projected Hessian enter the system unscaled. Gradient and Hessian are
torch.func autodiff of the frame potential, batched over frames with vmap.

The vertex sums of this module (gradient, matvec, diag_blocks) take any
frame set with `frames` and a frame incidence `plan` (ContactFrames, or
friction's FrictionFrames) and sum through that plan in a fixed order (K2
on the card).
"""

from __future__ import annotations

import dataclasses

import torch

from mixedfem_tpu_torch.collision import barrier as bar
from mixedfem_tpu_torch.collision import distances as dist
from mixedfem_tpu_torch.mesh import mesh as meshmod
from mixedfem_tpu_torch.ops import assembly
from mixedfem_tpu_torch.ops import psd
from mixedfem_tpu_torch.variables.mixed_collision import ContactFrames


def energy(cf: ContactFrames, x, dhat: float, kappa: float, dt: float):
    frames, ftype = cf.real()
    D = dist.frame_distance(x[frames], ftype)
    e = kappa * torch.sum(bar.barrier(D * D, dhat * dhat) * (D < dhat)) / (dt * dt)
    return torch.where(torch.any(D <= 0), torch.full_like(e, 1e30), e)


@dataclasses.dataclass
class NodalCoeffs:
    """Per real frame (n of them)."""

    g: torch.Tensor  # (n, 4, d) potential gradient
    H: torch.Tensor  # (n, 4d, 4d) PSD-projected Hessian


def grad_hess(potential, vflat, *args):
    """Per-frame gradient (n, 4d) and PSD-projected Hessian (n, 4d, 4d) of
    potential(v (4d,), *per-frame args) at vflat (n, 4d)."""
    g = torch.func.vmap(torch.func.grad(potential))(vflat, *args)
    H = torch.func.vmap(torch.func.hessian(potential))(vflat, *args)
    return g, psd.psd_project(H, tol=0.0, sweeps=6)


def update(cf: ContactFrames, x, dhat: float, kappa: float) -> NodalCoeffs:
    frames, ftype = cf.real()
    verts = x[frames]
    n, k, d = verts.shape
    D = dist.frame_distance(verts, ftype)
    act = (D < dhat).to(x.dtype)

    def potential(vflat, ft):
        D1 = dist.frame_distance(vflat.reshape(k, d), ft)
        return kappa * bar.barrier(D1 * D1, dhat * dhat)

    g, H = grad_hess(potential, verts.reshape(n, k * d), ftype)
    return NodalCoeffs(g=(g * act[:, None]).reshape(n, k, d),
                       H=H * act[:, None, None])


def gradient(mesh, ff, c: NodalCoeffs) -> torch.Tensor:
    return meshmod.project_free(mesh, assembly.segment_sum(ff.plan, c.g))


def matvec(mesh, ff, c: NodalCoeffs, p) -> torch.Tensor:
    n, d = ff.nreal, mesh.dim
    pe = meshmod.project_free(mesh, p)[ff.frames[:n].long()].reshape(n, 4 * d)
    y = torch.sum(c.H * pe[:, None, :], dim=-1)  # products, not a bmm
    out = assembly.segment_sum(ff.plan, y.reshape(n, 4, d))
    return meshmod.project_free(mesh, out)


def diag_blocks(mesh, ff, c: NodalCoeffs) -> torch.Tensor:
    n, d = ff.nreal, mesh.dim
    Hm = c.H.reshape(n, 4, d, 4, d)
    B = torch.diagonal(Hm, dim1=1, dim2=3).permute(0, 3, 1, 2)  # (n, 4, d, d)
    return assembly.segment_sum(ff.plan, B)
