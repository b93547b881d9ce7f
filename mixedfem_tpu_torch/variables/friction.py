"""Lagged IPC friction, a displacement-only variable (port of
mixedfem_tpu/variables/friction.py).

Once per step the friction set is built from the PRE-STEP positions V0:
the active contacts (D < dhat) with lagged normal forces
N = -kappa 2 d b'(d^2, dhat^2), tangent bases and closest-point weights.
During the step the potential depends on U = V - V0:

  E = sum_i mu N_i f0(||Tan_i^T u_i||, epsv h),  u_i = sum_k w_ik U[v_ik]

with the C^1 smoother f0(y) = -y^3/(3 e^2) + y^2/e + e/3 for y < e, else y.
The energy is divided by h^2 (the optimizer multiplies it back); gradient
and PSD-projected Hessian come from torch.func autodiff of the potential
and are summed to the vertices through the contact frames' plan
(variables/collision.py).
"""

from __future__ import annotations

import dataclasses

import torch

from mixedfem_tpu_torch.collision import barrier as bar
from mixedfem_tpu_torch.collision import distances as dist
from mixedfem_tpu_torch.ops import assembly
from mixedfem_tpu_torch.variables import collision as vcol
from mixedfem_tpu_torch.variables.collision import NodalCoeffs
from mixedfem_tpu_torch.variables.mixed_collision import ContactFrames


@dataclasses.dataclass
class FrictionFrames:
    """Lagged per-step friction data of the n real contact frames, built at
    V0 once per step."""

    frames: torch.Tensor  # (n, 4) int32
    w: torch.Tensor       # (n, 4) closest-point relative-displacement weights
    basis: torch.Tensor   # (n, 3, 2) tangent basis at V0
    N: torch.Tensor       # (n,) lagged normal force magnitude (>= 0)
    active: torch.Tensor  # (n,) mask
    V0: torch.Tensor      # (n, 4, 3) pre-step frame positions
    plan: assembly.IncidencePlan  # the contact frames' plan

    @property
    def nreal(self) -> int:
        return self.plan.nrows // 4


def _tangent_basis(n):
    """(..., 3) unit normal -> (..., 3, 2) orthonormal tangent basis."""
    ex = torch.zeros_like(n)
    ex[..., 0] = 1.0
    ey = torch.zeros_like(n)
    ey[..., 1] = 1.0
    ref = torch.where((n[..., 0].abs() > 0.9)[..., None], ey, ex)
    t0 = torch.linalg.cross(n, ref)
    t0 = t0 / torch.clamp(torch.linalg.vector_norm(t0, dim=-1, keepdim=True),
                          min=1e-30)
    return torch.stack([t0, torch.linalg.cross(n, t0)], dim=-1)


def build(mesh, cf: ContactFrames, x0, dhat: float, kappa: float
          ) -> FrictionFrames:
    """The lagged friction set at the pre-step positions x0."""
    frames, ftype = cf.real()
    verts = x0[frames]
    D = dist.frame_distance(verts, ftype)
    active = (D < dhat).to(x0.dtype)
    N = -kappa * 2.0 * D * bar.barrier_gradient(D * D, dhat * dhat)
    return FrictionFrames(
        frames=cf.frames[:cf.nreal], w=dist.frame_contact_weights(verts, ftype),
        basis=_tangent_basis(dist.frame_normal(verts, ftype)),
        N=torch.clamp(N, min=0.0) * active, active=active, V0=verts,
        plan=cf.plan,
    )


def _f0(y, eps):
    """The IPC smooth friction potential."""
    inside = y < eps
    ys = torch.where(inside, y, eps)
    return torch.where(inside, -(ys ** 3) / (3 * eps * eps) + ys * ys / eps
                       + eps / 3.0, y)


def _potential(vframe, w, basis, N, V0, mu, epsv_h):
    """Friction potential of frames (..., 4, 3) as a function of their
    vertices."""
    u = torch.sum(w[..., :, None] * (vframe - V0), dim=-2)
    ut = torch.sum(basis * u[..., :, None], dim=-2)
    y = torch.sqrt(torch.sum(ut * ut, dim=-1) + 1e-30)
    return mu * N * _f0(y, epsv_h)


def energy(ff: FrictionFrames, x, mu: float, epsv_h: float, dt: float):
    """Potential / dt^2."""
    e = _potential(x[ff.frames.long()], ff.w, ff.basis, ff.N, ff.V0, mu,
                   epsv_h)
    return torch.sum(e * ff.active) / (dt * dt)


def update(ff: FrictionFrames, x, mu: float, epsv_h: float) -> NodalCoeffs:
    verts = x[ff.frames.long()]
    C = verts.shape[0]

    def potential(vflat, w, basis, N, V0):
        return _potential(vflat.reshape(4, 3), w, basis, N, V0, mu, epsv_h)

    g, H = vcol.grad_hess(potential, verts.reshape(C, 12), ff.w, ff.basis,
                          ff.N, ff.V0)
    af = ff.active
    return NodalCoeffs(g=(g * af[:, None]).reshape(C, 4, 3),
                       H=H * af[:, None, None])


gradient = vcol.gradient
matvec = vcol.matvec
diag_blocks = vcol.diag_blocks
