"""MixedCollision: IPC contact with a mixed per-frame distance variable
(port of mixedfem_tpu/variables/mixed_collision.py).

Per contact frame (padded to a capacity C): mixed distance d and multiplier
la, enforcing D(x) - d = 0 with the barrier on the MIXED distance,
psi(d) = kappa b(d^2, dhat^2). The condensed system's pieces are

  stiffness  A_c = Gx H Gx^T
  rhs        -Gx gl,  gl = H (D - d) + g
  local      delta_d = (D - d) + Gx : dx,  la = H delta_d + g

A candidate activates when its true distance D < dhat; an active frame
stays active (keeping d and la) while its mixed distance stays < dhat; a
newly active frame starts from d = D, la = 0.

The candidate arrays are padded to a capacity as in the JAX package (the
real frames first, then inert ones of mask 0), but nothing here computes on
the padded frames: the per-frame arrays (CollisionCoeffs, the mixed
distances and multipliers) hold the n real frames only, where the JAX
package's hold all C and leave the padded ones inert.

Every frame-to-vertex sum goes through the frame set's incidence plan
(ops/assembly.py; kernel K2 on the card), built on the host once per
candidate build over the real frames' corner rows, so the sums add in a
fixed order and use no atomics.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from mixedfem_tpu_torch.collision import barrier as bar
from mixedfem_tpu_torch.collision import distances as dist
from mixedfem_tpu_torch.mesh import mesh as meshmod
from mixedfem_tpu_torch.ops import assembly


@dataclasses.dataclass
class ContactFrames:
    """Padded per-step candidate set; the real frames come first."""

    frames: torch.Tensor  # (C, 4) int32 vertex ids (0-padded)
    ftype: torch.Tensor   # (C,) int32 distance type
    fmask: torch.Tensor   # (C,) 1.0 for real candidates
    plan: assembly.IncidencePlan  # vertex <- (frame, corner), real frames

    @property
    def nreal(self) -> int:
        return self.plan.nrows // 4

    def real(self):
        """(frames (n, 4) int64, ftype (n,)) of the real frames."""
        n = self.nreal
        return self.frames[:n].long(), self.ftype[:n]


def contact_frames(frames, ftype, fmask, nv: int, dtype, device) -> ContactFrames:
    """ContactFrames from padded host arrays (broadphase.pad_candidates),
    with the frame plan built over the real frames."""
    frames = np.asarray(frames, np.int32).reshape(-1, 4)
    fmask = np.asarray(fmask)
    n = int(np.count_nonzero(fmask > 0))
    if not (fmask[:n] > 0).all():
        raise ValueError("the real frames must come first")
    return ContactFrames(
        frames=torch.tensor(frames, device=device),
        ftype=torch.tensor(np.asarray(ftype, np.int32), device=device),
        fmask=torch.tensor(fmask, dtype=dtype, device=device),
        plan=assembly.build_incidence_plan(frames[:n], nv, device),
    )


@dataclasses.dataclass
class CollisionCoeffs:
    """Per real frame (n of them)."""

    D: torch.Tensor       # (n,) true distance at the current x
    Gx: torch.Tensor      # (n, 4, d) distance gradient
    g: torch.Tensor       # (n,) dpsi/dd (masked; mollifier-scaled if on)
    H: torch.Tensor       # (n,) d2psi/dd2 (clamped; mollifier-scaled if on)
    active: torch.Tensor  # (n,) float mask
    d: torch.Tensor       # (n,) mixed distances (new frames start at D)
    la: torch.Tensor      # (n,) multipliers (new frames zeroed)
    # EE-mollifier force kappa b(d^2) dm/dx (n, 4, 3); None when off (and
    # in 2D, where no edge-edge frame exists)
    gmf: Optional[torch.Tensor] = None


def update(mesh, cf: ContactFrames, x, d_prev, la_prev, active_prev,
           dhat: float, kappa: float, ee_mollifier: bool = False
           ) -> CollisionCoeffs:
    """Coefficients at x from the previous iteration's (n,) mixed
    distances, multipliers and active mask."""
    frames, ftype = cf.real()
    verts = x[frames]
    D = dist.frame_distance(verts, ftype)
    Gx = dist.frame_distance_grad(verts, ftype)

    newly = D < dhat
    keep = (active_prev > 0) & (d_prev < dhat)
    active = newly | keep
    was = active_prev > 0
    d = torch.where(was, d_prev, D)
    la = torch.where(was, la_prev, 0.0)

    g, H = bar.mixed_barrier_grad_hess(d, dhat, kappa)
    af = active.to(x.dtype)
    gmf = None
    if ee_mollifier and mesh.dim == 3:
        # scale the barrier by m(x) (Gauss-Newton: grad^2 m and the m-d
        # cross blocks are dropped, keeping the condensed system SPD); the
        # dm/dx force enters the rhs through gmf
        from mixedfem_tpu_torch.collision import mollifier as mol

        epsx = mol.eps_x(mesh.V0[frames])
        m, gm = mol.mollifier_grad(verts, ftype, epsx)
        bval = bar.barrier(d * d, dhat * dhat)
        g = g * m
        H = torch.clamp(H * m, min=1e-8)
        gmf = (kappa * bval * af)[:, None, None] * gm
    return CollisionCoeffs(D=D, Gx=Gx, g=g * af, H=H, active=af, d=d, la=la,
                           gmf=gmf)


def rhs(mesh, cf: ContactFrames, c: CollisionCoeffs) -> torch.Tensor:
    gl = c.H * (c.D - c.d) + c.g
    contrib = -c.Gx * (gl * c.active)[:, None, None]
    if c.gmf is not None:
        contrib = contrib - c.gmf
    return meshmod.project_free(mesh, assembly.segment_sum(cf.plan, contrib))


def _dot12(Gx, v):
    """Per-frame Gx : v of (n, 4, d) arrays, as products and one sum (an
    einsum here runs as a batched matrix product, which splits the frames
    into many launches)."""
    return torch.sum(Gx * v, dim=(1, 2))


def matvec(mesh, cf: ContactFrames, c: CollisionCoeffs, p) -> torch.Tensor:
    """Gx H Gx^T p."""
    pe = meshmod.project_free(mesh, p)[cf.real()[0]]
    Gdx = _dot12(c.Gx, pe)
    contrib = c.Gx * (c.H * Gdx * c.active)[:, None, None]
    return meshmod.project_free(mesh, assembly.segment_sum(cf.plan, contrib))


def diag_blocks(mesh, cf: ContactFrames, c: CollisionCoeffs) -> torch.Tensor:
    """(nv, d, d) vertex diagonal blocks of Gx H Gx^T."""
    B = (c.Gx[..., :, None] * c.Gx[..., None, :]
         * (c.H * c.active)[:, None, None, None])
    return assembly.segment_sum(cf.plan, B)


def local_solve(mesh, cf: ContactFrames, c: CollisionCoeffs, dx):
    """delta_d = (D - d) + Gx : dx;  la = H delta_d + g."""
    Gdx = _dot12(c.Gx, dx[cf.real()[0]])
    delta = ((c.D - c.d) + Gdx) * c.active
    return delta, (c.H * delta + c.g) * c.active


def energy(d, active, dhat: float, kappa: float, m=None) -> torch.Tensor:
    """kappa sum [m] b(d^2, dhat^2) over the active frames, not h^2-scaled;
    1e30 when an active frame has d <= 0 (infeasible). `m` is the optional
    EE-mollifier value per frame."""
    b = bar.barrier(d * d, dhat * dhat)
    if m is not None:
        b = b * m
    e = kappa * torch.sum(b * active)
    bad = torch.any((active > 0) & (d <= 0))
    return torch.where(bad, torch.full_like(e, 1e30), e)


def constraint_value(mesh, cf: ContactFrames, c: CollisionCoeffs, x, d, la,
                     dhat: float) -> torch.Tensor:
    """sum la (D(x) - d) over the active frames with D <= dhat or d <= dhat."""
    frames, ftype = cf.real()
    D = dist.frame_distance(x[frames], ftype)
    m = ((c.active > 0) & ((D <= dhat) | (d <= dhat))).to(x.dtype)
    return torch.sum(la * (D - d) * m)
