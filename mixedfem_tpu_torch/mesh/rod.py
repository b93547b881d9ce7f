"""Rods: 3D segments (k = 2) with a frame-augmented deformation gradient
(port of mixedfem_tpu/mesh/rod.py).

The deformation gradient of a segment is

  F(x) = (x1 - x0) (x) t0 / L  +  n(x) N0^T  +  b(x) B0^T

where t0 is the rest tangent, L the rest length, (N0, B0) the rest
cross-section frame, and (n, b) that frame carried by the rotation taking
t0 to the current tangent (the branch-free double-cross formula). dF/dx
(9 x 6 per segment) comes from forward-mode autodiff of this map,
torch.func.jacfwd under torch.func.vmap. The per-segment inputs are made
contiguous first: vmap keeps an input's strides, and a strided view (a
column of the frames) rounds otherwise on the card.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.func import jacfwd, vmap


def rod_rest_frames(V: np.ndarray, E: np.ndarray):
    """Rest tangent direction, length, and an orthonormal (N, B) frame."""
    t = V[E[:, 1]] - V[E[:, 0]]
    L = np.linalg.norm(t, axis=1)
    t = t / L[:, None]
    ref = np.where(np.abs(t[:, :1]) > 0.9, [[0.0, 1.0, 0.0]], [[1.0, 0.0, 0.0]])
    N = np.cross(t, ref)
    N /= np.linalg.norm(N, axis=1, keepdims=True)
    B = np.cross(t, N)
    return t, L, N, B


def _cross(a, b):
    return torch.stack([a[1] * b[2] - a[2] * b[1],
                        a[2] * b[0] - a[0] * b[2],
                        a[0] * b[1] - a[1] * b[0]])


def rod_def_grad_fn(t0, N0, B0, L):
    """F(x01) of one segment: x01 (2, 3) -> (3, 3)."""

    def F(x01):
        d = x01[1] - x01[0]
        l = torch.sqrt(torch.sum(d * d) + 1e-30)
        t = d / l
        # the rotation taking t0 to t (Rodrigues by a double cross)
        c = torch.sum(t0 * t)
        v = _cross(t0, t)
        z = torch.zeros_like(v[0])
        vx = torch.stack([
            torch.stack([z, -v[2], v[1]]),
            torch.stack([v[2], z, -v[0]]),
            torch.stack([-v[1], v[0], z]),
        ])
        R = (torch.eye(3, dtype=x01.dtype, device=x01.device) + vx
             + (vx @ vx) / torch.clamp(1.0 + c, min=1e-6))
        n = R @ N0
        b = R @ B0
        # stretch along the rest tangent + the carried cross-section frame
        return ((d / L)[:, None] * t0[None, :] + n[:, None] * N0[None, :]
                + b[:, None] * B0[None, :])

    return F


def _segments(x, E, t0, N0, B0, L):
    return (x[E.long()].contiguous(), t0.contiguous(), N0.contiguous(),
            B0.contiguous(), L.contiguous())


def rod_def_grad(x, E, t0, N0, B0, L):
    """(nv, 3) positions -> (nseg, 3, 3) deformation gradients."""

    def one(x01, t0e, N0e, B0e, Le):
        return rod_def_grad_fn(t0e, N0e, B0e, Le)(x01)

    return vmap(one)(*_segments(x, E, t0, N0, B0, L))


def rod_def_grad_jacobian(x, E, t0, N0, B0, L):
    """(nseg, 2, 3, 3, 3) tensor dF_ac/dx_kr by forward-mode autodiff."""

    def one(x01, t0e, N0e, B0e, Le):
        J = jacfwd(rod_def_grad_fn(t0e, N0e, B0e, Le))(x01)
        # J[a, c, k, r] -> [k, r, a, c]
        return J.permute(2, 3, 0, 1)

    return vmap(one)(*_segments(x, E, t0, N0, B0, L)).contiguous()


def rod_mass_coeff(L: np.ndarray, density: np.ndarray, radius: float = 1e-2):
    """(nseg, 2, 2) consistent segment mass blocks, rho A L (1 + delta) / 6."""
    A = np.pi * radius * radius
    base = (1.0 + np.eye(2)) / 6.0
    return (density * A * L)[:, None, None] * base[None]
