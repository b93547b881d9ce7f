"""Edge-edge mollifier: smooths the EE barrier near parallel edges (port of
mixedfem_tpu/collision/mollifier.py; used under config.ee_mollifier, off by
default).

  c(x) = || (p1 - p0) x (q1 - q0) ||^2
  m(x) = 1 if c >= eps_x, else (c / eps_x) (2 - c / eps_x)

with eps_x = 1e-3 |e0_rest|^2 |e1_rest|^2; the contact energy becomes
kappa m(x) b(d^2).
"""

from __future__ import annotations

import torch

from mixedfem_tpu_torch.collision.distances import EE


def eps_x(rest_verts: torch.Tensor) -> torch.Tensor:
    """(C, 4, 3) REST frame vertices -> (C,) mollifier thresholds."""
    e0 = rest_verts[:, 1] - rest_verts[:, 0]
    e1 = rest_verts[:, 3] - rest_verts[:, 2]
    return 1e-3 * torch.sum(e0 * e0, dim=-1) * torch.sum(e1 * e1, dim=-1)


def _m_of_verts(verts, epsx):
    """(C, 4, 3) -> (C,) mollifier values of every frame as if it were EE."""
    w = torch.linalg.cross(verts[:, 1] - verts[:, 0], verts[:, 3] - verts[:, 2])
    r = torch.sum(w * w, dim=-1) / torch.clamp(epsx, min=1e-30)
    return torch.where(r >= 1.0, 1.0, r * (2.0 - r))


def mollifier(verts, ftype, epsx):
    """(C,) m values (1 for non-EE frames)."""
    return torch.where(ftype == EE, _m_of_verts(verts, epsx), 1.0)


def mollifier_grad(verts, ftype, epsx):
    """(m (C,), dm/dverts (C, 4, 3), zero for non-EE frames)."""
    def summed(v):
        m = _m_of_verts(v, epsx)
        return m.sum(), m

    g, m = torch.func.grad(summed, has_aux=True)(verts)
    is_ee = ftype == EE
    return torch.where(is_ee, m, 1.0), torch.where(is_ee[:, None, None], g, 0.0)
