"""Matrix-free MINRES and the full indefinite KKT system (port of
mixedfem_tpu/solvers/minres.py, the minres-indefinite-* paths).

The KKT system in the mixed unknowns u = (dx, ds, dlam):

  [ M        0         C^T ] [dx]     [ r_x ]   r_x  = -(M(x-xt) + C^T lam)
  [ 0        vol H    -W   ] [ds]  =  [ r_s ]   r_s  = -(vol g - W lam)
  [ C       -W         0   ] [dl]     [ r_l ]   r_l  = -(W (Sv - s))

with (C dx)_e = vol_e Sym (G_e : dx) and W = diag(vol * Sym). With contact
frames the mixed-collision unknowns (dd, dlc) per real frame are stacked
below (kkt_operator). Unknowns are tuples of tensors.

The x-row sums go through the mesh's incidence plan and the contact rows'
through the frame plan, K2 on the card. MINRES is the Paige-Saunders
recurrence of the JAX package with its stop, phibar <= tol * beta1,
tested on the host once per iteration.
"""

from __future__ import annotations

from typing import Callable

import torch

from mixedfem_tpu_torch.mesh import mesh as meshmod
from mixedfem_tpu_torch.ops import sym
from mixedfem_tpu_torch.solvers import dual
from mixedfem_tpu_torch.solvers.pcg import taxpy, tdot
from mixedfem_tpu_torch.variables import displacement as disp
from mixedfem_tpu_torch.variables import mixed_collision as mc
from mixedfem_tpu_torch.variables import mixed_stretch as ms


def _scale(alpha, x):
    return tuple(alpha * a for a in x)


def _has_contact(cf) -> bool:
    return cf is not None and cf.frames.shape[0] > 0


def kkt_operator(mesh: meshmod.MeshData, c: ms.StretchCoeffs, cf=None,
                 cc=None, extra_x_matvec=None):
    """The matrix-free KKT product A(u). With contact frames (cf, cc) u =
    (dx, ds, dl, dd, dlc) and the contact rows are

      x-row  += Gx^T dlc
      d-row   = Hc dd - dlc      (identity on inactive frames)
      lc-row  = Gx : dx - dd     (identity on inactive frames)

    `extra_x_matvec(dx)` adds the nodal (collision, friction) Hessian
    products to the x-row."""
    w = sym.sym_weights(mesh.dim, dtype=mesh.vols.dtype, device=mesh.device)
    has_contact = _has_contact(cf)

    def A(u):
        if has_contact:
            dx, ds, dl, dd, dlc = u
        else:
            dx, ds, dl = u
        dxm = meshmod.project_free(mesh, dx)
        # x-row: M dx + C^T dl
        out_x = meshmod.project_free(mesh, meshmod.mass_matvec(mesh, dxm))
        out_x = out_x + dual._Ct_apply(mesh, c, dl)
        if extra_x_matvec is not None:
            out_x = out_x + extra_x_matvec(dxm)
        # s-row: vol H ds - W dl
        out_s = mesh.vols[:, None] * (
            torch.einsum("eij,ej->ei", c.H, ds) - w * dl)
        # lam-row: C dx - W ds
        Gdx = torch.einsum("eikr,ekr->ei", c.G, dxm[mesh.T])
        out_l = mesh.vols[:, None] * (w * (Gdx - ds))
        if not has_contact:
            return (out_x, out_s, out_l)
        act = cc.active
        out_x = out_x + dual._Cct_apply(mesh, cf, cc, dlc)
        out_d = torch.where(act > 0, cc.H * dd - dlc, dd)
        Gcdx = mc._dot12(cc.Gx, dxm[cf.real()[0]])
        out_lc = torch.where(act > 0, Gcdx - dd, dlc)
        return (out_x, out_s, out_l, out_d, out_lc)

    return A


def kkt_rhs(mesh, bdf, c: ms.StretchCoeffs, x, s, la, blend: float = 1.0,
            cf=None, cc=None, extra_grad_x=None):
    """Negative KKT gradient at the current iterate. With contact it adds
    Gx^T la_c to the x-gradient and appends r_d = -(g_c - la_c) and
    r_lc = -(D - d) on the active frames."""
    w = sym.sym_weights(mesh.dim, dtype=mesh.vols.dtype, device=mesh.device)
    r_x = -(disp.gradient(mesh, bdf, x, blend) + ms.gradient_x(mesh, c, la))
    r_s = -mesh.vols[:, None] * (c.g - w * la)
    r_l = -mesh.vols[:, None] * (w * (c.Sv - s))
    if extra_grad_x is not None:
        r_x = r_x - extra_grad_x
    if not _has_contact(cf):
        return (r_x, r_s, r_l)
    act = cc.active
    r_x = r_x - dual._Cct_apply(mesh, cf, cc, cc.la)
    r_d = -(cc.g - cc.la) * act
    r_lc = -(cc.D - cc.d) * act
    return (r_x, r_s, r_l, r_d, r_lc)


def kkt_block_diag_preconditioner(mesh: meshmod.MeshData,
                                  c: ms.StretchCoeffs, cf=None, cc=None):
    """SPD block-diagonal preconditioner: the lumped-mass inverse on the x
    block, (vol H)^{-1} on the s block and a lumped C M^{-1} C^T inverse
    on the dual block; contact adds Hc^{-1} on the d block and a lumped
    Gx Ml^{-1} Gx^T + Hc^{-1} diagonal on the contact dual block."""
    w = sym.sym_weights(mesh.dim, dtype=mesh.vols.dtype, device=mesh.device)
    m_inv = torch.where(mesh.mass_lumped > 0, 1.0 / mesh.mass_lumped, 1.0)
    has_contact = _has_contact(cf)
    vols = meshmod.safe_vols(mesh)

    minv_e = m_inv[mesh.T]  # (E, k)
    L = torch.einsum(
        "eikr,eikr,ek,e->ei", c.G, c.G, minv_e, mesh.vols ** 2
    ) * (w * w)[None, :]
    L = torch.clamp(L, min=1e-30)

    if has_contact:
        act = cc.active
        hc_inv = torch.where(act > 0, 1.0 / torch.clamp(cc.H, min=1e-8), 1.0)
        Lc = torch.einsum("ckr,ckr,ck->c", cc.Gx, cc.Gx,
                          m_inv[cf.real()[0]])
        Lc = torch.where(act > 0, torch.clamp(Lc + hc_inv, min=1e-30), 1.0)

    def Minv(u):
        if has_contact:
            r_x, r_s, r_l, r_d, r_lc = u
        else:
            r_x, r_s, r_l = u
        z_x = meshmod.project_free(mesh, r_x * m_inv[:, None])
        z_s = torch.einsum("eij,ej->ei", c.Hinv, r_s) / vols[:, None]
        z_l = r_l / L
        if not has_contact:
            return (z_x, z_s, z_l)
        return (z_x, z_s, z_l, r_d * hc_inv, r_lc / Lc)

    return Minv


def kkt_dot(reduce=None):
    """The dot product of KKT tuples (dx, ds, dl[, dd, dlc]): tdot, or on a
    rank of the element-sharded step (`reduce` its comm.psum) the x and
    contact blocks, which every rank holds whole, plus the sum over the
    ranks of the element blocks (ds, dl)."""
    if reduce is None:
        return tdot

    def dot(u, v):
        parts = [torch.sum(a * b) for a, b in zip(u, v)]
        out = parts[0] + reduce(parts[1] + parts[2])
        for p in parts[3:]:
            out = out + p
        return out

    return dot


def minres(A: Callable, b, x0, max_iters: int, tol: float, Minv=None,
           dot=tdot):
    """Preconditioned MINRES (Paige-Saunders) on tuples. Stops when the
    preconditioned residual norm phibar <= tol * beta1. Returns (x, iters,
    rel_residual). `dot` is the tuples' dot product (kkt_dot)."""
    if Minv is None:
        def Minv(r):
            return r

    r1 = taxpy(-1.0, A(tuple(x0)), b)
    y = Minv(r1)
    beta1 = torch.sqrt(torch.clamp(dot(r1, y), min=0.0))
    safe_beta1 = torch.where(beta1 > 0, beta1, torch.ones_like(beta1))
    stop = tol * safe_beta1
    zero = torch.zeros_like(beta1)

    x, r1c, r2c, yc = tuple(x0), r1, r1, y
    oldb, beta, dbar, epsln, phibar = zero, beta1, zero, zero, beta1
    cs, sn = -torch.ones_like(beta1), zero
    wv = w2 = tuple(torch.zeros_like(a) for a in b)
    it = 0
    while it < max_iters and bool(phibar > stop):
        safe_b = torch.where(beta != 0, beta, torch.ones_like(beta))
        v = _scale(1.0 / safe_b, yc)
        yn = A(v)
        if it >= 1:
            safe_oldb = torch.where(oldb != 0, oldb, torch.ones_like(oldb))
            yn = taxpy(-(beta / safe_oldb), r1c, yn)
        alfa = dot(v, yn)
        yn = taxpy(-(alfa / safe_b), r2c, yn)
        r1c, r2c = r2c, yn
        yc = Minv(r2c)
        oldb = beta
        beta = torch.sqrt(torch.clamp(dot(r2c, yc), min=0.0))

        oldeps = epsln
        delta = cs * dbar + sn * alfa
        gbar = sn * dbar - cs * alfa
        epsln = sn * beta
        dbar = -cs * beta
        gamma = torch.sqrt(gbar * gbar + beta * beta)
        gamma = torch.clamp(gamma, min=1e-30)
        cs = gbar / gamma
        sn = beta / gamma
        phi = cs * phibar
        phibar = sn * phibar

        w1 = w2
        w2 = wv
        wv = _scale(1.0 / gamma, taxpy(-oldeps, w1, taxpy(-delta, w2, v)))
        x = taxpy(phi, wv, x)
        it += 1
    return x, it, phibar / safe_beta1
