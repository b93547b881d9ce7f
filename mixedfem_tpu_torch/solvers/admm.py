"""ADMM on the full mixed KKT system: the admm-solver path, and a fixed
number of its sweeps as the preconditioner of minres-indefinite-admm (port
of mixedfem_tpu/solvers/admm.py, with that module's documented departures
from the reference: rho auto-scaled and the dual step equal to rho, the
x-update's penalty term from the previous s iterate, the x-update solved
by an inner Jacobi-PCG of fixed length, and a convergence test relative
to ||b||).

Per sweep, on u = (dx, ds, dl[, dd, dlc]):

  x-update:  (M + rho B^T B) dx = b_x - B^T l  - rho B^T (C s - c)
  s-update:  (H + rho C^T C) ds = b_s - C^T l  - rho C^T (B x - c)
  l-update:  l <- l + rho (B dx + C ds - c)

with B the constraint jacobian in x, C = -vol w and c = b_l; contact frames
add their rows (B_c = Gx per frame, C_c = -1, H_c the barrier Hessian).

The inner x-update runs its fixed number of CG iterations with the
convergence test on the device (pcg.pcg_fixed): no host read inside a
sweep. The outer solver tests its error on the host once per sweep. The
vertex sums (B^T, the mass product, the Jacobi diagonal) go through the
mesh's incidence plan and the frame plan, K2 on the card; the s-block's
(N, N) inverses are one batched torch.linalg.inv per Newton iteration.
"""

from __future__ import annotations

import torch

from mixedfem_tpu_torch.mesh import mesh as meshmod
from mixedfem_tpu_torch.ops import assembly, sym
from mixedfem_tpu_torch.solvers import dual, minres
from mixedfem_tpu_torch.solvers import pcg as pcgmod
from mixedfem_tpu_torch.variables import mixed_stretch as ms


def _admm_setup(mesh: meshmod.MeshData, c: ms.StretchCoeffs, *,
                rho_scale: float, inner_iters: int, cf=None, cc=None,
                reduce=None):
    """The rhs-independent part of the iteration, built once per Newton
    iteration: rho, the jacobian products, the x-block operator and its
    Jacobi diagonal, and the s/d-block inverses. `reduce` (the
    element-sharded step's comm.psum) sums the element means and the
    element blocks of every norm over the ranks."""
    w = sym.sym_weights(mesh.dim, dtype=mesh.vols.dtype, device=mesh.device)
    vols = mesh.vols
    has_contact = cf is not None and cf.frames.shape[0] > 0
    act = cc.active if has_contact else None

    # rho auto-scaling (the JAX module's deviation 1)
    hv = vols[:, None, None] * torch.abs(c.H)
    cv = vols[:, None] ** 2 * (w * w)[None, :]
    if reduce is None:
        hbar, cbar = torch.mean(hv), torch.mean(cv)
    else:
        # the means over every rank's elements, padding included
        n = reduce(hv.new_tensor(float(vols.shape[0])))
        hbar = reduce(torch.sum(hv)) / (n * hv[0].numel())
        cbar = reduce(torch.sum(cv)) / (n * cv[0].numel())
    rho = rho_scale * hbar / torch.clamp(cbar, min=1e-30)

    def Bdx(dx):
        return vols[:, None] * w * torch.einsum("eikr,ekr->ei", c.G, dx[mesh.T])

    def BT(y):
        return dual._Ct_apply(mesh, c, y)

    Bc_dx = BcT = None
    if has_contact:
        def Bc_dx(dx):
            return dual._Cc_apply(cf, cc, dx)

        def BcT(y):
            return dual._Cct_apply(mesh, cf, cc, y)

    def Aop(p):
        p = meshmod.project_free(mesh, p)
        out = meshmod.project_free(mesh, meshmod.mass_matvec(mesh, p))
        out = out + rho * BT(Bdx(p))
        if has_contact:
            out = out + rho * BcT(Bc_dx(p))
        return out

    k, d = c.G.shape[2], mesh.dim
    btb_e = torch.einsum("eikr,eikr,i,e->ek", c.G, c.G, w * w, vols ** 2)
    btb = assembly.segment_sum(
        mesh.plan, btb_e[..., None].expand(-1, k, d).contiguous())
    diag = mesh.mass_lumped[:, None] + rho * btb
    if has_contact:
        btbc = assembly.segment_sum(cf.plan, cc.Gx ** 2 * act[:, None, None])
        diag = diag + rho * btbc
    dinv = torch.where(mesh.free_mask[:, None] > 0, 1.0 / diag, 0.0)

    def Minv(r):
        return r * dinv

    N = c.H.shape[1]
    Hs = vols[:, None, None] * c.H + rho * torch.einsum(
        "e,i,ij->eij", vols ** 2, w * w,
        torch.eye(N, dtype=vols.dtype, device=vols.device))
    if reduce is not None:
        # a padded element (zero volume) has Hs = 0: the identity keeps its
        # rows zero
        Hs = torch.where((vols > 0)[:, None, None], Hs,
                         torch.eye(N, dtype=vols.dtype, device=vols.device))
    Hs_inv = torch.linalg.inv(Hs)
    hc_inv = None
    if has_contact:
        hc_inv = torch.where(act > 0, 1.0 / (cc.H + rho), 1.0)

    def Cs(s):
        return -vols[:, None] * w * s

    return dict(
        w=w, vols=vols, has_contact=has_contact, act=act, rho=rho,
        Bdx=Bdx, BT=BT, Bc_dx=Bc_dx, BcT=BcT, Aop=Aop, Minv=Minv,
        Hs_inv=Hs_inv, hc_inv=hc_inv, Cs=Cs, inner_iters=inner_iters,
        norm2=pcgmod.tdot if reduce is None else minres.kkt_dot(reduce),
    )


def _admm_body(S, rhs):
    """One ADMM sweep over carry (u, it, err) for the KKT rhs tuple
    (minres.kkt_rhs layout). Returns (body, zero_u, safe_b)."""
    has_contact = S["has_contact"]
    vols, w, rho = S["vols"], S["w"], S["rho"]
    Bdx, BT, Bc_dx, BcT = S["Bdx"], S["BT"], S["Bc_dx"], S["BcT"]
    Cs, Hs_inv, hc_inv, act = S["Cs"], S["Hs_inv"], S["hc_inv"], S["act"]
    if has_contact:
        b_x, b_s, b_l, b_d, b_lc = rhs
    else:
        b_x, b_s, b_l = rhs

    bnorm = torch.sqrt(S["norm2"](rhs, rhs))
    safe_b = torch.where(bnorm > 0, bnorm, torch.ones_like(bnorm))
    zero_u = tuple(torch.zeros_like(b) for b in rhs)

    def body(carry):
        u, it, _ = carry
        if has_contact:
            xk, sk, lk, dk, lck = u
        else:
            xk, sk, lk = u
        # x-update: the inner Jacobi-PCG, fixed length
        bi = b_x - BT(lk) - rho * BT(Cs(sk) - b_l)
        if has_contact:
            bi = bi - BcT(lck) - rho * BcT(-dk - b_lc)
        xn = pcgmod.pcg_fixed(S["Aop"], bi, xk, S["Minv"],
                              iters=S["inner_iters"], tol=1e-12)
        # s-update (and the contact d-update)
        bs = b_s + vols[:, None] * w * lk + rho * vols[:, None] * w * (
            Bdx(xn) - b_l)
        sn = torch.einsum("eij,ej->ei", Hs_inv, bs)
        if has_contact:
            bd = b_d + lck + rho * (Bc_dx(xn) - b_lc)
            dn = bd * hc_inv * act
        # dual update, step rho
        ln = lk + rho * (Bdx(xn) + Cs(sn) - b_l)
        if has_contact:
            lcn = (lck + rho * (Bc_dx(xn) - dn - b_lc)) * act
            un = (xn, sn, ln, dn, lcn)
        else:
            un = (xn, sn, ln)
        diff = tuple(a - b for a, b in zip(un, u))
        du = torch.sqrt(S["norm2"](diff, diff))
        return un, it + 1, du / safe_b

    return body, zero_u, safe_b


def _build_admm_iteration(mesh, c, rhs, *, rho_scale: float, inner_iters: int,
                          cf=None, cc=None, reduce=None):
    S = _admm_setup(mesh, c, rho_scale=rho_scale, inner_iters=inner_iters,
                    cf=cf, cc=cc, reduce=reduce)
    return _admm_body(S, rhs)


def solve_admm(mesh: meshmod.MeshData, c: ms.StretchCoeffs, rhs, *,
               rho_scale: float = 3.0, max_iters: int = 100, tol: float = 1e-4,
               inner_iters: int = 30, cf=None, cc=None, reduce=None):
    """ADMM solve of the KKT system whose rhs tuple comes from
    minres.kkt_rhs. Returns (u, iters, err), err = ||u_k - u_{k-1}|| /
    ||b||. `reduce` as in _admm_setup."""
    body, zero_u, safe_b = _build_admm_iteration(
        mesh, c, rhs, rho_scale=rho_scale, inner_iters=inner_iters,
        cf=cf, cc=cc, reduce=reduce)
    u, it, err = zero_u, 0, torch.full_like(safe_b, torch.inf)
    while it < max_iters and bool(err > tol):
        u, it, err = body((u, it, err))
    return u, it, err


def admm_preconditioner(mesh: meshmod.MeshData, c: ms.StretchCoeffs, *,
                        rho_scale: float = 3.0, sweeps: int = 2,
                        inner_iters: int = 10, cf=None, cc=None,
                        reduce=None):
    """`sweeps` ADMM sweeps from zero as the MINRES preconditioner
    (minres-indefinite-admm): a fixed operator of r, only approximately
    linear (the inner x-solve is truncated), as in the reference. `reduce`
    as in _admm_setup."""
    S = _admm_setup(mesh, c, rho_scale=rho_scale, inner_iters=inner_iters,
                    cf=cf, cc=cc, reduce=reduce)

    def Minv(r):
        body, zero_u, safe_b = _admm_body(S, r)
        carry = (zero_u, 0, None)
        for _ in range(sweeps):
            carry = body(carry)
        return carry[0]

    return Minv
