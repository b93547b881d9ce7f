"""Dual-condensed system: the Schur complement onto the multipliers (port
of mixedfem_tpu/solvers/dual.py, the subspace-CG path).

dx and ds are eliminated from the KKT system with the LUMPED mass, and the
SPD dual system

  S dlam = C Ml^{-1} C^T dlam + W (vol H)^{-1} W dlam
         = C Ml^{-1} r_x - W (vol H)^{-1} r_s - r_l

is solved with CG; then dx = Ml^{-1}(r_x - C^T dlam) and
ds = (vol H)^{-1}(r_s + W dlam). With contact frames the Schur complement
couples both multiplier sets (see solve_dual), as in the JAX package,
which departs there from the reference on purpose.

The constraint jacobian's transposes are vertex sums: C^T over the mesh's
incidence plan and the contact jacobian's over the frame plan, both K2 on
the card. The contact unknowns are per real frame (ContactFrames.real).
"""

from __future__ import annotations

import torch

from mixedfem_tpu_torch.mesh import mesh as meshmod
from mixedfem_tpu_torch.ops import assembly, sym
from mixedfem_tpu_torch.solvers import pcg as pcgmod
from mixedfem_tpu_torch.variables import mixed_collision as mc
from mixedfem_tpu_torch.variables.mixed_stretch import StretchCoeffs


def _weights(mesh):
    return sym.sym_weights(mesh.dim, dtype=mesh.vols.dtype,
                           device=mesh.device)


def _C_apply(mesh, c: StretchCoeffs, dx):
    """C dx = vol Sym (G : dx) per element, (E, N)."""
    Gdx = torch.einsum("eikr,ekr->ei", c.G, dx[mesh.T])
    return mesh.vols[:, None] * (_weights(mesh) * Gdx)


def _Ct_apply(mesh, c: StretchCoeffs, dl):
    """C^T dl, (nv, d) masked."""
    y = torch.einsum("eikr,ei,e->ekr", c.G, _weights(mesh) * dl, mesh.vols)
    return meshmod.project_free(mesh, assembly.segment_sum(mesh.plan, y))


def _Cc_apply(cf, cc, dx):
    """The contact constraint jacobian, (Gx : dx) per active frame, (n,)."""
    return mc._dot12(cc.Gx, dx[cf.real()[0]]) * cc.active


def _Cct_apply(mesh, cf, cc, dlc):
    """Gx^T dlc over the active frames, (nv, d) masked."""
    contrib = cc.Gx * (dlc * cc.active)[:, None, None]
    return meshmod.project_free(mesh, assembly.segment_sum(cf.plan, contrib))


def solve_dual(mesh: meshmod.MeshData, c: StretchCoeffs, rhs_kkt,
               max_iters: int = 500, tol: float = 1e-8, cf=None, cc=None,
               reduce=None):
    """Solve the dual-condensed system for rhs_kkt = (r_x, r_s, r_l[, r_d,
    r_lc]) from minres.kkt_rhs. Returns (dx, ds, dlam[, dd, dlc], iters,
    rel).

    With contact the Schur complement couples both multiplier sets

      [ Cs Ml^-1 Cs^T + W Hv^-1 W     Cs Ml^-1 Cc^T          ] [dl ]
      [ Cc Ml^-1 Cs^T                 Cc Ml^-1 Cc^T + Hc^-1  ] [dlc]

    and is solved by pcg_tree; identity rows on the inactive frames.
    `reduce` (the element-sharded step's comm.psum) sums the dot products
    of the element multipliers over the ranks; the contact multipliers'
    are every rank's whole."""
    has_contact = cf is not None and cf.frames.shape[0] > 0
    if has_contact:
        r_x, r_s, r_l, r_d, r_lc = rhs_kkt
    else:
        r_x, r_s, r_l = rhs_kkt
    w = _weights(mesh)
    vols = meshmod.safe_vols(mesh)
    ml_inv = torch.where(mesh.mass_lumped > 0, 1.0 / mesh.mass_lumped, 0.0)

    def Ml_inv(v):
        return meshmod.project_free(mesh, v * ml_inv[:, None])

    def Hv_inv(v):
        return torch.einsum("eij,ej->ei", c.Hinv, v) / vols[:, None]

    vw = mesh.vols[:, None] * w  # the KKT s-row weight W = vol * Sym

    # diagonal preconditioner of S: lumped C Ml^-1 C^T + W Hinv W / vol
    minv_e = ml_inv[mesh.T]
    diag1 = torch.einsum(
        "eikr,eikr,ek,e->ei", c.G, c.G, minv_e, mesh.vols ** 2
    ) * (w * w)[None, :]
    hinv_diag = torch.diagonal(c.Hinv, dim1=-2, dim2=-1) / vols[:, None]
    diag = torch.clamp(diag1 + vw * vw * hinv_diag, min=1e-30)

    if not has_contact:
        def S(dl):
            a = _C_apply(mesh, c, Ml_inv(_Ct_apply(mesh, c, dl)))
            b = vw * Hv_inv(vw * dl)
            return a + b

        b_dual = _C_apply(mesh, c, Ml_inv(r_x)) - vw * Hv_inv(r_s) - r_l
        dl, it, rel = pcgmod.pcg(
            S, b_dual, torch.zeros_like(b_dual), lambda r: r / diag,
            max_iters=max_iters, tol=tol,
            dot=pcgmod.dot if reduce is None else
            (lambda a, b: reduce(pcgmod.dot(a, b))),
        )
        dx = Ml_inv(r_x - _Ct_apply(mesh, c, dl))
        ds = Hv_inv(r_s + vw * dl)
        return dx, ds, dl, it, rel

    act = cc.active
    hc_inv = torch.where(act > 0, 1.0 / torch.clamp(cc.H, min=1e-8), 0.0)

    def S2(u):
        dl, dlc = u
        t = Ml_inv(_Ct_apply(mesh, c, dl) + _Cct_apply(mesh, cf, cc, dlc))
        out_l = _C_apply(mesh, c, t) + vw * Hv_inv(vw * dl)
        out_lc = _Cc_apply(cf, cc, t) + hc_inv * dlc
        return (out_l, torch.where(act > 0, out_lc, dlc))

    b_l = _C_apply(mesh, c, Ml_inv(r_x)) - vw * Hv_inv(r_s) - r_l
    b_lc = (_Cc_apply(cf, cc, Ml_inv(r_x)) - hc_inv * r_d - r_lc) * act

    frames = cf.real()[0]
    diag_lc = torch.einsum("ckr,ckr,ck->c", cc.Gx, cc.Gx, ml_inv[frames])
    diag_lc = torch.where(act > 0, torch.clamp(diag_lc + hc_inv, min=1e-30),
                          1.0)

    def Minv2(u):
        rl, rlc = u
        return (rl / diag, rlc / diag_lc)

    (dl, dlc), it, rel = pcgmod.pcg_tree(
        S2, (b_l, b_lc), (torch.zeros_like(b_l), torch.zeros_like(b_lc)),
        Minv2, max_iters=max_iters, tol=tol,
        dot=pcgmod.tdot if reduce is None else
        (lambda u, v: reduce(pcgmod.dot(u[0], v[0])) + pcgmod.dot(u[1], v[1])),
    )
    dx = Ml_inv(r_x - _Ct_apply(mesh, c, dl) - _Cct_apply(mesh, cf, cc, dlc))
    ds = Hv_inv(r_s + vw * dl)
    dd = hc_inv * (r_d + dlc) * act
    return dx, ds, dl, dd, dlc, it, rel
