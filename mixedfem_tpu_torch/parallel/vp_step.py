"""The vertex-partitioned full Newton step (port of
mixedfem_tpu/parallel/vp_step.py).

No rank holds whole-mesh vertex arrays. Per rank, on its block of nb
vertex rows and its elements (the layout of parallel/halo.py):

- the coefficient update: F, the polar decomposition, ds/dF, the
  material terms, and G = D : dphi with Gw = sqrt(vol) Hs G in one fused
  pass (smallops.contract_G_Gw, K3), the element arrays the rank's own;
- the halo'd inertia gradient and the condensed rhs, summed by K2 over a
  rank-local incidence plan of nb + 2 Bd rows and returned through the
  halo (parallel/halo.py halo_out);
- PCG with psum'd dot products, the matvec K1 + K2 with the halo, and
  block-Jacobi or the two-level coarse space: each rank sums its elements'
  Galerkin blocks per aggregate pair (K2), one psum replicates the pair
  sums, and every rank forms the same dense matrix and its Newton-Schulz
  inverse; the coarse residual is psum'd per CG iteration;
- the local (ds, la) recovery, the line search's merit as a rank-local
  sum and a psum, the Newton decrement by pmax;
- mixed IPC contact (`cf`): the frames' vertex values are gathered with
  one psum of (C, 4, X) per use (frames may span ranks), the barrier
  algebra runs replicated on every rank in the same order, and the
  frames' rhs, blocks and matvec terms land on owned rows only (K2).

Every Newton, CG and line-search decision branches on a psum'd or pmax'd
value, so every rank takes the same branches. BDF1-6 through a BDFState
over the rank's rows. The host plan (VPPlan, stacked over ranks) equals
the JAX package's; rank_vp_plan takes one rank's share to its device.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from mixedfem_tpu_torch.collision import accd as accdmod
from mixedfem_tpu_torch.collision import barrier as bar
from mixedfem_tpu_torch.collision import distances as dist
from mixedfem_tpu_torch.integrators import bdf as bdfmod
from mixedfem_tpu_torch.materials import models as mat
from mixedfem_tpu_torch.ops import assembly, rotation, smallops, sym
from mixedfem_tpu_torch.parallel.halo import (element_rows, halo_in, halo_out,
                                               partition)
from mixedfem_tpu_torch.solvers import coarse as coarsemod
from mixedfem_tpu_torch.solvers import pcg as pcgmod
from mixedfem_tpu_torch.variables import mixed_collision as mcmod
from mixedfem_tpu_torch.variables import mixed_stretch as ms


@dataclasses.dataclass
class VPPlan:
    """Static per-rank partition and element data, host numpy, stacked
    over ranks on axis 0 (the JAX package's fields first)."""

    T_local: np.ndarray     # (D, Ep, k) int32 into [halo_L | own | halo_R]
    emask: np.ndarray       # (D, Ep)
    dphidX: np.ndarray      # (D, Ep, k, d)
    vols: np.ndarray        # (D, Ep)
    mass_coeff: np.ndarray  # (D, Ep, k, k)
    mu: np.ndarray          # (D, Ep)
    lam: np.ndarray         # (D, Ep)
    model_id: np.ndarray    # (D, Ep) int32
    free_mask: np.ndarray   # (D, nb)
    ext: np.ndarray         # (D, nb, dim)
    nb: int
    Bd: int
    D: int
    nv_pad: int
    dim: int
    models: Tuple[str, ...]
    # the two-level coarse space (naggr == 0: none): rank-local rigid-mode
    # geometry and global aggregate ids, as in the JAX plan
    agg_v: np.ndarray       # (D, nb) int32
    r_v: np.ndarray         # (D, nb, 3)
    agg_e: np.ndarray       # (D, Ep, k) int32
    naggr: int = 0
    # the port's: the aggregate pairs of the whole mesh's element corner
    # pairs, and each rank's corner pairs' pair ids (npairs for padding)
    pair_rows: np.ndarray = None   # (npairs,) int64
    pair_cols: np.ndarray = None   # (npairs,) int64
    pair_e: np.ndarray = None      # (D, Ep, k, k) int64


def build_vp_plan(mesh, n_shards: int, coarse=None) -> VPPlan:
    """Partition a banded-ordered mesh (the port's MeshData); raises if the
    bandwidth exceeds the halo capacity (reorder first with
    parallel/reorder.py). `coarse` (solvers/coarse.py CoarseSpace) enables
    the two-level preconditioner inside the sharded CG."""
    T = mesh.T.cpu().numpy()
    nv = mesh.nv
    E, k = T.shape
    d = mesh.dim
    nb, nv_pad, owner, Bd = partition(
        T, nv, n_shards, "(parallel/reorder.py) or use fewer shards")
    Ep = -(-max(int(np.bincount(owner, minlength=n_shards).max()), 1) // 8) * 8

    def host(t):
        return t.cpu().numpy()

    dt_np = np.float64
    T_local = np.zeros((n_shards, Ep, k), np.int32)
    emask = np.zeros((n_shards, Ep), dt_np)
    dphi = np.zeros((n_shards, Ep, k, d), dt_np)
    vols = np.zeros((n_shards, Ep), dt_np)
    mc = np.zeros((n_shards, Ep, k, k), dt_np)
    mu = np.ones((n_shards, Ep), dt_np)
    lam = np.ones((n_shards, Ep), dt_np)
    mid = np.zeros((n_shards, Ep), np.int32)
    m_dphi, m_vols, m_mc = host(mesh.dphidX), host(mesh.vols), host(mesh.mass_coeff)
    m_mu, m_lam, m_mid = host(mesh.mu), host(mesh.lam), host(mesh.model_id)
    owned = [np.nonzero(owner == sh)[0] for sh in range(n_shards)]
    for sh, ids in enumerate(owned):
        n_own = len(ids)
        T_local[sh, :n_own] = T[ids] - sh * nb + Bd
        emask[sh, :n_own] = 1.0
        dphi[sh, :n_own] = m_dphi[ids]
        vols[sh, :n_own] = m_vols[ids]
        mc[sh, :n_own] = m_mc[ids]
        mu[sh, :n_own] = m_mu[ids]
        lam[sh, :n_own] = m_lam[ids]
        mid[sh, :n_own] = m_mid[ids]
    if T_local.min() < 0 or T_local.max() >= nb + 2 * Bd:
        raise AssertionError("an element outside its rank's halo window")

    def vpad(a):
        return np.concatenate(
            [np.asarray(a), np.zeros((nv_pad - nv,) + a.shape[1:], a.dtype)])

    jdt = m_vols.dtype
    agg_v = np.zeros((0, 0), np.int32)
    r_v = np.zeros((0, 0, 3), jdt)
    agg_e = np.zeros((0, 0, 0), np.int32)
    naggr = 0
    pair_rows = pair_cols = pair_e = None
    if coarse is not None:
        agg_np = host(coarse.agg_id)
        naggr = coarse.naggr
        agg_v = np.concatenate(
            [agg_np, np.zeros(nv_pad - nv, np.int32)]
        ).reshape(n_shards, nb).astype(np.int32)
        r_v = vpad(host(coarse.r)).reshape(n_shards, nb, 3).astype(jdt)
        agg_of_T = agg_np[T]                                   # (E, k)
        agg_e = np.zeros((n_shards, Ep, k), np.int32)
        for sh, ids in enumerate(owned):
            agg_e[sh, : len(ids)] = agg_of_T[ids]
        pair_rows, pair_cols, pair_e = pair_tables(agg_e, emask, naggr)
    return VPPlan(
        T_local=T_local,
        emask=emask.astype(jdt),
        dphidX=dphi.astype(jdt),
        vols=vols.astype(jdt),
        mass_coeff=mc.astype(jdt),
        mu=mu.astype(jdt),
        lam=lam.astype(jdt),
        model_id=mid,
        free_mask=vpad(host(mesh.free_mask)).reshape(n_shards, nb).astype(jdt),
        ext=vpad(host(mesh.ext_force)).reshape(n_shards, nb, d).astype(jdt),
        nb=nb, Bd=Bd, D=n_shards, nv_pad=nv_pad, dim=d, models=mesh.models,
        agg_v=agg_v, r_v=r_v, agg_e=agg_e, naggr=naggr,
        pair_rows=pair_rows, pair_cols=pair_cols, pair_e=pair_e,
    )


def pair_tables(agg_e: np.ndarray, emask: np.ndarray, naggr: int):
    """(pair_rows, pair_cols, pair_e): the aggregate pairs (ascending) of
    the real elements' corner pairs over all ranks, and each rank's corner
    pairs' pair ids (D, Ep, k, k), npairs at the padding."""
    a = agg_e.astype(np.int64)
    flat = a[..., :, None] * naggr + a[..., None, :]           # (D, Ep, k, k)
    real = np.asarray(emask) > 0
    uniq = np.unique(flat[real])
    pair_e = np.where(real[..., None, None], np.searchsorted(uniq, flat),
                      len(uniq))
    return uniq // naggr, uniq % naggr, pair_e


def pad_vertex_field(plan: VPPlan, x):
    """(nv, d) -> (nv_pad, d) zero-padded (numpy or torch)."""
    if torch.is_tensor(x):
        return torch.nn.functional.pad(x, (0, 0, 0, plan.nv_pad - x.shape[0]))
    return np.pad(np.asarray(x), ((0, plan.nv_pad - len(x)), (0, 0)))


def init_vp_state(plan: VPPlan, dtype=np.float64):
    """Initial per-rank (s, la), (D, Ep, N): the rest-state identity
    stretch (MixedStretch::reset for a start from the rest pose)."""
    D, Ep, _ = plan.T_local.shape
    d = plan.dim
    N = 6 if d == 3 else 3
    eye = np.zeros((N,), dtype)
    eye[:d] = 1.0
    s0 = np.broadcast_to(eye, (D, Ep, N)).copy()
    return s0, np.zeros_like(s0)


@dataclasses.dataclass
class RankVPPlan:
    """One rank's share of a VPPlan, on its device, with its sum plans."""

    rank: int
    T_local: torch.Tensor    # (Ep, k) int32 (K1's table)
    Tl: torch.Tensor         # (Ep, k) int64 (gathers)
    emask: torch.Tensor
    dphidX: torch.Tensor
    vols: torch.Tensor
    mass_coeff: torch.Tensor
    mu: torch.Tensor
    lam: torch.Tensor
    model_id: torch.Tensor
    free_mask: torch.Tensor  # (nb,)
    ext: torch.Tensor        # (nb, d)
    vplan: assembly.IncidencePlan  # (nb + 2 Bd) rows <- (element, corner)
    nb: int
    Bd: int
    dim: int
    models: Tuple[str, ...]
    naggr: int = 0
    agg_v: torch.Tensor = None      # (nb,) int64
    r_v: torch.Tensor = None        # (nb, 3)
    agg_plan: assembly.IncidencePlan = None   # aggregate <- owned row
    pair_plan: assembly.IncidencePlan = None  # pair <- (element, k, l)
    pair_rows: torch.Tensor = None
    pair_cols: torch.Tensor = None


def rank_vp_plan(plan: VPPlan, rank: int, device) -> RankVPPlan:
    """Rank `rank`'s share of `plan` on `device` (tensors of the plan's
    dtype)."""
    dev = torch.device(device)

    def f(a):
        return torch.as_tensor(np.ascontiguousarray(a[rank]), device=dev)

    nrows = plan.nb + 2 * plan.Bd
    T_local = f(plan.T_local)
    rp = RankVPPlan(
        rank=rank, T_local=T_local, Tl=T_local.long(), emask=f(plan.emask),
        dphidX=f(plan.dphidX), vols=f(plan.vols),
        mass_coeff=f(plan.mass_coeff), mu=f(plan.mu), lam=f(plan.lam),
        model_id=f(plan.model_id), free_mask=f(plan.free_mask),
        ext=f(plan.ext),
        vplan=assembly.build_incidence_plan(plan.T_local[rank], nrows, dev),
        nb=plan.nb, Bd=plan.Bd, dim=plan.dim, models=tuple(plan.models),
    )
    if plan.naggr > 0:
        npairs = len(plan.pair_rows)
        rp = dataclasses.replace(
            rp, naggr=plan.naggr, agg_v=f(plan.agg_v).long(), r_v=f(plan.r_v),
            agg_plan=assembly.build_incidence_plan(plan.agg_v[rank],
                                                   plan.naggr, dev),
            pair_plan=assembly.build_incidence_plan(plan.pair_e[rank],
                                                    npairs + 1, dev),
            pair_rows=torch.as_tensor(plan.pair_rows, device=dev),
            pair_cols=torch.as_tensor(plan.pair_cols, device=dev),
        )
    return rp


def _modes_of(r3, mask, d):
    """Per-vertex rigid-mode matrix [I | -skew(r)] (n, d, 6), masked."""
    n = r3.shape[0]
    zero = r3.new_zeros((n,))
    sk = torch.stack([
        torch.stack([zero, r3[:, 2], -r3[:, 1]], dim=-1),
        torch.stack([-r3[:, 2], zero, r3[:, 0]], dim=-1),
        torch.stack([r3[:, 1], -r3[:, 0], zero], dim=-1),
    ], dim=-2)
    eye = torch.eye(3, dtype=r3.dtype, device=r3.device).expand(n, 3, 3)
    B = torch.cat([eye, sk], dim=-1)
    return B[:, :d, :] * mask[:, None, None]


def _ns_inverse(Ac: torch.Tensor, iters: int = 36) -> torch.Tensor:
    """The JAX vp step's cold Newton-Schulz inverse: X0 = I / ||A||_inf,
    X <- X (2I - A X), `iters` times."""
    coarsemod._no_tf32()
    eye = torch.eye(Ac.shape[0], dtype=Ac.dtype, device=Ac.device)
    X = eye * (1.0 / torch.clamp(torch.amax(torch.sum(Ac.abs(), 1)), min=1e-30))
    for _ in range(iters):
        X = X @ (2.0 * eye - Ac @ X)
    return X


def vp_newton_step(rp: RankVPPlan, config, comm, x, v, s, la, bdf=None,
                   cf=None):
    """One implicit step of this rank's share, fully vertex-partitioned:
    x and v its rows (nb, d), s and la its elements' (Ep, N). Returns
    (x_new, v_new, s_new, la_new, iters, decrement, cg_total) with la_new
    zero (the multipliers are cleared at the step's end) and the last three
    the same on every rank.

    `bdf` (integrators/bdf.py BDFState over the rank's rows) selects the
    integrator; the caller pushes x_new into it. Without it the step is
    BDF1 from (x, v). `cf` (frames (C, 4) of global vertex ids, ftype,
    fmask; the port's ContactFrames will do) adds mixed IPC contact over
    its real frames (fmask > 0), the same on every rank."""
    nb, Bd, d = rp.nb, rp.Bd, rp.dim
    h = bdfmod.bdf_dt(bdf) if bdf is not None else config.h
    dtype, dev = x.dtype, x.device
    dt2 = h * h
    outer = config.outer_steps
    models = rp.models
    w_sym = sym.sym_weights(d, dtype=dtype, device=dev)
    syminv = sym.syminv_weights(d, dtype=dtype, device=dev)
    eye_d = torch.eye(d, dtype=dtype, device=dev)
    Tl, Tl32, em = rp.Tl, rp.T_local, rp.emask
    dphi, vol, mc = rp.dphidX, rp.vols, rp.mass_coeff
    mu_e, lam_e, mid, fm = rp.mu, rp.lam, rp.model_id, rp.free_mask
    fmc = fm[:, None]
    use_coarse = rp.naggr > 0
    naggr = rp.naggr
    ncd = 6 * naggr
    dhat, kappa = config.dhat, config.kappa

    nC = 0
    if cf is not None:
        real = torch.nonzero(cf.fmask > 0).squeeze(1)
        frames = cf.frames[real].long().to(dev)
        ftype = cf.ftype[real].to(dev)
        nC = frames.shape[0]
    use_contact = nC > 0

    if bdf is not None:
        target = bdfmod.bdf_x_tilde(bdf) + dt2 * rp.ext
    else:
        target = x + h * v + dt2 * rp.ext

    def halo(p):
        return halo_in(comm, p, nb, Bd)

    def unhalo_add(buf):
        return halo_out(comm, buf, nb, Bd)

    def scatter_local(contrib):
        """(Ep, k, ...) -> (nb, ...) with the halo returned."""
        return unhalo_add(assembly.segment_sum(rp.vplan, contrib))

    def pdot(a, b):
        return comm.psum(torch.sum(a * b))

    if use_contact:
        # frames may span ranks: one psum replicates their vertex values;
        # their sums land on owned rows only, through a plan of this step
        rel = frames - rp.rank * nb
        ok = (rel >= 0) & (rel < nb)
        rel_c = torch.clamp(rel, 0, nb - 1)
        fplan = assembly.build_incidence_plan(
            torch.where(ok, rel, nb).cpu().numpy(), nb + 1, dev)

        def gather_frames(p):
            """(nb, X) owned rows -> (C, 4, X) frame values, replicated."""
            return comm.psum(torch.where(ok[..., None], p[rel_c], 0.0))

        def scatter_frames_own(contrib):
            """(C, 4, X) frame contributions -> (nb, X) owned rows (K2)."""
            return assembly.segment_sum(fplan, contrib * ok[..., None])[:nb]

    def F_of(xbuf):
        return torch.einsum("ekr,ekc->erc", xbuf[Tl], dphi)

    def mass_apply(rbuf):
        """The element consistent-mass product of a halo'd field."""
        return torch.einsum("ekl,eld->ekd", mc, rbuf[Tl])

    def merit(x_t, s_t, la_t, tgtbuf):
        xtbuf = halo(x_t)
        diff_buf = xtbuf - tgtbuf
        e_in = 0.5 * torch.sum(
            diff_buf[Bd: nb + Bd] * scatter_local(mass_apply(diff_buf)))
        psi = mat.psi_s_all(s_t, mu_e, lam_e, mid, models)
        e_el = dt2 * torch.sum(vol * psi * em)
        Sv_t = sym.pack(rotation.polar(F_of(xtbuf), d)[1])
        e_c = torch.sum(vol * em * torch.einsum("ei,ei->e", la_t,
                                                w_sym * (Sv_t - s_t)))
        return comm.psum(e_in + e_el + e_c)

    tgtbuf0 = halo(target)
    if use_coarse:
        # the rigid modes of the owned rows and of the halo'd rows (static
        # over the step)
        B_own = _modes_of(rp.r_v, fm, d)                     # (nb, d, 6)
        Be = _modes_of(halo(rp.r_v), halo(fmc)[:, 0], d)[Tl]  # (Ep, k, d, 6)

    def newton_iteration(xx, ss, ccd_d, ccla, ccact, E_prev):
        xbuf = halo(xx)
        F = F_of(xbuf)
        R, S = rotation.polar(F, d)
        Sv = sym.pack(S)
        Dt = rotation.dsdF(R, S, d)
        Hm, _Hinv, Hs, _evals, gm = ms._material_terms(ss, mu_e, lam_e, mid,
                                                       models, h)
        G, Gw = smallops.contract_G_Gw(Dt, dphi, Hs, vol)             # K3
        Gw = Gw * em[:, None, None, None]

        if use_contact:
            cverts = gather_frames(xx)
            Dc = dist.frame_distance(cverts, ftype)
            Gxc = dist.frame_distance_grad(cverts, ftype)
            newly = Dc < dhat
            keep = (ccact > 0) & (ccd_d < dhat)
            was = ccact > 0
            cdv = torch.where(was, ccd_d, Dc)
            af = (newly | keep).to(dtype)
            gc, Hc = bar.mixed_barrier_grad_hess(cdv, dhat, kappa)
            gc = gc * af

        # the inertia gradient and the rhs
        diff_buf = xbuf - tgtbuf0
        inertia = scatter_local(mass_apply(diff_buf)) * fmc
        y = (torch.einsum("eij,ej->ei", Hm, Sv - ss) + gm) \
            * em[:, None]
        b = -inertia + scatter_local(
            -torch.einsum("eikr,ei,e->ekr", G, y, vol)) * fmc
        if use_contact:
            glc = Hc * (Dc - cdv) + gc
            b = b + scatter_frames_own(-Gxc * (glc * af)[:, None, None]) * fmc

        # block-Jacobi from the mass and Gw blocks
        blk_e = torch.einsum("eikr,eiks->ekrs", Gw, Gw) + (
            torch.diagonal(mc, dim1=1, dim2=2)[..., None, None] * eye_d)
        blocks = scatter_local(blk_e)
        if use_contact:
            Bc = torch.einsum("ckr,cks,c->ckrs", Gxc, Gxc, Hc * af)
            blocks = blocks + scatter_frames_own(
                Bc.reshape(nC, 4, d * d)).reshape(nb, d, d)
        mask = fm[:, None, None]
        binv = pcgmod._small_inv(blocks * mask + eye_d * (1.0 - mask))

        def bj_apply(r):
            return torch.einsum("nij,nj->ni", binv, r) * fmc

        if use_coarse:
            # each rank's Galerkin blocks summed per aggregate pair (K2),
            # one psum of the pair sums, the same dense matrix and inverse
            # on every rank
            blk_c = torch.einsum("ekl,ekra,elrb->eklab", mc, Be, Be)
            GB = torch.einsum("eikr,ekra->eika", Gw, Be)
            blk_c = blk_c + torch.einsum("eika,eilb->eklab", GB, GB)
            blk_c = blk_c * em[:, None, None, None, None]
            Ep, k = Tl.shape
            sums = assembly.segment_sum(
                rp.pair_plan, blk_c.reshape(Ep, k * k, 36))[:-1]
            sums = comm.psum(sums)
            Ac = torch.zeros((naggr, naggr, 6, 6), dtype=dtype, device=dev)
            Ac.index_put_((rp.pair_rows, rp.pair_cols),
                          sums.reshape(-1, 6, 6), accumulate=True)
            Ac = Ac.permute(0, 2, 1, 3).reshape(ncd, ncd)
            ridge = torch.trace(Ac) / ncd + 1e-30
            Ac = Ac + (1e-6 * ridge) * torch.eye(ncd, dtype=dtype, device=dev)
            Acinv = _ns_inverse(Ac)

            def Minv(r):
                z = bj_apply(r)
                rc = assembly.segment_sum(
                    rp.agg_plan, torch.einsum("nda,nd->na", B_own, r)[:, None])
                rc = comm.psum(rc.reshape(-1))
                zc = (Acinv @ rc).reshape(naggr, 6)
                return z + torch.einsum("nda,na->nd", B_own,
                                        zc[rp.agg_v]) * fmc
        else:
            Minv = bj_apply

        def A(p):
            p = p * fmc
            out = scatter_local(element_rows(Tl32, Gw, mc, halo(p))) * fmc  # K1, K2
            if use_contact:
                pv = gather_frames(p)
                Gdx = torch.einsum("ckd,ckd->c", Gxc, pv)
                out = out + scatter_frames_own(
                    Gxc * (Hc * Gdx * af)[:, None, None]) * fmc
            return out

        # PCG with psum'd dots, warm-started at the explicit-Euler prediction
        dx = (target - xx) * fmc
        bn2 = pdot(b, b)
        safe_b = torch.where(bn2 > 0, bn2, torch.ones_like(bn2))
        tol2 = (config.itr_tol ** 2) * safe_b
        def dots(r, z):
            """(r . z, r . r), one psum for the pair."""
            return comm.psum(torch.stack([torch.sum(r * z), torch.sum(r * r)]))

        r = b - A(dx)
        z = Minv(r)
        p = z
        rz, rr = dots(r, z)
        cg_it = 0
        while cg_it < config.max_iterative_solver_iters and bool(rr > tol2):
            Ap = A(p)
            pAp = pdot(p, Ap)
            alpha = rz / torch.where(pAp != 0, pAp, torch.ones_like(pAp))
            dx = dx + alpha * p
            r = r - alpha * Ap
            z = Minv(r)
            rz_new, rr = dots(r, z)
            beta = rz_new / torch.where(rz != 0, rz, torch.ones_like(rz))
            p = z + beta * p
            rz = rz_new
            cg_it += 1

        # the local (ds, la) recovery
        dxbuf = halo(dx)
        ds = ((Sv - ss) + torch.einsum("eikr,ekr->ei", G, dxbuf[Tl])) \
            * em[:, None]
        la_new = syminv * (torch.einsum("eij,ej->ei", Hm, ds)
                           + gm) * em[:, None]
        dec_new = comm.pmax(torch.stack([dx.abs().amax(),
                                         ds.abs().amax()])).amax()

        if use_contact:
            dxv = gather_frames(dx)
            cdd = ((Dc - cdv) + torch.einsum("ckd,ckd->c", Gxc, dxv)) * af
            cla_new = (Hc * cdd + gc) * af
            dec_new = torch.maximum(dec_new, cdd.abs().amax())
            act_prev = af > 0

            def contact_merit(vt, cd_t):
                D_t = dist.frame_distance(vt, ftype)
                d_eff = torch.where(act_prev, cd_t, D_t)
                act = act_prev | (D_t < dhat)
                e = mcmod.energy(d_eff, act.to(dtype), dhat, kappa)
                mm = (act_prev & ((D_t <= dhat) | (cd_t <= dhat))).to(dtype)
                return e + torch.sum(cla_new * (D_t - cd_t) * mm)
        else:
            cdd, cla_new = torch.zeros_like(ccd_d), ccla
            cdv, af = ccd_d, ccact

        E = merit(xx, ss, la_new, tgtbuf0)
        if use_contact:
            E = E + contact_merit(cverts, cdv)
        res_new = torch.abs((E - E_prev) / (E + 1e-6))

        # the CCD step-size clamp (newton_optimizer.cpp:49-61)
        alpha = 1.0
        if use_contact and config.enable_ccd:
            alpha = float(0.9 * accdmod.accd_t(cverts, dxv, ftype).amin())

        ls_k = 0
        while ls_k < config.ls_iters:
            Ea = merit(xx + alpha * dx, ss + alpha * ds, la_new, tgtbuf0)
            if use_contact:
                Ea = Ea + contact_merit(cverts + alpha * dxv, cdv + alpha * cdd)
            if not bool(Ea >= E):
                break
            alpha *= 0.5
            ls_k += 1
        step = alpha if ls_k < config.ls_iters else 0.0
        return (xx + step * dx, ss + step * ds, la_new, cdv + step * cdd,
                cla_new, af, E, dec_new, res_new, cg_it)

    xx, ss, ll = x, s, la
    zC = x.new_zeros((nC,))
    ccd_d, ccla, ccact = zC, zC, zC
    it, cg_sum = 0, 0
    E = x.new_zeros(())
    dec = res = float("inf")
    while it < outer and dec > config.newton_tol and res > 1e-12:
        (xx, ss, ll, ccd_d, ccla, ccact, E, dec_t, res_t,
         cg_it) = newton_iteration(xx, ss, ccd_d, ccla, ccact, E)
        it += 1
        cg_sum += cg_it
        dec, res = float(dec_t), float(res_t)
    if bdf is not None:
        # v = (x - sum_i a_i x_{n-i}) / (beta h) (BDF.cpp:16-27)
        v_new = (xx - bdfmod._weighted(bdf.x_hist, bdf.order)) / h
    else:
        v_new = (xx - x) / h
    return xx, v_new, ss, torch.zeros_like(ll), it, dec, cg_sum
