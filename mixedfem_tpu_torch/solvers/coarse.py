"""Two-level preconditioner: block-Jacobi smoother plus a rigid-body coarse
solve (port of mixedfem_tpu/solvers/coarse.py).

Vertices are aggregated into geometric clusters (build_coarse_space) or,
on a structured vertex lattice, into lattice blocks (build_coarse_space_grid,
whose `grid` marker lets the restriction and prolongation run as lattice
reshape-sums); each aggregate is spanned
by its 6 rigid-body modes about its centroid. The Galerkin matrix
A_c = P^T A P is assembled element-wise, inverted densely on the device and
applied as M^{-1} r = blockJacobi(r) + P A_c^{-1} P^T r.

The dense products are torch.matmul in full float32: TF32 is switched off
explicitly (torch.backends.cuda.matmul.allow_tf32 = False) wherever this
module multiplies matrices, since TF32's ~3 decimal digits would spoil the
Newton-Schulz iteration.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from mixedfem_tpu_torch.device import resolve_device
from mixedfem_tpu_torch.mesh import mesh as meshmod
from mixedfem_tpu_torch.ops import assembly
from mixedfem_tpu_torch.variables.mixed_stretch import StretchCoeffs


@dataclasses.dataclass
class CoarseSpace:
    """Static aggregation data."""

    agg_id: torch.Tensor     # (nv,) int64 aggregate per vertex
    r: torch.Tensor          # (nv, 3) X_v - centroid(agg), zero at pins
    pair_id: torch.Tensor    # (E, k, k) int64 bucket of (agg_k, agg_l)
    pair_rows: torch.Tensor  # (npairs,) int64 aggregate row of each bucket
    pair_cols: torch.Tensor  # (npairs,) int64 aggregate col
    agg_plan: assembly.IncidencePlan   # aggregate <- vertex, for P^T r
    pair_plan: assembly.IncidencePlan  # bucket <- (e, k, l), for A_c
    naggr: int
    # lattice-block aggregation ((NI, NJ, NK), (bi, bj, bk)), aggregates in
    # row-major block order; None for geometric clusters
    grid: Optional[tuple] = None

    @property
    def ncd(self) -> int:
        return 6 * self.naggr


def _no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False


def coarse_from_arrays(*, agg_id, r, pair_id, pair_rows, pair_cols, naggr,
                       dtype, device, grid=None) -> CoarseSpace:
    def i64(a):
        return torch.as_tensor(np.asarray(a).astype(np.int64), device=device)

    return CoarseSpace(
        agg_id=i64(agg_id),
        r=torch.tensor(np.asarray(r), dtype=dtype, device=device),
        pair_id=i64(pair_id),
        pair_rows=i64(pair_rows),
        pair_cols=i64(pair_cols),
        agg_plan=assembly.build_incidence_plan(agg_id, int(naggr), device),
        pair_plan=assembly.build_incidence_plan(
            pair_id, len(np.asarray(pair_rows)), device
        ),
        naggr=int(naggr),
        grid=None if grid is None else (
            tuple(int(n) for n in grid[0]), tuple(int(b) for b in grid[1])),
    )


def _pair_buckets(agg_id, T, naggr):
    """Aggregate-pair bucket of every element corner pair (static
    topology): (pair_id (E, k, k), pair_rows, pair_cols)."""
    T = np.asarray(T)
    E, k = T.shape
    ak = agg_id[T]
    prs = np.stack(
        [np.repeat(ak, k, axis=1), np.tile(ak, (1, k))], axis=-1
    ).reshape(-1, 2)
    flatp = prs[:, 0].astype(np.int64) * naggr + prs[:, 1]
    uniqp, pid = np.unique(flatp, return_inverse=True)
    return pid.reshape(E, k, k), uniqp // naggr, uniqp % naggr


def build_coarse_space(
    V: np.ndarray,
    T: np.ndarray,
    is_fixed: np.ndarray,
    target_size: int = 64,
    dtype=torch.float32,
    device="cuda",
) -> CoarseSpace:
    """Geometric grid clustering of vertices into ~target_size aggregates
    (host numpy, then moved to `device`)."""
    dev = resolve_device(device)
    V = np.asarray(V, np.float64)
    nv, d = V.shape
    lo = V.min(axis=0)
    extent = np.maximum(V.max(axis=0) - lo, 1e-12)
    ncells = max(nv / target_size, 1)
    cell = (np.prod(extent) / ncells) ** (1.0 / d)
    keys = np.floor((V - lo) / cell).astype(np.int64)
    flat = keys[:, 0]
    for j in range(1, d):
        flat = flat * 100003 + keys[:, j]
    uniq, agg_id = np.unique(flat, return_inverse=True)
    naggr = len(uniq)

    cent = np.zeros((naggr, d))
    cnt = np.zeros(naggr)
    np.add.at(cent, agg_id, V)
    np.add.at(cnt, agg_id, 1.0)
    cent /= cnt[:, None]
    r = V - cent[agg_id]
    r[np.asarray(is_fixed, bool)] = 0.0
    pair_id, pair_rows, pair_cols = _pair_buckets(agg_id, T, naggr)
    return coarse_from_arrays(
        agg_id=agg_id, r=r, pair_id=pair_id, pair_rows=pair_rows,
        pair_cols=pair_cols, naggr=naggr, dtype=dtype, device=dev,
    )


def build_coarse_space_grid(
    V: np.ndarray,
    T: np.ndarray,
    is_fixed: np.ndarray,
    grid_dims: tuple[int, int, int],
    block=None,
    target_size: int = 48,
    dtype=torch.float32,
    device="cuda",
) -> CoarseSpace:
    """Lattice-block aggregation of a structured box grid (ops/stencil.py):
    an aggregate is a (bi, bj, bk) vertex sub-lattice. `block=None` picks
    per-axis sizes so that blocks are about physically cubic with about
    target_size vertices. Host numpy, then moved to `device`."""
    dev = resolve_device(device)
    V = np.asarray(V, np.float64)
    nv, d = V.shape
    NI, NJ, NK = grid_dims
    if NI * NJ * NK != nv:
        raise ValueError(f"a {grid_dims} lattice for {nv} vertices")
    if block is None:
        spacing = np.array([
            (V[:, 0].max() - V[:, 0].min()) / max(NI - 1, 1),
            (V[:, 1].max() - V[:, 1].min()) / max(NJ - 1, 1),
            (V[:, 2].max() - V[:, 2].min()) / max(NK - 1, 1),
        ])
        spacing = np.maximum(spacing, 1e-12)
        edge = (np.prod(spacing) * target_size) ** (1.0 / 3.0)
        block = np.maximum(1, np.rint(edge / spacing).astype(int))
    if np.isscalar(block):
        block = (int(block),) * 3
    bi, bj, bk = int(block[0]), int(block[1]), int(block[2])
    nbi, nbj, nbk = -(-NI // bi), -(-NJ // bj), -(-NK // bk)
    ii, jj, kk = np.meshgrid(
        np.arange(NI), np.arange(NJ), np.arange(NK), indexing="ij"
    )
    agg_id = ((ii // bi) * nbj + (jj // bj)) * nbk + (kk // bk)
    agg_id = agg_id.reshape(-1).astype(np.int64)
    naggr = nbi * nbj * nbk

    cent = np.zeros((naggr, d))
    cnt = np.zeros(naggr)
    np.add.at(cent, agg_id, V)
    np.add.at(cnt, agg_id, 1.0)
    cent /= np.maximum(cnt, 1.0)[:, None]
    r = V - cent[agg_id]
    r[np.asarray(is_fixed, bool)] = 0.0
    pair_id, pair_rows, pair_cols = _pair_buckets(agg_id, T, naggr)
    return coarse_from_arrays(
        agg_id=agg_id, r=r, pair_id=pair_id, pair_rows=pair_rows,
        pair_cols=pair_cols, naggr=naggr, dtype=dtype, device=dev,
        grid=((NI, NJ, NK), (bi, bj, bk)),
    )


def _vert_modes(cs: CoarseSpace, free_mask: torch.Tensor, dim: int = 3):
    """(nv, d, 6) per-vertex rigid-mode matrix B_v = [I, -skew(r_v)],
    zeroed at pinned vertices."""
    r = cs.r
    nv = r.shape[0]
    zero = torch.zeros((nv,), dtype=r.dtype, device=r.device)
    sk = torch.stack(
        [
            torch.stack([zero, r[:, 2], -r[:, 1]], dim=-1),
            torch.stack([-r[:, 2], zero, r[:, 0]], dim=-1),
            torch.stack([r[:, 1], -r[:, 0], zero], dim=-1),
        ],
        dim=-2,
    )                                                   # -skew(r)
    eye = torch.eye(3, dtype=r.dtype, device=r.device).expand(nv, 3, 3)
    B = torch.cat([eye, sk], dim=-1)                    # (nv, 3, 6)
    return B[:, :dim, :] * free_mask[:, None, None]


@dataclasses.dataclass
class ContactPairs:
    """The aggregate pairs that a set of contact frames' coarse blocks land
    on, and the plan that sums the (frame, k, l) blocks per pair."""

    rows: torch.Tensor  # (npairs,) int64 aggregate row of each pair
    cols: torch.Tensor  # (npairs,) int64 aggregate col
    plan: assembly.IncidencePlan  # pair <- (frame, k, l)


def contact_pairs(cs: CoarseSpace, frames: np.ndarray, device) -> ContactPairs:
    """Pair plan of contact frames `frames` (n, 4) (host vertex ids): frame
    corners k, l join aggregates (agg_k, agg_l), which may lie on two
    objects and so outside the element pair plan. Built on the host."""
    a = cs.agg_id.cpu().numpy()[np.asarray(frames, np.int64)]    # (n, 4)
    flat = a[:, :, None] * cs.naggr + a[:, None, :]               # (n, 4, 4)
    uniq, pid = np.unique(flat.reshape(-1), return_inverse=True)
    return ContactPairs(
        rows=torch.as_tensor(uniq // cs.naggr, device=device),
        cols=torch.as_tensor(uniq % cs.naggr, device=device),
        plan=assembly.build_incidence_plan(pid, len(uniq), device),
    )


def coarse_matrix(
    mesh: meshmod.MeshData, cs: CoarseSpace, ms_coeffs: Optional[StretchCoeffs],
    contact=None,
) -> torch.Tensor:
    """Galerkin A_c = P^T (M + K [+ K_contact]) P, dense (6 naggr, 6 naggr),
    with a ridge of 3e-6 ||A_c||_inf against f32 assembly roundoff and rank
    deficiency. The element blocks are summed per aggregate pair through the
    pair plan (kernel K2 on the card), in a fixed order. `contact` is
    (ContactPairs of m frames, their vertex ids (m, 4), Gx (m, 4, 3), H
    (m,)): the barrier blocks Gx H Gx^T, summed per aggregate pair through
    the pair plan (K2) and added once per pair."""
    _no_tf32()
    dt = mesh.vols.dtype
    B = _vert_modes(cs, mesh.free_mask, mesh.dim)
    Be = B[mesh.T]                                      # (E, k, d, 6)
    blocks = torch.einsum("ekl,ekra,elrb->eklab", mesh.mass_coeff, Be, Be)
    if ms_coeffs is not None:
        GB = torch.einsum("eikr,ekra->eika", ms_coeffs.G, Be)
        Y = torch.einsum("eij,eika->ejka", ms_coeffs.H, GB)
        blocks = blocks + torch.einsum("ejka,ejlb,e->eklab", Y, GB, mesh.vols)
    npairs = cs.pair_rows.shape[0]
    E, k = mesh.T.shape
    pair_sums = assembly.segment_sum(cs.pair_plan, blocks.reshape(E, k * k, 36))

    ncd = cs.ncd
    Ac = torch.zeros((cs.naggr, cs.naggr, 6, 6), dtype=dt, device=blocks.device)
    # each (row, col) bucket occurs once, so the accumulation has no race
    Ac.index_put_(
        (cs.pair_rows, cs.pair_cols), pair_sums.reshape(npairs, 6, 6),
        accumulate=True,
    )
    if contact is not None and contact[1].shape[0]:
        pairs, frames, Gx, Hc = contact
        Y = torch.einsum("ckr,ckra->cka", Gx, B[frames])
        blocks_c = torch.einsum("cka,clb,c->cklab", Y, Y, Hc)
        sums = assembly.segment_sum(pairs.plan,
                                    blocks_c.reshape(frames.shape[0], 16, 36))
        Ac.index_put_((pairs.rows, pairs.cols), sums.reshape(-1, 6, 6),
                      accumulate=True)
    Ac = Ac.permute(0, 2, 1, 3).reshape(ncd, ncd)
    scale = torch.amax(torch.sum(Ac.abs(), dim=1)) + 1e-30
    return Ac + (3e-6 * scale) * torch.eye(ncd, dtype=dt, device=Ac.device)


def coarse_inverse(Ac: torch.Tensor) -> torch.Tensor:
    """Dense inverse by LU."""
    return torch.linalg.inv(Ac)


def coarse_inverse_ns(
    Ac: torch.Tensor,
    X0: Optional[torch.Tensor] = None,
    cold_iters: int = 36,
    warm_iters: int = 10,
) -> torch.Tensor:
    """Matmul-only Newton-Schulz inverse X <- X (2I - A X).

    Cold start X0 = I / ||A||_inf. A warm start (the previous inverse) is
    used only when a power-iteration estimate of ||I - A X0||_2 is finite
    and below 0.9, so the iteration cannot diverge."""
    _no_tf32()
    ncd = Ac.shape[0]
    dt, dev = Ac.dtype, Ac.device
    eye = torch.eye(ncd, dtype=dt, device=dev)
    cold = eye * (1.0 / torch.clamp(torch.amax(torch.sum(Ac.abs(), 1)), min=1e-30))

    def ns(X, iters):
        for _ in range(iters):
            X = X @ (2.0 * eye - Ac @ X)
        return 0.5 * (X + X.T)

    if X0 is None:
        return ns(cold, cold_iters)

    E = eye - Ac @ X0
    v = torch.full((ncd,), 1.0 / np.sqrt(ncd), dtype=dt, device=dev)
    for _ in range(6):
        w = E @ (E.T @ v)
        v = w / torch.clamp(torch.linalg.vector_norm(w), min=1e-30)
    sigma = torch.linalg.vector_norm(E @ v)
    if bool(torch.logical_and(sigma < 0.9, torch.isfinite(sigma))):
        return ns(X0, warm_iters)
    return ns(cold, cold_iters)


def grid_transfer(cs: CoarseSpace):
    """(restrict, prolong) of a grid coarse space: per-vertex rigid-mode
    weights (nv, 6) summed per lattice block by a reshape-sum, and
    per-aggregate values (naggr, 6) broadcast back to the block's
    vertices."""
    (NI, NJ, NK), (bi, bj, bk) = cs.grid
    nbi, nbj, nbk = -(-NI // bi), -(-NJ // bj), -(-NK // bk)
    pad = (0, 0, 0, nbk * bk - NK, 0, nbj * bj - NJ, 0, nbi * bi - NI)

    def restrict(w):
        w3 = torch.nn.functional.pad(w.reshape(NI, NJ, NK, 6), pad)
        return (w3.reshape(nbi, bi, nbj, bj, nbk, bk, 6)
                .sum(dim=(1, 3, 5)).reshape(cs.naggr, 6))

    def prolong(zc):
        z6 = (zc.reshape(nbi, 1, nbj, 1, nbk, 1, 6)
              .expand(nbi, bi, nbj, bj, nbk, bk, 6)
              .reshape(nbi * bi, nbj * bj, nbk * bk, 6))
        return z6[:NI, :NJ, :NK].reshape(NI * NJ * NK, 6)

    return restrict, prolong


def two_level_preconditioner(cs: CoarseSpace, free_mask, bj_apply, dim: int = 3):
    """M^{-1}(r, Ac_inv) = bj_apply(r) + P Ac_inv P^T r, with the per-vertex
    rigid-mode matrix hoisted out of the CG loop. The restriction P^T r
    sums per aggregate through the aggregate incidence plan (kernel K2 on
    the card), so every CG iteration is deterministic; on a grid coarse
    space it is a lattice reshape-sum and the prolongation a broadcast."""
    _no_tf32()
    B = _vert_modes(cs, free_mask, dim)
    fm = free_mask[:, None]

    if cs.grid is not None:
        restrict, prolong_modes = grid_transfer(cs)
    else:

        def restrict(w):
            return assembly.segment_sum(cs.agg_plan, w[:, None, :])

        def prolong_modes(zc):
            return zc[cs.agg_id]

    def apply(r, Ac_inv):
        z = bj_apply(r)
        rc = restrict(torch.einsum("nda,nd->na", B, r))
        zc = (Ac_inv @ rc.reshape(-1)).reshape(cs.naggr, 6)
        return z + torch.einsum("nda,na->nd", B, prolong_modes(zc)) * fm

    return apply
