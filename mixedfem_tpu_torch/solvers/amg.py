"""Host smoothed-aggregation AMG on the dual system, the reference's
"subspace-amgcl" (port of mixedfem_tpu/solvers/amg.py).

The reference runs amgcl on the CPU (src/linear_solvers/amgcl_solver.h:
20-85): smoothed-aggregation coarsening with block size N (6 in 3D, 3 in
2D, the per-element multiplier block), SPAI(0) relaxation and a CG outer
solver on the assembled dual-condensed system. As there, this path
assembles and solves on the host in float64; the Newton loop around it is
optimizer/newton_direct.py. The dual system is the Schur complement that
solvers/dual.py applies matrix-free (lumped-mass elimination):

  S = C Ml^{-1} C^T + W (vol H)^{-1} W,      C = vol * Sym G
  S dlam = C Ml^{-1} r_x - W (vol H)^{-1} r_s - r_l
  dx = Ml^{-1}(r_x - C^T dlam),   ds = (vol H)^{-1}(r_s + W dlam)

amgcl's defaults, as in the JAX package: strength of connection on the
block graph |A_ef|_F > eps sqrt(|A_ee|_F |A_ff|_F) with eps 0.08; greedy
root aggregation over strong neighbors; block-identity tentative
prolongator smoothed by damped Jacobi, omega = 4 / (3 rho) with rho from
10 power iterations on D^{-1} A; SPAI(0) smoothing, one pre- and one
post-sweep; a dense pseudo-inverse at the coarsest level; V(1,1) cycles
as the CG preconditioner.
"""

from __future__ import annotations

import contextlib

import numpy as np
import scipy.sparse as sp
import torch

from mixedfem_tpu_torch.ops import sym as symmod
from mixedfem_tpu_torch.solvers.direct import host


def _f64(a) -> np.ndarray:
    return host(a).astype(np.float64)


def _weights(dim: int) -> np.ndarray:
    return symmod.sym_weights(dim, dtype=torch.float64).numpy()


def assemble_dual(mesh, c):
    """The dual Schur matrix S (N E x N E scipy CSR) and the pieces of the
    rhs and the recovery: (S, C (N E x d nv CSR, pinned columns zero),
    the lumped inverse mass per dof (d nv,), the (E, N, N) blocks of
    W (vol H)^{-1} W)."""
    T = host(mesh.T)
    G = _f64(c.G)                           # (E, N, k, d)
    vols = _f64(mesh.vols)
    Hinv = _f64(c.Hinv)                     # (E, N, N)
    E, N, k, d = G.shape
    nv = mesh.nv
    w = _weights(mesh.dim)                  # (N,)
    free = host(mesh.free_mask) > 0
    dof_free = np.repeat(free, d)

    # C[eN+i, T[e,k]*d+r] = vols[e] * w[i] * G[e,i,k,r]; pinned columns zero
    rows = (np.arange(E)[:, None, None, None] * N
            + np.arange(N)[None, :, None, None])
    rows = np.broadcast_to(rows, (E, N, k, d)).reshape(-1)
    cols = (T[:, None, :, None] * d + np.arange(d)[None, None, None, :])
    cols = np.broadcast_to(cols, (E, N, k, d)).reshape(-1)
    vals = (vols[:, None, None, None] * w[None, :, None, None] * G).reshape(-1)
    vals = np.where(dof_free[cols], vals, 0.0)
    C = sp.coo_matrix((vals, (rows, cols)), shape=(N * E, d * nv)).tocsr()

    ml = _f64(mesh.mass_lumped)
    mlinv = np.where(ml > 0, 1.0 / ml, 0.0)
    mlinv_dof = np.repeat(mlinv, d) * dof_free

    # W (vol H)^{-1} W, block diagonal: vol * w_i Hinv[e, i, j] w_j
    blocks = vols[:, None, None] * (w[:, None] * Hinv * w[None, :])
    Bd = sp.bsr_matrix((blocks, np.arange(E), np.arange(E + 1)),
                       shape=(N * E, N * E)).tocsr()
    S = (C @ sp.diags(mlinv_dof) @ C.T + Bd).tocsr()
    return S, C, mlinv_dof, blocks


class SAAMG:
    """Smoothed-aggregation AMG hierarchy with SPAI(0) smoothing."""

    def __init__(self, A: sp.csr_matrix, block_size: int,
                 eps_strong: float = 0.08, max_levels: int = 10,
                 coarse_size: int = 60):
        self.levels = []
        self.block_size = block_size
        while len(self.levels) < max_levels and A.shape[0] > coarse_size:
            P = self._sa_prolongator(A, block_size, eps_strong)
            if P is None or P.shape[1] >= A.shape[0]:
                break
            self.levels.append((A, P, self._spai0(A)))
            A = (P.T @ A @ P).tocsr()
        self.A_coarse = A.toarray()
        # dense coarsest solve; the pseudo-inverse guards the semidefinite
        # all-pinned corner case
        self.A_coarse_inv = np.linalg.pinv(self.A_coarse)

    @staticmethod
    def _spai0(A: sp.csr_matrix) -> np.ndarray:
        """SPAI(0): the diagonal M minimizing |I - M A|_F,
        m_i = a_ii / sum_j a_ij^2."""
        d = A.diagonal()
        row_sq = np.asarray(A.multiply(A).sum(axis=1)).ravel()
        return np.where(row_sq > 0, d / row_sq, 0.0)

    @staticmethod
    def _sa_prolongator(A: sp.csr_matrix, bs: int, eps: float):
        """Aggregate the block graph and smooth the tentative block-identity
        prolongator; None when the aggregation does not coarsen."""
        n = A.shape[0]
        nb = n // bs
        # block graph by Frobenius norms
        coo = A.tocoo()
        br, bc = coo.row // bs, coo.col // bs
        Bn = sp.coo_matrix((coo.data ** 2, (br, bc)), shape=(nb, nb)).tocsr()
        Bn.sum_duplicates()
        diag = Bn.diagonal()
        # strong connections: |A_ef|_F > eps sqrt(|A_ee|_F |A_ff|_F)
        Bc = Bn.tocoo()
        thresh = (eps ** 2) * np.sqrt(
            np.maximum(diag[Bc.row], 0) * np.maximum(diag[Bc.col], 0))
        strong = (Bc.data > thresh) & (Bc.row != Bc.col)
        Gs = sp.coo_matrix(
            (np.ones(strong.sum()), (Bc.row[strong], Bc.col[strong])),
            shape=(nb, nb)).tocsr()

        # greedy root aggregation: roots whose strong neighbors are all
        # free take them; then leftovers join a neighbor's aggregate
        agg = np.full(nb, -1, np.int64)
        na = 0
        indptr, indices = Gs.indptr, Gs.indices
        for i in range(nb):
            if agg[i] >= 0:
                continue
            nbrs = indices[indptr[i]:indptr[i + 1]]
            if (agg[nbrs] >= 0).any():
                continue
            agg[i] = na
            agg[nbrs] = na
            na += 1
        for i in range(nb):
            if agg[i] >= 0:
                continue
            nbrs = indices[indptr[i]:indptr[i + 1]]
            owned = nbrs[agg[nbrs] >= 0]
            if len(owned):
                agg[i] = agg[owned[0]]
            else:
                agg[i] = na
                na += 1
        if na >= nb:
            return None

        # tentative block-identity prolongator (n x na bs)
        rows = np.arange(n)
        cols = agg[rows // bs] * bs + (rows % bs)
        Pt = sp.coo_matrix((np.ones(n), (rows, cols)),
                           shape=(n, na * bs)).tocsr()

        # damped Jacobi smoothing: P = (I - omega D^{-1} A) Pt
        dinv = 1.0 / np.maximum(A.diagonal(), 1e-300)
        DA = sp.diags(dinv) @ A
        x = np.ones(n) / np.sqrt(n)
        rho = 1.0
        for _ in range(10):
            y = DA @ x
            ny = np.linalg.norm(y)
            if ny == 0:
                break
            rho = ny
            x = y / ny
        omega = 4.0 / (3.0 * max(rho, 1e-12))
        return (Pt - omega * (DA @ Pt)).tocsr()

    def vcycle(self, b: np.ndarray, lvl: int = 0) -> np.ndarray:
        if lvl == len(self.levels):
            return self.A_coarse_inv @ b
        A, P, spai = self.levels[lvl]
        x = spai * b                          # pre-smooth from x = 0
        r = b - A @ x
        x = x + P @ self.vcycle(P.T @ r, lvl + 1)
        return x + spai * (b - A @ x)         # post-smooth


def solve_amg_cg(S: sp.csr_matrix, b: np.ndarray, block_size: int,
                 tol: float, maxiter: int, amg: SAAMG | None = None):
    """CG on the dual system with one V(1,1) cycle of the hierarchy (built
    here unless `amg` is given) as the preconditioner, amgcl's test
    |r| <= tol |b|. Returns (x, iterations)."""
    if amg is None:
        amg = SAAMG(S, block_size)
    x = np.zeros_like(b)
    r = b.copy()
    nb = float(np.linalg.norm(b))
    if nb == 0.0:
        return x, 0
    z = amg.vcycle(r)
    p = z.copy()
    rz = float(r @ z)
    it = 0
    while float(np.linalg.norm(r)) > tol * nb and it < maxiter:
        Sp = S @ p
        alpha = rz / float(p @ Sp)
        x += alpha * p
        r -= alpha * Sp
        z = amg.vcycle(r)
        rz_new = float(r @ z)
        p = z + (rz_new / rz) * p
        rz = rz_new
        it += 1
    return x, it


def dual_rhs(mesh, c, rhs_kkt, S_parts):
    """The dual right-hand side b (N E,) and the recovery of (dx, ds) from
    dlam: (b, recover), with S_parts the tail of assemble_dual."""
    C, mlinv_dof, _ = S_parts
    r_x, r_s, r_l = (_f64(r) for r in rhs_kkt[:3])
    E, N = r_s.shape
    d = mesh.dim
    vols = _f64(mesh.vols)
    Hinv = _f64(c.Hinv)
    w = _weights(d)

    def Hv_inv(v):  # (E, N) -> (E, N)
        return np.einsum("eij,ej->ei", Hinv, v) / vols[:, None]

    rx_flat = r_x.reshape(-1)
    vw = vols[:, None] * w[None, :]
    b = (C @ (mlinv_dof * rx_flat)).reshape(E, N) - vw * Hv_inv(r_s) - r_l

    def recover(dl_flat):
        dx = (mlinv_dof * (rx_flat - C.T @ dl_flat)).reshape(-1, d)
        ds = Hv_inv(r_s + vw * dl_flat.reshape(E, N))
        return dx, ds, dl_flat.reshape(E, N)

    return b.reshape(-1), recover


def solve_dual_amg(mesh, c, rhs_kkt, tol: float, maxiter: int,
                   stage=None, system: dict | None = None):
    """The full dual solve with AMG-preconditioned CG: rhs_kkt = (r_x, r_s,
    r_l) from solvers/minres.kkt_rhs. Returns (dx, ds, dlam, iterations)
    as float64 numpy arrays (the host path's type). `stage(name)`, where
    given, returns a context manager that times each stage ('assemble',
    'amg_setup', 'factor_solve'); `system`, where given, receives the nnz
    of S and the AMG levels (the coarsest dense level included)."""
    if stage is None:
        stage = lambda name: contextlib.nullcontext()  # noqa: E731
    with stage("assemble"):
        S, C, mlinv_dof, blocks = assemble_dual(mesh, c)
        b, recover = dual_rhs(mesh, c, rhs_kkt, (C, mlinv_dof, blocks))
    with stage("amg_setup"):
        amg = SAAMG(S, c.Hinv.shape[-1])
    with stage("factor_solve"):
        dl, iters = solve_amg_cg(S, b, amg.block_size, tol=tol,
                                 maxiter=maxiter, amg=amg)
        dx, ds, dl = recover(dl)
    if system is not None:
        system.update(nnz=S.nnz, shift=None, levels=len(amg.levels) + 1)
    return dx, ds, dl, iters
