"""Host sparse solves of the condensed system: the reference's direct
solvers (eigen-llt, eigen-ldlt, eigen-lu, cholmod) and its IC(0)-
preconditioned CG (eigen-pcg-IC) (port of mixedfem_tpu/solvers/direct.py).

The condensed SPD matrix P (M + K) P^T is assembled on the host into a
scipy CSR over all dofs (pinned rows and columns are identity) from the
per-element blocks the device computed, and solved by scipy's spsolve or
by CG with the incomplete Cholesky factor of csrc/native.cpp
(utils/native.py). The element blocks are formed in the state's dtype and
summed into float64, as in the JAX package, so a float32 run assembles
the matrix a float32 JAX run assembles. For small scenes: the
factorization's fill grows quickly with the mesh.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla
import torch

from mixedfem_tpu_torch.utils import native


def host(a) -> np.ndarray:
    """A tensor (on any device) or array as a numpy array of its dtype."""
    if torch.is_tensor(a):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _block_coords(frames, d):
    """Row and column dof ids (C, k, k, d, d) of the (d, d) blocks of
    frames (C, k) vertex ids."""
    C, k = frames.shape
    r = frames[:, :, None, None, None] * d + np.arange(d)[None, None, None, :, None]
    c = frames[:, None, :, None, None] * d + np.arange(d)[None, None, None, None, :]
    return (np.broadcast_to(r, (C, k, k, d, d)),
            np.broadcast_to(c, (C, k, k, d, d)))


def assemble_condensed(mesh, ms_coeffs=None, contact=None, v_coeffs=None,
                       frame_hessians=()) -> sp.csr_matrix:
    """Assemble P (M + K) P^T as scipy CSR over all dofs (pinned rows and
    columns are identity, keeping the size fixed). K sums the mixed
    stretch's blocks vol G^T H G (`ms_coeffs`), the mixed-collision
    barrier blocks (`contact` = (frames (n, 4), Gx (n, 4, d), H (n,),
    active (n,)) of the real frames), the vanilla stretch's J^T psi''(F) J
    (`v_coeffs`) and full frame Hessians (`frame_hessians`: [(frames
    (n, 4), H (n, 4d, 4d))], the nodal collision and friction
    variables)."""
    T = host(mesh.T)
    d = mesh.dim
    nv = mesh.nv
    E, k = T.shape
    free = host(mesh.free_mask) > 0

    # element blocks
    Kkl = host(mesh.mass_coeff)[:, :, :, None, None] * np.eye(d)
    if ms_coeffs is not None:
        G, H, vols = host(ms_coeffs.G), host(ms_coeffs.H), host(mesh.vols)
        Kkl = Kkl + np.einsum("eikr,eij,ejls,e->eklrs", G, H, G, vols)
    if v_coeffs is not None:
        # J^T psi''(F) J with dF_rc/dx_ks = delta_{rs} dphidX[k, c]
        dphi = host(mesh.dphidX)
        Hm = host(v_coeffs.H).reshape(E, d, d, d, d)
        Kkl = Kkl + np.einsum("ekc,ercsf,elf->eklrs", dphi, Hm, dphi)
    rows, cols = _block_coords(T, d)
    r, c, v = [rows.reshape(-1)], [cols.reshape(-1)], [Kkl.reshape(-1)]

    if contact is not None:
        frames, Gx, Hc, active = (host(a) for a in contact)
        if len(frames):
            Aloc = np.einsum("ckr,c,cls->cklrs", Gx, Hc * active, Gx)
            fr, fc = _block_coords(frames, d)
            r.append(fr.reshape(-1))
            c.append(fc.reshape(-1))
            v.append(Aloc.reshape(-1))

    for frames_h, Hf in frame_hessians:
        frames_h, Hf = host(frames_h), host(Hf)
        C = len(frames_h)
        if not C:
            continue
        kf = frames_h.shape[1]
        Hm = Hf.reshape(C, kf, d, kf, d).transpose(0, 1, 3, 2, 4)
        fr, fc = _block_coords(frames_h, d)
        r.append(fr.reshape(-1))
        c.append(fc.reshape(-1))
        v.append(Hm.reshape(-1))

    r, c, v = np.concatenate(r), np.concatenate(c), np.concatenate(v)
    # mask pinned dofs
    dof_free = np.repeat(free, d)
    keep = dof_free[r] & dof_free[c]
    A = sp.coo_matrix((v[keep], (r[keep], c[keep])),
                      shape=(nv * d, nv * d)).tocsr()
    # identity on pinned dofs
    pinned = np.nonzero(~dof_free)[0]
    return A + sp.coo_matrix((np.ones(len(pinned)), (pinned, pinned)),
                             shape=A.shape)


def solve_direct(A: sp.csr_matrix, b: np.ndarray) -> np.ndarray:
    """Exact sparse solve (scipy's spsolve on the CSC)."""
    return spla.spsolve(A.tocsc(), b)


def _ichol0_python(indptr, indices, data):
    """The plain version of native.ichol0: the same IC(0) with the same
    shift-and-retry as a Python row loop, in place. For tests at small
    sizes; no solve path calls it."""
    n = len(indptr) - 1
    dmax = max(abs(data[indptr[i + 1] - 1]) for i in range(n)) or 1.0
    a0 = data.copy()
    sigma = 0.0
    for _ in range(12):
        data[:] = a0
        if sigma > 0.0:
            data[indptr[1:] - 1] += sigma * dmax
        ok = True
        for i in range(n):
            r0, r1 = indptr[i], indptr[i + 1]
            for p in range(r0, r1 - 1):
                kk = indices[p]
                ki1 = indptr[kk + 1] - 1
                s, pi, pk = 0.0, r0, indptr[kk]
                while pi < p and pk < ki1:
                    ci, ck = indices[pi], indices[pk]
                    if ci == ck:
                        s += data[pi] * data[pk]
                        pi += 1
                        pk += 1
                    elif ci < ck:
                        pi += 1
                    else:
                        pk += 1
                data[p] = (data[p] - s) / data[ki1]
            piv = data[r1 - 1] - np.dot(data[r0:r1 - 1], data[r0:r1 - 1])
            if piv <= 0.0 or not np.isfinite(piv):
                ok = False
                break
            data[r1 - 1] = np.sqrt(piv)
        if ok:
            return sigma
        sigma = 1e-3 if sigma == 0.0 else sigma * 10.0
    raise np.linalg.LinAlgError("IC(0) breakdown after 12 shift retries")


class ICholPreconditioner:
    """IC(0) of the condensed matrix, A ~ L L^T on A's lower pattern, with
    Eigen's shift-and-retry on breakdown; factorization and triangular
    solves run in native C++ (csrc/native.cpp)."""

    def __init__(self, A: sp.csr_matrix):
        L = sp.tril(A.tocsr(), format="csr")
        L.sort_indices()
        self._indptr = L.indptr.astype(np.int64)
        self._indices = L.indices.astype(np.int64)
        self._data = np.ascontiguousarray(L.data, np.float64)
        self.shift = native.ichol0(self._indptr, self._indices, self._data)

    def apply(self, r: np.ndarray) -> np.ndarray:
        x = np.array(r, np.float64, copy=True)
        native.ichol_solve(self._indptr, self._indices, self._data, x)
        return x


def solve_ic_pcg(A: sp.csr_matrix, b: np.ndarray, tol: float, maxiter: int,
                 M: ICholPreconditioner | None = None):
    """CG on the condensed system with the IC(0) preconditioner (built here
    unless `M` is given) and Eigen's convergence test, |r|^2 <= tol^2 |b|^2.
    Returns (x, iterations)."""
    if M is None:
        M = ICholPreconditioner(A)
    x = np.zeros_like(b)
    r = b.copy()
    thresh = tol * tol * float(r @ r)
    z = M.apply(r)
    p = z.copy()
    rz = float(r @ z)
    it = 0
    while float(r @ r) > thresh and it < maxiter:
        Ap = A @ p
        alpha = rz / float(p @ Ap)
        x += alpha * p
        r -= alpha * Ap
        z = M.apply(r)
        rz_new = float(r @ z)
        p = z + (rz_new / rz) * p
        rz = rz_new
        it += 1
    return x, it
