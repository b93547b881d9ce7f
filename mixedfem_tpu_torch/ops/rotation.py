"""Batched 3x3 and 2x2 polar decompositions and rotation derivatives
(port of mixedfem_tpu/ops/rotation.py).

- Symmetric eigendecomposition by cyclic Jacobi with a FIXED sweep count
  (branch-free; the same rotations, in the same order, as the JAX package).
- Signed-sigma SVD: U, V in SO(3), s0 >= s1 >= |s2|, sign(s2) = sign(det F),
  so an inverted element carries its inversion in the smallest singular
  value.
- ds/dF from the polar identity: omega_rc = (tr(S) I - S)^{-1} (e_c x R[r,:]),
  dS_rc = outer(R[r,:], e_c) - skew(omega_rc) S, packed with off-diagonal
  averaging; (tr(S) I - S) is inverted in closed form with a determinant
  guard.
- 2D: closed-form 2x2 polar decomposition and signed SVD, and ds/dF with
  tr(S) guarded away from 0.
- Warm-started polar (`polar_warm`): a fixed count of Newton-Procrustes
  steps on SO(3) from the previous iterate's rotation, which tracks a
  rotation branch through element inversion.
"""

from __future__ import annotations

import torch

from mixedfem_tpu_torch.ops import sym


def _upper_pos(n: int):
    pos = {}
    k = 0
    for i in range(n):
        for j in range(i, n):
            pos[(i, j)] = pos[(j, i)] = k
            k += 1
    return pos


def jacobi_eigh(A: torch.Tensor, sweeps: int = 8):
    """Symmetric eigendecomposition of (..., n, n) by cyclic Jacobi.

    Fixed sweep count, batched, branch-free. Returns (w, V) with
    A ~ V diag(w) V^T; eigenvalues are NOT sorted. Rotation angles use the
    algebraic Givens form tau = (aqq - app) / (2 apq),
    t = sign(tau) / (|tau| + sqrt(1 + tau^2)), c = 1/sqrt(1 + t^2), s = t c.
    Pivots below a relative threshold are skipped (t = 0), which keeps tau
    finite."""
    n = A.shape[-1]
    batch = A.shape[:-2]
    dt, dev = A.dtype, A.device
    Af = A.reshape(-1, n, n)
    B = Af.shape[0]
    pos = _upper_pos(n)
    iu = torch.triu_indices(n, n, device=dev)
    a = Af[:, iu[0], iu[1]].clone()                       # (B, m) upper rows
    # the identity, derived from the input so that under torch.func.vmap
    # (the F-space Hessians of materials/models.py) the in-place column
    # writes below go into a batched tensor; contiguous whatever Af's
    # strides (an einsum's output may be a permuted view), as the identity
    # was before, so the card's products over V keep their bits
    V = torch.zeros_like(Af, memory_format=torch.contiguous_format) + \
        torch.eye(n, dtype=dt, device=dev)

    f64 = dt == torch.float64
    eps_rel = 1e-14 if f64 else 1e-7
    tiny = 1e-300 if f64 else 1e-30
    zero = torch.zeros((B,), dtype=dt, device=dev)
    one = torch.ones((B,), dtype=dt, device=dev)

    rots = []
    for p in range(n):
        for q in range(p + 1, n):
            others = [k for k in range(n) if k not in (p, q)]
            rots.append((
                p, q, pos[(p, p)], pos[(q, q)], pos[(p, q)],
                torch.tensor([pos[(k, p)] for k in others], device=dev),
                torch.tensor([pos[(k, q)] for k in others], device=dev),
            ))

    for _ in range(sweeps):
        for p, q, ipp, iqq, ipq, ikp, ikq in rots:
            app, aqq, apq = a[:, ipp].clone(), a[:, iqq].clone(), a[:, ipq].clone()
            small = apq.abs() <= eps_rel * (app.abs() + aqq.abs()) + tiny
            apq_safe = torch.where(small, one, apq)
            tau = (aqq - app) / (2.0 * apq_safe)
            root = torch.sqrt(1.0 + tau * tau)
            sgn = torch.where(tau >= 0, one, -one)
            t = sgn / (tau.abs() + root)
            t = torch.where(small, zero, t)
            c = torch.rsqrt(1.0 + t * t)
            s = t * c

            a[:, ipp] = app - t * apq
            a[:, iqq] = aqq + t * apq
            a[:, ipq] = zero
            if ikp.numel():
                akp, akq = a[:, ikp], a[:, ikq]
                cc, ss = c[:, None], s[:, None]
                a[:, ikp] = cc * akp - ss * akq
                a[:, ikq] = ss * akp + cc * akq
            vp, vq = V[:, :, p].clone(), V[:, :, q].clone()
            V[:, :, p] = c[:, None] * vp - s[:, None] * vq
            V[:, :, q] = s[:, None] * vp + c[:, None] * vq

    w = a[:, [pos[(i, i)] for i in range(n)]]
    return w.reshape(*batch, n), V.reshape(*batch, n, n)


def _sort3_desc(w, V):
    """Sort 3 eigenpairs descending by eigenvalue, branch-free network."""
    w, V = w.clone(), V.clone()
    for i, j in ((0, 1), (0, 2), (1, 2)):
        swap = w[..., i] < w[..., j]
        wi = torch.where(swap, w[..., j], w[..., i])
        wj = torch.where(swap, w[..., i], w[..., j])
        vi = torch.where(swap[..., None], V[..., :, j], V[..., :, i])
        vj = torch.where(swap[..., None], V[..., :, i], V[..., :, j])
        w[..., i], w[..., j] = wi, wj
        V[..., :, i], V[..., :, j] = vi, vj
    return w, V


def det3(M: torch.Tensor) -> torch.Tensor:
    """Determinant of (..., 3, 3) by cofactors."""
    return (
        M[..., 0, 0] * (M[..., 1, 1] * M[..., 2, 2] - M[..., 1, 2] * M[..., 2, 1])
        - M[..., 0, 1] * (M[..., 1, 0] * M[..., 2, 2] - M[..., 1, 2] * M[..., 2, 0])
        + M[..., 0, 2] * (M[..., 1, 0] * M[..., 2, 1] - M[..., 1, 1] * M[..., 2, 0])
    )


def _normalize_safe(v, fallback, eps):
    n = torch.linalg.vector_norm(v, dim=-1, keepdim=True)
    ok = n > eps
    return torch.where(ok, v / torch.where(ok, n, torch.ones_like(n)), fallback)


def svd33(F: torch.Tensor, sweeps: int = 6):
    """Batched signed SVD of (..., 3, 3): F = U diag(s) V^T with U, V in
    SO(3), s0 >= s1 >= |s2|, sign(s2) = sign(det F)."""
    dt = F.dtype
    eps = 1e-12 if dt == torch.float64 else 1e-20
    C = torch.einsum("...ki,...kj->...ij", F, F)
    w, V = jacobi_eigh(C, sweeps=sweeps)
    w, V = _sort3_desc(w, V)
    # proper rotation V
    sgn = torch.sign(det3(V))
    V = torch.cat([V[..., :, :2], V[..., :, 2:] * sgn[..., None, None]], dim=-1)

    A = F @ V                                             # = U diag(s)
    eye = torch.eye(3, dtype=dt, device=F.device)
    ex = eye[0].expand_as(A[..., :, 0])
    ey = eye[1].expand_as(A[..., :, 0])
    u0 = _normalize_safe(A[..., :, 0], ex, eps)
    a1 = A[..., :, 1]
    a1p = a1 - torch.sum(u0 * a1, dim=-1, keepdim=True) * u0
    # fallback direction orthogonal to u0: cross with the least aligned axis
    alt = torch.where(
        (u0[..., 0].abs() > 0.9)[..., None],
        torch.linalg.cross(u0, ey),
        torch.linalg.cross(u0, ex),
    )
    u1 = _normalize_safe(a1p, _normalize_safe(alt, ey, eps), eps)
    u2 = torch.linalg.cross(u0, u1)

    s0 = torch.sum(u0 * A[..., :, 0], dim=-1)
    s1 = torch.sum(u1 * A[..., :, 1], dim=-1)
    s2 = torch.sum(u2 * A[..., :, 2], dim=-1)             # signed
    U = torch.stack([u0, u1, u2], dim=-1)
    s = torch.stack([s0, s1, s2], dim=-1)
    return U, s, V


def polar33(F: torch.Tensor, sweeps: int = 6):
    """Polar decomposition F = R S with R in SO(3) and S symmetric (maybe
    indefinite under inversion)."""
    U, s, V = svd33(F, sweeps=sweeps)
    R = torch.einsum("...ik,...jk->...ij", U, V)
    S = torch.einsum("...ik,...k,...jk->...ij", V, s, V)
    return R, S


def polar22(F: torch.Tensor):
    """Closed-form 2x2 polar decomposition with the signed-sigma convention:
    (R, S) with R = rot(beta), cos = E / Q, sin = H / Q (the identity where
    Q <= 1e-30), and S = sym(R^T F)."""
    E = 0.5 * (F[..., 0, 0] + F[..., 1, 1])
    H = 0.5 * (F[..., 1, 0] - F[..., 0, 1])
    Q = torch.sqrt(E * E + H * H)
    ok = Q > 1e-30
    Qs = torch.where(ok, Q, torch.ones_like(Q))
    c = torch.where(ok, E / Qs, torch.ones_like(E))
    s = torch.where(ok, H / Qs, torch.zeros_like(H))
    R = torch.stack(
        [torch.stack([c, -s], dim=-1), torch.stack([s, c], dim=-1)], dim=-2
    )
    S = torch.einsum("...ki,...kj->...ij", R, F)  # R^T F, symmetric in exact math
    return R, 0.5 * (S + S.transpose(-1, -2))


def svd22(F: torch.Tensor):
    """Closed-form signed 2x2 SVD: F = U diag(s) V^T with U, V in SO(2)."""
    E = 0.5 * (F[..., 0, 0] + F[..., 1, 1])
    Fm = 0.5 * (F[..., 0, 0] - F[..., 1, 1])
    G = 0.5 * (F[..., 1, 0] + F[..., 0, 1])
    H = 0.5 * (F[..., 1, 0] - F[..., 0, 1])
    Q = torch.sqrt(E * E + H * H)
    Rm = torch.sqrt(Fm * Fm + G * G)
    beta = torch.atan2(H, E)    # phi - theta
    alpha = torch.atan2(G, Fm)  # phi + theta
    phi = 0.5 * (alpha + beta)
    theta = 0.5 * (alpha - beta)

    def rot(t):
        c, s = torch.cos(t), torch.sin(t)
        return torch.stack(
            [torch.stack([c, -s], dim=-1), torch.stack([s, c], dim=-1)], dim=-2
        )

    return rot(phi), torch.stack([Q + Rm, Q - Rm], dim=-1), rot(theta)


def polar(F: torch.Tensor, dim: int):
    """Polar decomposition (R, S) of (..., d, d) deformation gradients."""
    return polar33(F) if dim == 3 else polar22(F)


def _sym_inv3(G: torch.Tensor, eps: float) -> torch.Tensor:
    """Closed-form inverse of a symmetric 3x3 with a determinant guard:
    |det| is raised to eps, keeping its sign."""
    det = det3(G)
    guard = torch.where(det >= 0, torch.full_like(det, eps), torch.full_like(det, -eps))
    det = torch.where(det.abs() > eps, det, guard)
    g = lambda i, j: G[..., i, j]  # noqa: E731
    adj = torch.stack(
        [
            torch.stack(
                [
                    g(1, 1) * g(2, 2) - g(1, 2) * g(2, 1),
                    g(0, 2) * g(2, 1) - g(0, 1) * g(2, 2),
                    g(0, 1) * g(1, 2) - g(0, 2) * g(1, 1),
                ],
                dim=-1,
            ),
            torch.stack(
                [
                    g(1, 2) * g(2, 0) - g(1, 0) * g(2, 2),
                    g(0, 0) * g(2, 2) - g(0, 2) * g(2, 0),
                    g(0, 2) * g(1, 0) - g(0, 0) * g(1, 2),
                ],
                dim=-1,
            ),
            torch.stack(
                [
                    g(1, 0) * g(2, 1) - g(1, 1) * g(2, 0),
                    g(0, 1) * g(2, 0) - g(0, 0) * g(2, 1),
                    g(0, 0) * g(1, 1) - g(0, 1) * g(1, 0),
                ],
                dim=-1,
            ),
        ],
        dim=-2,
    )
    return adj / det[..., None, None]


def _rodrigues(w: torch.Tensor) -> torch.Tensor:
    """exp of the cross-product matrix of w (..., 3) -> (..., 3, 3), with
    the series of sin(t)/t and (1 - cos t)/t^2 near t = 0 (both branches
    evaluated, as jnp.where does)."""
    th2 = torch.sum(w * w, dim=-1)
    th = torch.sqrt(th2 + 1e-30)
    big = th2 > 1e-24
    a = torch.where(big, torch.sin(th) / th, 1.0 - th2 / 6.0)
    b = torch.where(big, (1.0 - torch.cos(th)) / torch.clamp(th2, min=1e-30),
                    0.5 - th2 / 24.0)
    z = torch.zeros_like(w[..., 0])
    K = torch.stack(
        [
            torch.stack([z, -w[..., 2], w[..., 1]], dim=-1),
            torch.stack([w[..., 2], z, -w[..., 0]], dim=-1),
            torch.stack([-w[..., 1], w[..., 0], z], dim=-1),
        ],
        dim=-2,
    )
    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    KK = torch.einsum("...ik,...kj->...ij", K, K)
    return eye + a[..., None, None] * K + b[..., None, None] * KK


def polar_warm(F: torch.Tensor, R0: torch.Tensor, iters: int = 5):
    """Warm-started Newton-Procrustes polar decomposition of (..., 3, 3):
    `iters` fixed Newton steps on SO(3) maximizing tr(R^T F) from the seed
    R0 (the previous iterate's rotation). Each step solves

      (tr(sym M) I - sym M) w = axial(M - M^T),   M = R^T F

    (the inverse guarded at |det| 1e-8), caps |w|^2 at (pi/2)^2, and sets
    R <- R exp(w^). Returns (R, S = sym(R^T F)); S is indefinite where the
    branch runs through an inversion. R0 is read contiguous, whatever its
    strides (an expanded identity), so the card's products keep their
    bits."""
    R = R0.contiguous()
    eye = torch.eye(3, dtype=F.dtype, device=F.device)
    for _ in range(iters):
        M = torch.einsum("...ki,...kj->...ij", R, F)
        Ms = 0.5 * (M + M.transpose(-1, -2))
        a = torch.stack(
            [
                M[..., 2, 1] - M[..., 1, 2],
                M[..., 0, 2] - M[..., 2, 0],
                M[..., 1, 0] - M[..., 0, 1],
            ],
            dim=-1,
        )
        tr = Ms.diagonal(dim1=-2, dim2=-1).sum(-1)
        Hinv = _sym_inv3(tr[..., None, None] * eye - Ms, 1e-8)
        w = torch.einsum("...ij,...j->...i", Hinv, a)
        # the bounded step keeps the fixed-count iteration stable far from
        # the optimum: |w|^2 <= (pi/2)^2
        wn2 = torch.sum(w * w, dim=-1, keepdim=True)
        w = w * torch.sqrt(torch.clamp(2.4674011 / torch.clamp(wn2, min=1e-30),
                                       max=1.0))
        R = torch.einsum("...ik,...kj->...ij", R, _rodrigues(w))
    S = torch.einsum("...ki,...kj->...ij", R, F)
    return R, 0.5 * (S + S.transpose(-1, -2))


def dsdF33(R: torch.Tensor, S: torch.Tensor) -> torch.Tensor:
    """ds/dF for the 3D sym-vec stretch, (..., 6, 3, 3):
    dsdF[..., i, r, c] = d s_i / d F_rc."""
    dt = R.dtype
    eps = 1e-10 if dt == torch.float64 else 1e-6
    eye = torch.eye(3, dtype=dt, device=R.device)
    trS = S.diagonal(dim1=-2, dim2=-1).sum(-1)
    Ginv = _sym_inv3(trS[..., None, None] * eye - S, eps)

    # t[..., r, c, :] = e_c x R[r, :]
    Rr = R[..., :, None, :]                               # (..., r, 1, a)
    e = eye.expand(R.shape[:-2] + (3, 3, 3))              # [..., r, c, :] = e_c
    t = torch.linalg.cross(e, Rr.expand_as(e))            # (..., r, c, 3)
    omega = torch.einsum("...ij,...rcj->...rci", Ginv, t)
    # cx[..., r, c, b, :] = omega_rc x S[:, b]
    St = S.transpose(-1, -2)[..., None, None, :, :]       # (..., 1, 1, b, 3)
    cx = torch.linalg.cross(omega[..., None, :], St)      # (..., r, c, b, 3)
    # dS[..., r, c, a, b] = R[r, a] delta_bc - cx[..., r, c, b, a]
    dS = Rr[..., None] * eye[:, None, :] - cx.transpose(-1, -2)
    return sym.pack(dS).permute(*range(R.ndim - 2), -1, -3, -2)


def dsdF22(R: torch.Tensor, S: torch.Tensor) -> torch.Tensor:
    """ds/dF for the 2D sym-vec stretch, (..., 3, 2, 2):
    omega_rc = (R[r,1] delta_c0 - R[r,0] delta_c1) / tr(S) and
    dS_rc = outer(R[r,:], e_c) - omega_rc J S with J = [[0,-1],[1,0]]; tr(S)
    is raised in magnitude to eps (1e-10 in f64, 1e-6 in f32), keeping its
    sign."""
    dt = R.dtype
    eps = 1e-10 if dt == torch.float64 else 1e-6
    trS = S.diagonal(dim1=-2, dim2=-1).sum(-1)
    guard = torch.where(trS >= 0, torch.full_like(trS, eps),
                        torch.full_like(trS, -eps))
    trS = torch.where(trS.abs() > eps, trS, guard)
    J = torch.tensor([[0.0, -1.0], [1.0, 0.0]], dtype=dt, device=R.device)
    JS = torch.einsum("ab,...bd->...ad", J, S)
    omega = torch.stack([R[..., :, 1], -R[..., :, 0]], dim=-1) / trS[..., None, None]
    eye = torch.eye(2, dtype=dt, device=R.device)
    # outer[..., r, c, a, b] = R[r, a] delta_bc
    outer = R[..., :, None, :, None] * eye[None, :, None, :]
    dS = outer - omega[..., None, None] * JS[..., None, None, :, :]
    d01 = 0.5 * (dS[..., 0, 1] + dS[..., 1, 0])
    return torch.stack([dS[..., 0, 0], dS[..., 1, 1], d01], dim=-3)


def dsdF(R: torch.Tensor, S: torch.Tensor, dim: int) -> torch.Tensor:
    """ds/dF (..., N, d, d) of the sym-vec stretch."""
    return dsdF33(R, S) if dim == 3 else dsdF22(R, S)
