"""The plain reference of an implicit step of a tet solid, in PyTorch.

It follows the published description of the scene vocabulary's semantics
(evouga/mixed-fem; Trusty et al., "Mixed Variational Finite Elements for
Implicit Simulation of Deformables", 2022) and imports nothing of the
program. One BDF1 step from (x_n, v_n) is the minimiser over the free
vertices of the incremental potential

    E(x) = 1/2 (x - x_tilde - h^2 g)^T M (x - x_tilde - h^2 g)
           + h^2 sum_e vol_e psi(F_e(x)),     x_tilde = x_n + h v_n,

with M the consistent mass matrix of linear tets (rho vol (1 + delta_kl) /
20 per corner pair), F_e = Ds(x) Dm^-1 and the stable neo-Hookean density
of the stretch S of F = R S:

    psi = mu (1 - det S) + la/2 (1 - det S)^2 + mu/2 (|S|_F^2 - 3),

which is a function of F alone (det S = det F, |S| = |F|). The mixed
method solves the same step for (x, s, lambda): at its solution s = S(F(x))
and the gradient of E over the free vertices is 0. A scripted twist BC
rotates the two end slabs about the x axis through the box's centre by
+-velocity pi h per step, after the solve.

Everything here runs in the dtype and on the device it is given; the
comparison runs it in float64. `newton_step` is the reference put in the
program's place (the control runs it in bfloat16)."""

from __future__ import annotations

import math

import numpy as np
import torch


def lame(youngs: float, poisson: float) -> tuple[float, float]:
    """(mu, lambda) of Young's modulus and Poisson's ratio."""
    mu = youngs / (2.0 * (1.0 + poisson))
    la = youngs * poisson / ((1.0 + poisson) * (1.0 - 2.0 * poisson))
    return mu, la


def end_slabs(V0: np.ndarray, ratio: float, axis: int):
    """Masks of the two end slabs, each `ratio` of the bounding box's
    length along `axis`."""
    lo, hi = V0.min(axis=0), V0.max(axis=0)
    span = hi[axis] - lo[axis]
    return (V0[:, axis] < lo[axis] + ratio * span,
            V0[:, axis] > hi[axis] - ratio * span)


def det3(A: torch.Tensor) -> torch.Tensor:
    """Determinants of (..., 3, 3) matrices by cofactors (works in every
    floating dtype, bfloat16 included)."""
    return (A[..., 0, 0] * (A[..., 1, 1] * A[..., 2, 2] - A[..., 1, 2] * A[..., 2, 1])
            - A[..., 0, 1] * (A[..., 1, 0] * A[..., 2, 2] - A[..., 1, 2] * A[..., 2, 0])
            + A[..., 0, 2] * (A[..., 1, 0] * A[..., 2, 1] - A[..., 1, 1] * A[..., 2, 0]))


def sym_pack(S: torch.Tensor) -> torch.Tensor:
    """(E, 3, 3) symmetric -> (E, 6) as [S00, S11, S22, S01, S02, S12]."""
    return torch.stack([S[:, 0, 0], S[:, 1, 1], S[:, 2, 2],
                        S[:, 0, 1], S[:, 0, 2], S[:, 1, 2]], dim=1)


def sym_unpack(s: torch.Tensor) -> torch.Tensor:
    """(E, 6) packed -> (E, 3, 3) symmetric."""
    a, b, c, d, e, f = s.unbind(1)
    return torch.stack([torch.stack([a, d, e], 1), torch.stack([d, b, f], 1),
                        torch.stack([e, f, c], 1)], 1)


def polar_svd(F: torch.Tensor):
    """F = U diag(sig) Vh with U Vh a rotation (the smallest singular
    value's sign flipped where det F < 0): R = U Vh, S = Vh^T diag(sig) Vh."""
    U, sig, Vh = torch.linalg.svd(F)
    flip = (det3(U) * det3(Vh)) < 0
    sig = torch.where(flip[:, None], sig * sig.new_tensor([1, 1, -1]), sig)
    U = torch.where(flip[:, None, None], U * U.new_tensor([1, 1, -1]), U)
    return U, sig, Vh


def polar_stretch(F: torch.Tensor) -> torch.Tensor:
    """The stretch S of every F = R S (R a rotation), packed."""
    _, sig, Vh = polar_svd(F)
    return sym_pack(Vh.transpose(1, 2) @ (sig[:, :, None] * Vh))


def cofactor(A: torch.Tensor) -> torch.Tensor:
    """d det(A) / dA of (..., 3, 3) matrices."""
    r = [[(1, 2), (2, 0), (0, 1)][i] for i in range(3)]
    rows = []
    for i in range(3):
        i1, i2 = r[i]
        rows.append(torch.stack([
            A[..., i1, r[j][0]] * A[..., i2, r[j][1]]
            - A[..., i1, r[j][1]] * A[..., i2, r[j][0]] for j in range(3)], -1))
    return torch.stack(rows, -2)


# weights that make the packed 6-vector's squared norm the Frobenius one
SYM_WEIGHTS = (1.0, 1.0, 1.0, 2.0, 2.0, 2.0)


class Body:
    """A tet solid with one stable neo-Hookean material, gravity, a BDF1
    step of length h and pinned vertices, in `dtype` on `device`."""

    def __init__(self, V0, T, *, youngs, poisson, density, gravity, h,
                 pinned, dtype=torch.float64, device="cpu"):
        self.dtype, self.device = dtype, torch.device(device)
        V0 = np.asarray(V0, np.float64)
        T = np.asarray(T, np.int64)
        self.T = torch.tensor(T, device=self.device)
        self.V0 = torch.tensor(V0, dtype=dtype, device=self.device)
        self.nv, self.ne = len(V0), len(T)
        Dm = (V0[T[:, 1:]] - V0[T[:, :1]]).transpose(0, 2, 1)  # columns
        vol = np.linalg.det(Dm) / 6.0
        if not (vol > 0).all():
            raise ValueError("the rest mesh has tets of non-positive volume")
        self.Dm_inv = torch.tensor(np.linalg.inv(Dm), dtype=dtype,
                                   device=self.device)
        self.vol = torch.tensor(vol, dtype=dtype, device=self.device)
        mass = density * vol / 20.0
        self.mass_e = torch.tensor(
            mass[:, None, None] * (1.0 + np.eye(4))[None], dtype=dtype,
            device=self.device)
        self.mu, self.la = lame(youngs, poisson)
        self.g = torch.tensor(gravity, dtype=dtype, device=self.device)
        self.h = h
        self.free = torch.tensor(~np.asarray(pinned, bool), dtype=dtype,
                                 device=self.device)[:, None]

    def tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(a, device=self.device).to(self.dtype)

    def def_grad(self, x: torch.Tensor) -> torch.Tensor:
        xe = x[self.T]
        Ds = (xe[:, 1:] - xe[:, :1]).transpose(1, 2)
        return Ds @ self.Dm_inv

    def psi(self, F: torch.Tensor) -> torch.Tensor:
        J = det3(F)
        return (self.mu * (1.0 - J) + 0.5 * self.la * (1.0 - J) ** 2
                + 0.5 * self.mu * ((F * F).sum(dim=(1, 2)) - 3.0))

    def dpsi_dS(self, S: torch.Tensor) -> torch.Tensor:
        """The density's gradient in the stretch, (E, 3, 3) of symmetric
        (E, 3, 3): -mu cof S - la (1 - det S) cof S + mu S."""
        J, C = det3(S), cofactor(S)
        return (-self.mu - self.la * (1.0 - J))[:, None, None] * C + self.mu * S

    def energy(self, x: torch.Tensor, x_tilde: torch.Tensor) -> torch.Tensor:
        """The incremental potential E(x) of the step whose inertia target
        is x_tilde."""
        de = (x - x_tilde - self.h ** 2 * self.g)[self.T]  # (E, 4, 3)
        inertia = 0.5 * torch.einsum("ekd,ekl,eld->", de, self.mass_e, de)
        return inertia + self.h ** 2 * torch.sum(self.vol * self.psi(
            self.def_grad(x)))

    def gradient(self, x: torch.Tensor, x_tilde: torch.Tensor) -> torch.Tensor:
        """dE/dx on the free vertices (pinned rows 0)."""
        x = x.detach().requires_grad_(True)
        (g,) = torch.autograd.grad(self.energy(x, x_tilde), x)
        return g * self.free

    def mixed_gradient(self, x: torch.Tensor, s: torch.Tensor,
                       x_tilde: torch.Tensor) -> torch.Tensor:
        """The x-row of the mixed system at (x, s), the multipliers at their
        stationary value h^2 dpsi/dS(s): M (x - x_tilde - h^2 g) + h^2 sum_e
        vol_e d(Lambda_e : S(F_e(x)))/dx, free vertices. With Y solving
        Y S + S Y = Lambda (S = S(F)), d(Lambda : S)/dF = 2 F Y. It equals
        `gradient` where s = S(F(x))."""
        F = self.def_grad(x)
        U, sig, Vh = polar_svd(F)
        Lam = Vh @ self.dpsi_dS(sym_unpack(s)) @ Vh.transpose(1, 2)
        Y = Lam / (sig[:, :, None] + sig[:, None, :])
        P = 2.0 * U @ (sig[:, :, None] * Y) @ Vh  # 2 F Y
        xg = x.detach().requires_grad_(True)
        de = (xg - x_tilde - self.h ** 2 * self.g)[self.T]
        e = 0.5 * torch.einsum("ekd,ekl,eld->", de, self.mass_e, de) \
            + self.h ** 2 * torch.sum(self.vol[:, None, None] * P.detach()
                                      * self.def_grad(xg))
        (g,) = torch.autograd.grad(e, xg)
        return g * self.free

    def stretch(self, x: torch.Tensor) -> torch.Tensor:
        """The polar stretch of every element's F, packed."""
        return polar_stretch(self.def_grad(x))

    def newton_step(self, x_n, v_n, iters: int = 5, cg_iters: int = 200,
                    cg_tol: float = 1e-8):
        """The step by Newton's method on E: truncated CG on the Hessian's
        products (stopped at negative curvature), then a backtracking line
        search. Returns the solution's positions (pinned rows unchanged)."""
        x_tilde = x_n + self.h * v_n
        x = x_n.clone()
        for _ in range(iters):
            xg = x.detach().requires_grad_(True)
            (g,) = torch.autograd.grad(self.energy(xg, x_tilde), xg,
                                       create_graph=True)
            g = g * self.free

            def hvp(p):
                (Hp,) = torch.autograd.grad(g, xg, p, retain_graph=True)
                return Hp * self.free

            b = -g.detach()
            dx = torch.zeros_like(b)
            r, p = b.clone(), b.clone()
            rr = (r * r).sum()
            rr0 = rr
            for _k in range(cg_iters):
                Ap = hvp(p)
                pAp = (p * Ap).sum()
                if not pAp > 0:
                    if _k == 0:
                        dx = b
                    break
                a = rr / pAp
                dx = dx + a * p
                r = r - a * Ap
                rr_new = (r * r).sum()
                if not rr_new > cg_tol ** 2 * rr0:
                    break
                p = r + (rr_new / rr) * p
                rr = rr_new
            with torch.no_grad():
                e0 = self.energy(x, x_tilde)
                alpha = 1.0
                for _ls in range(20):
                    if self.energy(x + alpha * dx, x_tilde) < e0:
                        break
                    alpha *= 0.5
                else:
                    alpha = 0.0
                x = x + alpha * dx
        return x.detach()


def twist_positions(V0: torch.Tensor, groups, step: int, h: float,
                    velocity: float) -> torch.Tensor:
    """Positions of every vertex after `step` twist increments: group 0
    turned by +step velocity pi h about the x axis through the bounding
    box's centre, group 1 by the opposite angle; other rows are V0's."""
    center = 0.5 * (V0.min(dim=0).values + V0.max(dim=0).values)
    out = V0.clone()
    for mask, sign in zip(groups, (1.0, -1.0)):
        a = sign * step * velocity * math.pi * h
        c, s = math.cos(a), math.sin(a)
        P = V0[mask] - center
        out[mask] = torch.stack([P[:, 0], c * P[:, 1] - s * P[:, 2],
                                 s * P[:, 1] + c * P[:, 2]], dim=1) + center
    return out
