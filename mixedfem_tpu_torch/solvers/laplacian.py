"""Rest-state elasticity-Laplacian preconditioner (M + k L)^{-1} and the
dual-ascent contact preconditioner built on it (port of
mixedfem_tpu/solvers/laplacian.py: eigen-pcg-laplacian and
eigen-pcg-dualascent).

L = sum_e GwL^T GwL is the mixed-stretch jacobian at the rest state
(R = S = I) weighted by sqrt(vol), scaled by k = h^2 * the largest clamped
stretch eigenvalue at each Newton iteration. The apply is a fixed-degree
Chebyshev polynomial in (M + kL) on a spectral interval whose upper end
comes from power iterations for M and L separately, a linear SPD operator.

(M + kL) p is the condensed operator's shape: kernel K1 with
Gw = sqrt(k) GwL and the consistent mass (a zero mass block isolates L),
then the vertex sum over the mesh's incidence plan (K2) or, when a banded
plan is given, over it (K4). The dual-ascent loop's frame sums go through
the frame plan (K2). The power iteration's start vector is an argument:
the JAX package draws it from its own generator, so a caller that wants
its estimates passes its vector; default_power_start draws the port's.
"""

from __future__ import annotations

import torch

from mixedfem_tpu_torch.mesh import mesh as meshmod
from mixedfem_tpu_torch.ops import rotation, smallops
from mixedfem_tpu_torch.solvers import dual
from mixedfem_tpu_torch.solvers import operator as opmod


def laplacian_rows(mesh: meshmod.MeshData) -> torch.Tensor:
    """(E, N, k, d) factored rows GwL = sqrt(vol) G0 of L = sum_e GwL^T
    GwL, G0 = D(I) : dphi the mixed-stretch Jacobian at the rest state. K3
    with Hs = I forms exactly (G0, sqrt(vol) G0) (smallops.contract_G_Gw:
    one launch on the card); the second is kept. Solids only, as in the
    JAX package."""
    if mesh.shell or mesh.rod:
        raise NotImplementedError(
            "laplacian preconditioner: solids only (it is built from the "
            "solid mixed-stretch Jacobian)")
    E, d = mesh.T.shape[0], mesh.dim
    eye = torch.eye(d, dtype=mesh.vols.dtype, device=mesh.device).expand(E, d, d)
    D = rotation.dsdF(eye, eye, d)                     # (E, N, d, d)
    N = D.shape[1]
    I = torch.eye(N, dtype=D.dtype, device=D.device).expand(E, N, N)
    return smallops.contract_G_Gw(D, mesh.dphidX, I, mesh.vols)[1]


def ml_operator(mesh: meshmod.MeshData, GwL: torch.Tensor, k,
                mass_scale: float = 1.0, plan=None):
    """p -> (mass_scale M + k L) p on free dofs (mass_scale 0 or 1), with
    sqrt(k) GwL and the mass block formed once for every product."""
    Gw = torch.sqrt(torch.as_tensor(k, dtype=GwL.dtype, device=GwL.device)) * GwL
    mass = mesh.mass_coeff if mass_scale == 1.0 else mass_scale * mesh.mass_coeff

    def mv(p):
        rows = opmod.element_apply(mesh, Gw, p, mass)
        return meshmod.project_free(mesh, opmod.assemble(mesh, plan, rows))

    return mv


def ml_matvec(mesh: meshmod.MeshData, GwL: torch.Tensor, k, p: torch.Tensor,
              mass_scale: float = 1.0, plan=None):
    """(mass_scale M + k L) p on free dofs (mass_scale=0 isolates L)."""
    return ml_operator(mesh, GwL, k, mass_scale, plan)(p)


def default_power_start(shape, dtype, device) -> torch.Tensor:
    """The port's power-iteration start vector: standard normal from a
    torch.Generator seeded 0, drawn on the CPU in float64 so that every
    device starts from the same vector."""
    g = torch.Generator().manual_seed(0)
    v = torch.randn(tuple(shape), generator=g, dtype=torch.float64)
    return v.to(dtype=dtype, device=device)


def power_lmax(matvec, v0: torch.Tensor, iters: int = 20):
    """Largest-eigenvalue estimate by `iters` power iterations from v0,
    times a 1.05 safety factor (Chebyshev needs the spectrum inside its
    interval, and power iteration approaches from below)."""
    v = v0
    for _ in range(iters):
        w = matvec(v)
        v = w / torch.clamp(torch.linalg.vector_norm(w), min=1e-30)
    w = matvec(v)
    lam = torch.sum(v * w) / torch.clamp(torch.sum(v * v), min=1e-30)
    return 1.05 * lam


def chebyshev_apply(matvec, lmin, lmax, degree: int):
    """z ~= A^{-1} r as the degree-`degree` Chebyshev semi-iteration on
    [lmin, lmax], a fixed linear operator in r."""
    theta = 0.5 * (lmax + lmin)
    # guard near-degenerate intervals (tiny meshes where lmin ~ lmax)
    if torch.is_tensor(theta):
        delta = torch.maximum(0.5 * (lmax - lmin), 1e-6 * theta)
    else:
        delta = max(0.5 * (lmax - lmin), 1e-6 * theta)
    sigma = theta / delta

    def apply(r):
        d = r / theta
        z = d
        rho_prev = 1.0 / sigma
        for _ in range(degree - 1):
            rho = 1.0 / (2.0 * sigma - rho_prev)
            d = rho * rho_prev * d + (2.0 * rho / delta) * (r - matvec(z))
            z = z + d
            rho_prev = rho
        return z

    return apply


def build_ml_preconditioner(mesh: meshmod.MeshData, GwL: torch.Tensor, k,
                            lmax_m, lmax_l, degree: int = 16, plan=None):
    """(M + kL)^{-1} apply for the stress scale k: the interval's upper end
    is lmax(M) + k lmax(L), its lower end half the smallest free mass
    diagonal."""
    free = mesh.free_mask > 0
    lmin = 0.5 * torch.min(torch.where(free, mesh.mass_diag, torch.inf))
    lmax = lmax_m + k * lmax_l
    return chebyshev_apply(ml_operator(mesh, GwL, k, plan=plan), lmin, lmax,
                           degree)


def da_apply(ml_inv, mesh, cf, cc, iters: int = 10):
    """The dual-ascent preconditioner's loop, homogeneous form: `iters`
    alternations of an (M+kL)-solve for dx, a diagonal contact-Hessian
    solve for the mixed distances, and an ascent on the contact
    multipliers."""
    Hsafe = torch.where(cc.active > 0, cc.H, 1.0)

    def apply(r):
        dl = r.new_zeros((cf.nreal,))
        xz = torch.zeros_like(r)
        for _ in range(iters):
            xz = ml_inv(r - dual._Cct_apply(mesh, cf, cc, dl))
            dD = (dl / Hsafe) * cc.active
            dl = dl - (dual._Cc_apply(cf, cc, xz) - dD)
        return xz

    return apply
