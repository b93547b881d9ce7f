"""Matrix-free preconditioned conjugate gradient on the condensed SPD
system (port of mixedfem_tpu/solvers/pcg.py: pcg, pcg_tree, _small_inv,
block_jacobi_inv).

The JAX package tests convergence inside ``lax.while_loop``; ``pcg`` and
``pcg_tree`` test it on the host every iteration, with one ``.item()`` (one
device sync per iteration), so the iteration counts are the JAX package's.
``pcg_fixed`` runs a fixed number of iterations with the convergence test
on the device: an iteration whose residual already meets the tolerance
leaves x, r, z, p and rz as they are, which is what the JAX loop returns,
and no value is read back to the host.
"""

from __future__ import annotations

from typing import Callable

import torch


def dot(a, b):
    """The dot product of two tensors (sum of the elementwise products)."""
    return torch.sum(a * b)


def pcg(
    A: Callable[[torch.Tensor], torch.Tensor],
    b: torch.Tensor,
    x0: torch.Tensor,
    Minv: Callable[[torch.Tensor], torch.Tensor],
    max_iters: int,
    tol: float,
    dot=dot,
):
    """Solve A x = b. Returns (x, iters, rel_residual); convergence when
    ||r||_2 <= tol ||b||_2. `dot` is the vectors' dot product (over the
    ranks for a vector sliced over them, solvers/dual.py)."""
    bnorm2 = dot(b, b)
    safe_b = torch.where(bnorm2 > 0, bnorm2, torch.ones_like(bnorm2))
    tol2 = (tol * tol) * safe_b

    x = x0
    r = b - A(x0)
    z = Minv(r)
    p = z
    rz = dot(r, z)
    it = 0
    while it < max_iters and bool(dot(r, r) > tol2):
        Ap = A(p)
        denom = dot(p, Ap)
        alpha = rz / torch.where(denom != 0, denom, torch.ones_like(denom))
        x = x + alpha * p
        r = r - alpha * Ap
        z = Minv(r)
        rz_new = dot(r, z)
        beta = rz_new / torch.where(rz != 0, rz, torch.ones_like(rz))
        p = z + beta * p
        rz = rz_new
        it += 1
    rel = torch.sqrt(dot(r, r) / safe_b)
    return x, it, rel


def pcg_fixed(
    A: Callable[[torch.Tensor], torch.Tensor],
    b: torch.Tensor,
    x0: torch.Tensor,
    Minv: Callable[[torch.Tensor], torch.Tensor],
    iters: int,
    tol: float,
) -> torch.Tensor:
    """pcg's x after at most `iters` iterations, with no host read: each of
    the `iters` iterations runs, and those that start from a residual with
    ||r||_2 <= tol ||b||_2 change nothing (a converged mask on the
    device)."""
    bnorm2 = dot(b, b)
    safe_b = torch.where(bnorm2 > 0, bnorm2, torch.ones_like(bnorm2))
    tol2 = (tol * tol) * safe_b

    x = x0
    r = b - A(x0)
    z = Minv(r)
    p = z
    rz = dot(r, z)
    for _ in range(iters):
        run = dot(r, r) > tol2
        Ap = A(p)
        denom = dot(p, Ap)
        alpha = rz / torch.where(denom != 0, denom, torch.ones_like(denom))
        x = torch.where(run, x + alpha * p, x)
        r_new = r - alpha * Ap
        z_new = Minv(r_new)
        rz_new = dot(r_new, z_new)
        beta = rz_new / torch.where(rz != 0, rz, torch.ones_like(rz))
        p = torch.where(run, z_new + beta * p, p)
        r = torch.where(run, r_new, r)
        rz = torch.where(run, rz_new, rz)
    return x


def tdot(u, v):
    """The dot product of two tuples of tensors (stacked vectors)."""
    return sum(torch.sum(a * b) for a, b in zip(u, v))


def taxpy(alpha, u, v):
    """alpha u + v over tuples of tensors."""
    return tuple(alpha * a + b for a, b in zip(u, v))


def pcg_tree(A: Callable, b, x0, Minv: Callable, max_iters: int, tol: float,
             dot=tdot):
    """pcg on tuples of tensors (the coupled dual Schur system with
    contact, solvers/dual.py): ||r||_2 <= tol ||b||_2 over the stacked
    vector. Returns (x, iters, rel_residual). `dot` is the tuples' dot
    product."""
    bnorm2 = dot(b, b)
    safe_b = torch.where(bnorm2 > 0, bnorm2, torch.ones_like(bnorm2))
    tol2 = (tol * tol) * safe_b

    x = tuple(x0)
    r = taxpy(-1.0, A(x), b)
    z = Minv(r)
    p = z
    rz = dot(r, z)
    it = 0
    while it < max_iters and bool(dot(r, r) > tol2):
        Ap = A(p)
        denom = dot(p, Ap)
        alpha = rz / torch.where(denom != 0, denom, torch.ones_like(denom))
        x = taxpy(alpha, p, x)
        r = taxpy(-alpha, Ap, r)
        z = Minv(r)
        rz_new = dot(r, z)
        beta = rz_new / torch.where(rz != 0, rz, torch.ones_like(rz))
        p = taxpy(beta, p, z)
        rz = rz_new
        it += 1
    rel = torch.sqrt(dot(r, r) / safe_b)
    return x, it, rel


def _small_inv(blocks: torch.Tensor) -> torch.Tensor:
    """Closed-form (adjugate) batched inverse of (n, d, d) blocks, d 2 or
    3."""
    if blocks.shape[-1] == 2:
        a, b = blocks[..., 0, 0], blocks[..., 0, 1]
        c, e = blocks[..., 1, 0], blocks[..., 1, 1]
        det = a * e - b * c
        inv = torch.stack(
            [torch.stack([e, -b], -1), torch.stack([-c, a], -1)], -2
        )
        return inv / det[..., None, None]
    m = blocks
    c00 = m[..., 1, 1] * m[..., 2, 2] - m[..., 1, 2] * m[..., 2, 1]
    c01 = m[..., 1, 2] * m[..., 2, 0] - m[..., 1, 0] * m[..., 2, 2]
    c02 = m[..., 1, 0] * m[..., 2, 1] - m[..., 1, 1] * m[..., 2, 0]
    c10 = m[..., 0, 2] * m[..., 2, 1] - m[..., 0, 1] * m[..., 2, 2]
    c11 = m[..., 0, 0] * m[..., 2, 2] - m[..., 0, 2] * m[..., 2, 0]
    c12 = m[..., 0, 1] * m[..., 2, 0] - m[..., 0, 0] * m[..., 2, 1]
    c20 = m[..., 0, 1] * m[..., 1, 2] - m[..., 0, 2] * m[..., 1, 1]
    c21 = m[..., 0, 2] * m[..., 1, 0] - m[..., 0, 0] * m[..., 1, 2]
    c22 = m[..., 0, 0] * m[..., 1, 1] - m[..., 0, 1] * m[..., 1, 0]
    det = m[..., 0, 0] * c00 + m[..., 0, 1] * c01 + m[..., 0, 2] * c02
    adjT = torch.stack(
        [
            torch.stack([c00, c10, c20], -1),
            torch.stack([c01, c11, c21], -1),
            torch.stack([c02, c12, c22], -1),
        ],
        -2,
    )
    return adjT / det[..., None, None]


def block_jacobi_inv(diag_blocks: torch.Tensor, free_mask: torch.Tensor):
    """Block-Jacobi preconditioner application from per-vertex (d, d)
    diagonal blocks; pinned vertices get the identity."""
    eye = torch.eye(diag_blocks.shape[-1], dtype=diag_blocks.dtype,
                    device=diag_blocks.device)
    mask = free_mask[:, None, None]
    inv = _small_inv(diag_blocks * mask + eye * (1.0 - mask))
    fm = free_mask[:, None]

    def apply(r):
        return torch.einsum("nij,nj->ni", inv, r) * fm

    return apply
