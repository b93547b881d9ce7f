"""Multicolor block Gauss-Seidel on the condensed system (port of
mixedfem_tpu/solvers/gauss_seidel.py, the subspace-gauss_seidel path).

Vertices are colored greedily on the host so that no two vertices of one
element share a color; a sweep updates each color in turn with the
per-vertex (d, d) diagonal blocks,

    x_c <- x_c + D_c^{-1} (b - A x)_c ,

an exact block-GS step per color. Every color update is one product of the
condensed operator (K1 with K2 or K4 on the card). The solver tests
||A x - b|| <= tol ||b|| on the host once per sweep.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from mixedfem_tpu_torch.device import resolve_device


@dataclasses.dataclass
class GSPlan:
    """Vertex coloring: masks (C, nv), masks[c, v] = 1 when v has color c."""

    masks: torch.Tensor
    ncolors: int


def greedy_colors(T: np.ndarray, nv: int) -> np.ndarray:
    """The JAX package's greedy coloring of the element-sharing graph:
    vertices in id order, each given the least color none of its
    neighbours has yet. (nv,) int64."""
    T = np.asarray(T, np.int64)
    k = T.shape[1]
    a = np.concatenate([T[:, i] for i in range(k) for j in range(k) if i != j])
    b = np.concatenate([T[:, j] for i in range(k) for j in range(k) if i != j])
    pairs = np.unique(a * nv + b)
    src, nbr = pairs // nv, pairs % nv
    ptr = np.searchsorted(src, np.arange(nv + 1))
    colors = np.full(nv, -1, np.int64)
    nbr_list = nbr.tolist()
    for v in range(nv):
        used = {colors[u] for u in nbr_list[ptr[v]:ptr[v + 1]]}
        c = 0
        while c in used:
            c += 1
        colors[v] = c
    return colors


def build_gs_plan(T, nv: int, dtype=torch.float64, device="cuda") -> GSPlan:
    """GSPlan of the greedy coloring of elements T over nv vertices."""
    colors = greedy_colors(T, nv)
    ncolors = int(colors.max()) + 1 if nv else 0
    masks = np.zeros((ncolors, nv), np.float64)
    masks[colors, np.arange(nv)] = 1.0
    return GSPlan(masks=torch.tensor(masks, dtype=dtype,
                                     device=resolve_device(device)),
                  ncolors=ncolors)


def _sweep(A, Binv, plan: GSPlan, b, x, order):
    for c in order:
        x = x + plan.masks[c][:, None] * Binv(b - A(x))
    return x


def gs_apply(A, Binv, plan: GSPlan, sweeps: int = 1, symmetric: bool = True):
    """Preconditioner apply z ~= A^{-1} r: `sweeps` multicolor sweeps from
    zero, each forward and (symmetric) back through the colors."""
    fwd = tuple(range(plan.ncolors))
    orders = fwd + tuple(reversed(fwd)) if symmetric else fwd

    def apply(r):
        x = torch.zeros_like(r)
        for _ in range(sweeps):
            x = _sweep(A, Binv, plan, r, x, orders)
        return x

    return apply


def gs_solve(A, b, x0, Binv, plan: GSPlan, max_iters: int, tol: float):
    """Gauss-Seidel as the linear solver: sweep until ||A x - b|| <= tol ||b||
    or max_iters sweeps. Returns (x, sweeps, rel_error)."""
    bnorm = torch.linalg.vector_norm(b)
    safe_b = torch.where(bnorm > 0, bnorm, torch.ones_like(bnorm))
    order = tuple(range(plan.ncolors))
    x = x0
    err = torch.linalg.vector_norm(A(x0) - b) / safe_b
    it = 0
    while it < max_iters and bool(err > tol):
        x = _sweep(A, Binv, plan, b, x, order)
        err = torch.linalg.vector_norm(A(x) - b) / safe_b
        it += 1
    return x, it, err
