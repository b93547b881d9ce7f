"""PSD projection of per-element Hessians (port of mixedfem_tpu/ops/psd.py):
fixed-sweep Jacobi eigendecomposition, eigenvalues clamped to >= tol."""

from __future__ import annotations

import torch

from mixedfem_tpu_torch.ops.rotation import jacobi_eigh
from mixedfem_tpu_torch.ops.smallops import sym_reconstruct


def _default_sweeps(dtype) -> int:
    """5 sweeps reach ~1e-6 relative on 6x6 blocks, enough for f32; f64
    needs 8 (quadratic Jacobi convergence)."""
    return 8 if dtype == torch.float64 else 5


def psd_fix_sqrt(H: torch.Tensor, tol: float = 1e-8, sweeps: int | None = None):
    """Project (..., n, n) symmetric blocks to PSD by eigenvalue clamping.

    Returns (H_fixed, H_inv, H_sqrt, max_eval): V w V^T, V w^-1 V^T and
    V w^1/2 V^T with w = max(eig, tol), and the largest clamped eigenvalue."""
    H = 0.5 * (H + H.transpose(-1, -2))
    w, V = jacobi_eigh(H, sweeps=sweeps or _default_sweeps(H.dtype))
    w = torch.clamp(w, min=tol)
    Hf = sym_reconstruct(V, w)
    Hi = sym_reconstruct(V, 1.0 / w)
    Hs = sym_reconstruct(V, torch.sqrt(w))
    return Hf, Hi, Hs, w.amax(dim=-1)


def psd_project(H: torch.Tensor, tol: float = 1e-8, sweeps: int | None = None):
    """V max(w, tol) V^T of (..., n, n) symmetric blocks (the H_fixed of
    the JAX package's psd_fix)."""
    H = 0.5 * (H + H.transpose(-1, -2))
    w, V = jacobi_eigh(H, sweeps=sweeps or _default_sweeps(H.dtype))
    return sym_reconstruct(V, torch.clamp(w, min=tol))
