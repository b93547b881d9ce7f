"""Per-element small-tensor contractions (port of mixedfem_tpu/ops/smallops.py).

The JAX package unrolls these into (E,) columns and re-interleaves them with
a Pallas lane transpose (ops/smallops.py:_tr_kernel), a TPU layout device.
Here the plain forms are einsums, and the pair that the coefficient build
needs, G = D : dphi and Gw = sqrt(vol) Hs G, is one fused per-element pass:
``contract_G_Gw``, kernel K3 (csrc/kernels.cu:contract_G_Gw_kernel) on a
CUDA tensor. Where G is given (shells and rods, whose G comes from a
Jacobian), ``contract_Gw`` forms Gw alone: kernel K7
(csrc/kernels.cu:contract_Gw_kernel) on a CUDA tensor.
"""

from __future__ import annotations

import torch

from mixedfem_tpu_torch import cuda


def contract_D_dphi(D: torch.Tensor, dphi: torch.Tensor) -> torch.Tensor:
    """G[e,i,k,r] = sum_c D[e,i,r,c] dphi[e,k,c]: (E,N,d,d), (E,k,d) -> (E,N,k,d)."""
    return torch.einsum("eirc,ekc->eikr", D, dphi)


def contract_sym_G(Hs: torch.Tensor, G: torch.Tensor) -> torch.Tensor:
    """Y[e,i,k,r] = sum_j Hs[e,i,j] G[e,j,k,r]: (E,N,N), (E,N,k,d) -> (E,N,k,d)."""
    return torch.einsum("eij,ejkr->eikr", Hs, G)


def contract_G_Gw_plain(D, dphi, Hs, vols):
    """Plain PyTorch version of K3: (G, sqrt(vol) Hs G)."""
    G = contract_D_dphi(D, dphi)
    return G, torch.sqrt(vols)[:, None, None, None] * contract_sym_G(Hs, G)


def contract_G_Gw(D, dphi, Hs, vols):
    """G = D : dphi and Gw = sqrt(vol) Hs G, both (E, N, k, d), from ds/dF
    D (E, N, d, d), dphi (E, k, d), Hs (E, N, N) and vol (E,): tets (N=6,
    k=4, d=3) or triangles (N=3, k=3, d=2).

    On a CUDA tensor this launches kernel K3 (its instance for the shape);
    on a CPU tensor it runs contract_G_Gw_plain."""
    if D.device.type == "cpu":
        return contract_G_Gw_plain(D, dphi, Hs, vols)
    return cuda.contract_G_Gw(
        D.contiguous(), dphi.contiguous(), Hs.contiguous(), vols.contiguous()
    )


def contract_Gw_plain(Hs, G, vols):
    """Plain PyTorch version of K7: sqrt(vol) Hs G."""
    return torch.sqrt(vols)[:, None, None, None] * contract_sym_G(Hs, G)


def contract_Gw(Hs, G, vols):
    """Gw = sqrt(vol) Hs G, (E, N, k, d), from Hs (E, N, N), a given G (E,
    N, k, d) and vol (E,): shells and rods on the card (cuda.SHAPES).

    On a CUDA tensor this launches kernel K7 (its instance for the shape);
    on a CPU tensor it runs contract_Gw_plain."""
    if G.device.type == "cpu":
        return contract_Gw_plain(Hs, G, vols)
    return cuda.contract_Gw(Hs.contiguous(), G.contiguous(), vols.contiguous())


def sym_reconstruct(V: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """V diag(w) V^T for (..., n, n) eigenvectors and (..., n) eigenvalues."""
    return torch.einsum("...ik,...k,...jk->...ij", V, w, V)
