"""The condensed-system CG matvec (port of
mixedfem_tpu/solvers/operator.py: element_matvec, sort_elements_banded and
the banded matvec, BandedPlan / build_banded_plan / banded_matvec).

y = P (sum_e scatter(M_e (x) I + Gw_e^T Gw_e) P^T p_e): kernel K1
(``element_apply``, csrc/kernels.cu:element_apply_kernel) computes the
per-corner rows of every element, and a fixed-order sum adds them per
vertex: kernel K2 (ops/assembly.py ``segment_sum``) over the mesh's
incidence plan in ``element_matvec``, which computes what
mixedfem_tpu/ops/brick.py:_matvec_kernel computes on the TPU; kernel K4
(ops/banded_scatter.py ``scatter_add_sorted``) over a banded plan in
``banded_matvec``, the matvec of every loaded scene on the card. With the
vanilla stretch variable its rows J^T H J p join K1's rows (or, without
the mixed variable, the mass rows) before the one sum.
"""

from __future__ import annotations

import numpy as np
import torch

from mixedfem_tpu_torch import cuda
from mixedfem_tpu_torch.mesh import mesh as meshmod
from mixedfem_tpu_torch.ops import assembly
from mixedfem_tpu_torch.ops import banded_scatter as bs
from mixedfem_tpu_torch.variables.mixed_stretch import StretchCoeffs


def sort_elements_banded(T: np.ndarray) -> np.ndarray:
    """Element permutation sorting by min vertex id (apply to every
    per-element array before build_mesh_data)."""
    return np.argsort(np.asarray(T).min(axis=1), kind="stable")


def element_apply_plain(T, Gw, mass, free_mask, p):
    """Plain PyTorch version of K1: per-corner rows (E, k, d)."""
    pe = (p * free_mask[:, None])[T]
    q = torch.einsum("eikr,ekr->ei", Gw, pe)
    return torch.einsum("eikr,ei->ekr", Gw, q) + torch.einsum(
        "ekl,eld->ekd", mass, pe
    )


def element_apply(mesh: meshmod.MeshData, Gw: torch.Tensor, p: torch.Tensor,
                  mass: torch.Tensor | None = None):
    """Per-corner rows (E, k, d) of the element blocks (mass (E, k, k),
    the mesh's consistent mass unless given, and Gw^T Gw) applied to the
    projected p. On a CUDA tensor this launches kernel K1 (its instance for
    tets or triangles); on a CPU tensor it runs element_apply_plain."""
    args = (mesh.T, Gw, mesh.mass_coeff if mass is None else mass,
            mesh.free_mask, p)
    if p.device.type == "cpu":
        return element_apply_plain(*args)
    return cuda.element_apply(*(a.contiguous() for a in args))


def vanilla_rows(mesh: meshmod.MeshData, H: torch.Tensor, pe: torch.Tensor):
    """Per-corner rows (E, k, d) of the vanilla stretch's elastic Hessian
    J^T H J (H (E, d*d, d*d) in row-major F order) applied to the element
    gathers pe (E, k, d) of a projected vector."""
    d = mesh.dim
    dF = torch.einsum("ekr,ekc->erc", pe, mesh.dphidX)
    y = torch.einsum("eab,eb->ea", H,
                     dF.reshape(dF.shape[0], d * d)).reshape(dF.shape)
    return torch.einsum("ekc,erc->ekr", mesh.dphidX, y)


def element_rows(mesh: meshmod.MeshData, p: torch.Tensor,
                 ms_coeffs: StretchCoeffs | None, v_coeffs=None):
    """Per-corner rows (E, k, d) of the condensed operator's element
    blocks applied to the projected p: K1's rows (mass and Gw^T Gw) with
    the mixed variable, the mass rows as torch ops without it, plus the
    vanilla stretch's rows when `v_coeffs` (variables/stretch.py
    VanillaCoeffs) is given."""
    if ms_coeffs is not None:
        rows = element_apply(mesh, ms_coeffs.Gw, p)
        if v_coeffs is None:
            return rows
        pe = meshmod.project_free(mesh, p)[mesh.T]
    else:
        pe = meshmod.project_free(mesh, p)[mesh.T]
        rows = torch.einsum("ekl,eld->ekd", mesh.mass_coeff, pe)
    if v_coeffs is not None:
        rows = rows + vanilla_rows(mesh, v_coeffs.H, pe)
    return rows


def element_matvec(
    mesh: meshmod.MeshData, p: torch.Tensor,
    ms_coeffs: StretchCoeffs | None, v_coeffs=None,
) -> torch.Tensor:
    """(P M P^T + P A_stretch P^T [+ P K_vanilla P^T]) p, the fused
    condensed operator, summed over the mesh's incidence plan."""
    out = assembly.segment_sum(
        mesh.plan, element_rows(mesh, p, ms_coeffs, v_coeffs))
    return meshmod.project_free(mesh, out)


def assemble(mesh: meshmod.MeshData, plan, contrib: torch.Tensor) -> torch.Tensor:
    """(E, k, ...) corner contributions -> (nv, ...), in a fixed order: over
    the banded plan (K4 on the card) when `plan` is a BandedPlan, else over
    the mesh's incidence plan (K2)."""
    if not isinstance(plan, bs.ScatterPlan):
        return assembly.segment_sum(mesh.plan, contrib)
    trail = tuple(contrib.shape[2:])
    rows = bs.pad_rows(plan, contrib.reshape(mesh.T.numel(), -1))
    return bs.scatter_add_sorted(plan, rows).reshape((mesh.nv,) + trail)


# The banded plan of the element table: the scatter plan of the rows
# (E*k, .) in element order (elements sorted by min vertex id keep its
# windows narrow; any order is summed correctly).
BandedPlan = bs.ScatterPlan


def build_banded_plan(mesh: meshmod.MeshData, chunk: int = 2048) -> BandedPlan:
    """Banded plan of the mesh's corner rows, on the mesh's device."""
    T = mesh.T.cpu().numpy()
    return bs.build_banded_scatter_plan(T.reshape(-1), mesh.nv, chunk=chunk,
                                        device=mesh.device)


def banded_matvec(
    mesh: meshmod.MeshData, plan: BandedPlan, p: torch.Tensor,
    ms_coeffs: StretchCoeffs | None, v_coeffs=None,
) -> torch.Tensor:
    """element_matvec with the vertex sum over the banded plan: the element
    rows in element order, zero-padded to the plan's Rp, summed by K4."""
    rows = element_rows(mesh, p, ms_coeffs, v_coeffs).reshape(-1, mesh.dim)
    out = bs.scatter_add_sorted(plan, bs.pad_rows(plan, rows))
    return meshmod.project_free(mesh, out)
