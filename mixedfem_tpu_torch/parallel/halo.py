"""The vertex-partitioned halo-exchange matvec (port of
mixedfem_tpu/parallel/halo.py).

Layout (host, static): vertices in banded order (parallel/reorder.py makes
an arbitrary mesh banded), split into D contiguous blocks of nb rows;
each element belongs to the rank of its least vertex. A banded mesh keeps
every element's vertices inside [start - Bd, start + nb + Bd) of its
rank's block for a halo depth Bd, so the halo is the left neighbour's tail
and the right neighbour's head, exchanged with two ring shifts.

Per rank, the condensed matvec is then local: the halo in, K1 over the
rank's elements, K2 over a rank-local incidence plan of nb + 2 Bd rows,
and the halo contributions sent back and added (parallel/comm.py's shift).
The host plan (HaloPlan) is stacked over ranks as the JAX package's is and
equals it bit for bit; rank_halo takes one rank's share to its device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from mixedfem_tpu_torch import cuda
from mixedfem_tpu_torch.ops import assembly
from mixedfem_tpu_torch.solvers import operator as opmod


@dataclasses.dataclass
class HaloPlan:
    """Static partition data, host numpy, stacked per rank on axis 0."""

    T_local: np.ndarray   # (D, Ep, k) int32 into [halo_L | own | halo_R]
    emask: np.ndarray     # (D, Ep) 1.0 for real elements
    eidx: np.ndarray      # (D, Ep) int32 global element id (0 for padding)
    nb: int               # vertices per rank (padded)
    Bd: int               # halo depth (rows exchanged with each neighbour)
    nv_pad: int           # D * nb
    D: int


def partition(T: np.ndarray, nv: int, n_shards: int, what: str):
    """(nb, nv_pad, owner, Bd) of the banded partition of T over n_shards
    blocks: the owner rank of each element (its least vertex's block) and
    the halo depth, padded to a multiple of 8. Raises ValueError when the
    depth exceeds the block (the mesh is not banded enough); `what` ends
    the message."""
    T = np.asarray(T)
    nb = -(-nv // n_shards)
    owner = T.min(axis=1) // nb
    starts = owner * nb
    lo = (T - starts[:, None]).min()
    hi = (T - starts[:, None]).max()
    Bd = int(max(-lo, hi - nb + 1, 0))
    Bd = -(-Bd // 8) * 8
    if Bd > nb:
        raise ValueError(f"halo depth {Bd} exceeds block size {nb}: reorder "
                         f"the mesh {what}")
    return nb, nb * n_shards, owner, Bd


def build_halo_plan(mesh, n_shards: int) -> HaloPlan:
    """Partition a banded-ordered mesh (the port's MeshData) for n_shards
    ranks; raises if the element span exceeds the halo capacity."""
    T = mesh.T.cpu().numpy()
    E, k = T.shape
    nb, nv_pad, owner, Bd = partition(
        T, mesh.nv, n_shards,
        "(bandwidth too large for this shard count)")
    Ep = -(-int(np.bincount(owner, minlength=n_shards).max()) // 8) * 8
    T_local = np.zeros((n_shards, Ep, k), np.int32)
    emask = np.zeros((n_shards, Ep), np.float64)
    eidx = np.zeros((n_shards, Ep), np.int32)
    for d in range(n_shards):
        ids = np.nonzero(owner == d)[0]
        T_local[d, : len(ids)] = T[ids] - d * nb + Bd
        emask[d, : len(ids)] = 1.0
        eidx[d, : len(ids)] = ids
    if T_local.min() < 0 or T_local.max() >= nb + 2 * Bd:
        raise AssertionError("an element outside its rank's halo window")
    return HaloPlan(T_local=T_local, emask=emask, eidx=eidx, nb=nb, Bd=Bd,
                    nv_pad=nv_pad, D=n_shards)


@dataclasses.dataclass
class RankHalo:
    """One rank's share of a HaloPlan, on its device."""

    T_local: torch.Tensor     # (Ep, k) int32
    emask: torch.Tensor       # (Ep,)
    eidx: torch.Tensor        # (Ep,) int64
    plan: assembly.IncidencePlan  # (nb + 2 Bd) rows <- (element, corner)
    nb: int
    Bd: int


def rank_halo(plan: HaloPlan, rank: int, dtype, device) -> RankHalo:
    dev = torch.device(device)
    nrows = plan.nb + 2 * plan.Bd
    return RankHalo(
        T_local=torch.as_tensor(plan.T_local[rank], device=dev),
        emask=torch.tensor(plan.emask[rank], dtype=dtype, device=dev),
        eidx=torch.as_tensor(plan.eidx[rank].astype(np.int64), device=dev),
        plan=assembly.build_incidence_plan(plan.T_local[rank], nrows, dev),
        nb=plan.nb, Bd=plan.Bd,
    )


def halo_in(comm, p: torch.Tensor, nb: int, Bd: int) -> torch.Tensor:
    """(nb, X) owned rows -> (nb + 2 Bd, X): the left neighbour's tail, the
    rows, the right neighbour's head (the two ring shifts of one
    comm.ring)."""
    # the left neighbour's tail, the right neighbour's head
    left, right = comm.ring(p[nb - Bd:], p[:Bd])
    return torch.cat([left, p, right], dim=0)


def halo_out(comm, buf: torch.Tensor, nb: int, Bd: int) -> torch.Tensor:
    """(nb + 2 Bd, X) sums -> (nb, X): the halo rows sent back to their
    owners and added there."""
    # the right halo to the right neighbour's head, the left halo to the
    # left neighbour's tail
    from_left, from_right = comm.ring(buf[nb + Bd:], buf[:Bd])
    out = buf[Bd: nb + Bd].clone()
    out[nb - Bd:] += from_right
    out[:Bd] += from_left
    return out


def element_rows(T, Gw, mass, p) -> torch.Tensor:
    """K1's per-corner rows (E, k, d) of (M_e (x) I + Gw_e^T Gw_e) p_e over
    the element table T into the rows p (already projected): kernel K1 on
    a CUDA tensor, its plain version on a CPU tensor."""
    ones = p.new_ones((p.shape[0],))
    if p.device.type == "cpu":
        return opmod.element_apply_plain(T, Gw, mass, ones, p)
    return cuda.element_apply(T.contiguous(), Gw.contiguous(),
                              mass.contiguous(), ones, p.contiguous())


def halo_matvec(comm, rh: RankHalo, mass_coeff, Gw, free_mask, p_blk):
    """This rank's rows (nb, d) of P (M + sum Gw^T Gw) P^T p, vertex-
    partitioned. mass_coeff (E, k, k) and Gw (E, N, k, d) are the whole
    mesh's (replicated, as the JAX function's inputs are) and are gathered
    per rank through the plan; free_mask (nb,) and p_blk (nb, d) are the
    rank's rows of the padded vertex arrays."""
    nb, Bd = rh.nb, rh.Bd
    Gw_l = Gw[rh.eidx] * rh.emask[:, None, None, None]
    Mc_l = mass_coeff[rh.eidx] * rh.emask[:, None, None]
    fm = free_mask[:, None]
    xbuf = halo_in(comm, p_blk * fm, nb, Bd)
    obuf = assembly.segment_sum(rh.plan, element_rows(rh.T_local, Gw_l, Mc_l,
                                                      xbuf))
    return halo_out(comm, obuf, nb, Bd) * fm
