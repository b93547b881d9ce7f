"""The element-sharded step (port of mixedfem_tpu/parallel/sharding.py).

The JAX package places the element arrays of MeshData and of the state
(T, dphidX, vols, mass_coeff, mu, lam, model_id; s, la) sharded along the
element axis of a device mesh, the vertex arrays replicated, and lets GSPMD
insert the all-reduces after the element-to-vertex sums. Here each rank
holds its contiguous slice of the element arrays, padded as the JAX
package pads them (zero-volume elements that point at vertex 0, so that
every rank has as many), and the whole vertex arrays; newton_step with the
rank's `comm` then runs the generic body with a psum after every
element-to-vertex sum (optimizer/newton.py check_sharded says what it
covers). Each rank's incidence plan is built over its own elements, so its
sums are K2's over its slice.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from mixedfem_tpu_torch.ops import assembly

# MeshData fields along the element axis; everything else is replicated
ELEM_FIELDS = ("T", "dphidX", "vols", "mass_coeff", "mu", "lam", "model_id")
STATE_ELEM_FIELDS = ("s", "la")


def element_padding(E: int, n: int) -> int:
    """Zero elements that pad E elements to a multiple of n ranks."""
    return (-E) % n


def _slice(x: torch.Tensor, pad: int, rank: int, size: int) -> torch.Tensor:
    """Rank `rank`'s contiguous slice of x, zero-padded by `pad` rows."""
    if pad:
        x = torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])
    n = x.shape[0] // size
    return x[rank * n:(rank + 1) * n].contiguous()


def shard_mesh_data(mesh, rank: int, size: int, pad_to_multiple: bool = True):
    """(rank's MeshData, pad): the element arrays padded to a multiple of
    `size` with zero-volume elements whose corners are vertex 0 (zero
    dphidX, mass, mu and lam: no energy, no stiffness) and sliced for
    `rank`; the vertex arrays whole; the incidence plan over the rank's
    elements."""
    if mesh.shell or mesh.rod:
        raise NotImplementedError("the element-sharded step covers solids")
    E = mesh.nelem
    pad = element_padding(E, size) if pad_to_multiple else 0
    if (E + pad) % size:
        raise ValueError(f"{E} elements over {size} ranks without padding")
    local = {f: _slice(getattr(mesh, f), pad, rank, size) for f in ELEM_FIELDS}
    plan = assembly.build_incidence_plan(local["T"].cpu().numpy(), mesh.nv,
                                         mesh.device)
    return dataclasses.replace(mesh, plan=plan, **local), pad


def shard_sim_state(state, rank: int, size: int, pad: int):
    """The rank's state: s and la padded by `pad` zero rows and sliced."""
    if state.R.shape[0]:
        raise NotImplementedError("warm-started rotations are not sharded")
    return dataclasses.replace(
        state, **{f: _slice(getattr(state, f), pad, rank, size)
                  for f in STATE_ELEM_FIELDS})


def shard_coarse_space(cs, mesh, rank: int, size: int, pad: int):
    """The rank's coarse space: the element pair buckets sliced (the padded
    elements' corner pairs, all at vertex 0, in the bucket of vertex 0's
    aggregate with itself, where they add zero) and the pair plan over
    them; the aggregates and the vertex geometry whole."""
    a0 = int(cs.agg_id[int(mesh.T[0, 0])])
    rows, cols = cs.pair_rows.cpu().numpy(), cs.pair_cols.cpu().numpy()
    (b0,) = np.nonzero((rows == a0) & (cols == a0))[0]
    pid = cs.pair_id
    if pad:
        pid = torch.cat([pid, pid.new_full((pad,) + tuple(pid.shape[1:]),
                                           int(b0))])
    n = pid.shape[0] // size
    pid = pid[rank * n:(rank + 1) * n].contiguous()
    return dataclasses.replace(
        cs, pair_id=pid,
        pair_plan=assembly.build_incidence_plan(pid.cpu().numpy(), len(rows),
                                                pid.device))


def shard_simulation(mesh, state, rank: int, size: int, coarse=None):
    """(mesh', state', coarse') of rank `rank` of `size`."""
    mesh2, pad = shard_mesh_data(mesh, rank, size)
    state2 = shard_sim_state(state, rank, size, pad)
    cs2 = None if coarse is None else shard_coarse_space(coarse, mesh, rank,
                                                         size, pad)
    return mesh2, state2, cs2


def gather_elements(comm, x: torch.Tensor, E: int) -> torch.Tensor:
    """The whole (E, ...) element array from each rank's slice (the padding
    dropped): the inverse of the slicing, on every rank."""
    return torch.cat(comm.all_gather(x))[:E]
