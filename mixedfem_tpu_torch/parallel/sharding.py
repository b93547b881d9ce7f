"""The element-sharded step (port of mixedfem_tpu/parallel/sharding.py).

The JAX package places the element arrays of MeshData and of the state
(T, dphidX, vols, mass_coeff, mu, lam, model_id; s, la) sharded along the
element axis of a device mesh, the vertex arrays replicated, and lets GSPMD
insert the all-reduces after the element-to-vertex sums. Here each rank
holds its contiguous slice of the element arrays, padded as the JAX
package pads them (zero-volume elements that point at vertex 0, so that
every rank has as many), and the whole vertex arrays; newton_step (or
newton_step_direct) with the rank's `comm` then runs its body with a psum
after every element-to-vertex sum and every element reduction, and adds
the terms over vertices and contact frames once, after it
(optimizer/newton.py). Each rank's incidence plan, and its banded plan
where the scene has one, is built here over its own elements, with the
comm's psum as its `reduce`: its sums are K2's (K4's) over its slice,
then summed over the ranks.

The sharded step runs what the single-device step runs: every on-device
solver, the host solvers, contact through Simulation.step (shard_scene:
the broadphase runs on every rank over the whole positions and gives
every rank the same frames), 2D solids, shells and rods, f64 islands,
warm-started rotations, the vanilla stretch and press controllers. It
refuses two things:

  * a StencilPlan (newton.check_sharded): the JAX package leaves the plan
    whole, so its sharded lattice body would hold the whole lattice on
    every device; the grid's sharded step is parallel/stencil_shard.py;
  * a shell's rest normals, a rod's rest frames and lengths, and the
    warm-started rotations SimState.R over an element count that does not
    divide by the ranks (ValueError): the JAX package pads none of them,
    and its sharded step then fails (cloth(4, 4)'s 32 triangles over 3
    devices: "mul got incompatible shapes for broadcasting: (33, 3, 1),
    (32, 1, 3)"). The port does not pad what the JAX package does not.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from mixedfem_tpu_torch.ops import assembly
from mixedfem_tpu_torch.solvers import operator as opmod

# MeshData fields along the element axis; everything else is replicated
ELEM_FIELDS = ("T", "dphidX", "vols", "mass_coeff", "mu", "lam", "model_id")
# the material fields, which a padded element copies from element 0
MATERIAL_FIELDS = ("mu", "lam", "model_id")
# per-element MeshData fields of shells and rods, which the JAX package
# leaves unpadded: sliced when the element count divides by the ranks
UNPADDED_FIELDS = ("rest_normal", "rod_frames", "rod_L")
STATE_ELEM_FIELDS = ("s", "la")

JAX_PAD_FAULT = (
    "the JAX package's shard_simulation pads T, dphidX, vols, mass_coeff, "
    "mu, lam, model_id, s and la but not {name}, and its sharded step then "
    "fails (cloth(4, 4) over 3 devices: 'mul got incompatible shapes for "
    "broadcasting: (33, 3, 1), (32, 1, 3)')")


def element_padding(E: int, n: int) -> int:
    """Zero elements that pad E elements to a multiple of n ranks."""
    return (-E) % n


def slice_rank(x: torch.Tensor, pad: int, rank: int, size: int,
           fill_first: bool = False) -> torch.Tensor:
    """Rank `rank`'s contiguous slice of x, padded by `pad` rows of zeros
    (or, with `fill_first`, copies of x's first row)."""
    if pad:
        rows = (x[:1].expand((pad,) + tuple(x.shape[1:])) if fill_first
                else x.new_zeros((pad,) + tuple(x.shape[1:])))
        x = torch.cat([x, rows])
    n = x.shape[0] // size
    return x[rank * n:(rank + 1) * n].contiguous()


def _slice_unpadded(x, name: str, pad: int, rank: int, size: int):
    """_slice of a per-element field that the JAX package leaves unpadded:
    ValueError when it would need padding."""
    if pad:
        raise ValueError(f"{x.shape[0]} elements over {size} ranks: "
                         + JAX_PAD_FAULT.format(name=name))
    return slice_rank(x, 0, rank, size)


def shard_mesh_data(mesh, rank: int, size: int, pad_to_multiple: bool = True,
                    reduce=None):
    """(rank's MeshData, pad): the element arrays padded to a multiple of
    `size` with zero-volume elements whose corners are vertex 0 (zero
    dphidX and mass: no energy, no stiffness) and sliced for `rank`; a
    shell's or a rod's per-element fields sliced (ValueError where they
    would need padding); the vertex arrays whole; the incidence plan over
    the rank's elements, its sums followed by `reduce` (the rank's
    comm.psum, for the element-sharded step).

    A padded element takes element 0's material (mu, lam, model_id) where
    the JAX package pads zeros: several materials divide by lam (Fung,
    Stable-Neo-Hookean), so a zero lam makes the padded element's
    coefficients NaN, which its zero volume does not cancel (0 x NaN), and
    the JAX package's padded run of an element-space solver stops at once
    with NaN dot products. With a real material every coefficient is
    finite and the zero volume keeps them out of every sum."""
    E = mesh.nelem
    pad = element_padding(E, size) if pad_to_multiple else 0
    if (E + pad) % size:
        raise ValueError(f"{E} elements over {size} ranks without padding")
    local = {f: slice_rank(getattr(mesh, f), pad, rank, size,
                       fill_first=f in MATERIAL_FIELDS) for f in ELEM_FIELDS}
    for f in UNPADDED_FIELDS:
        if getattr(mesh, f) is not None:
            local[f] = _slice_unpadded(getattr(mesh, f), f, pad, rank, size)
    plan = assembly.with_reduce(assembly.build_incidence_plan(
        local["T"].cpu().numpy(), mesh.nv, mesh.device), reduce)
    return dataclasses.replace(mesh, plan=plan, **local), pad


def shard_sim_state(state, rank: int, size: int, pad: int):
    """The rank's state: s and la padded by `pad` zero rows and sliced,
    and the warm-started rotations R sliced (ValueError where they would
    need padding)."""
    local = {f: slice_rank(getattr(state, f), pad, rank, size)
             for f in STATE_ELEM_FIELDS}
    if state.R.shape[0]:
        local["R"] = _slice_unpadded(state.R, "SimState.R", pad, rank, size)
    return dataclasses.replace(state, **local)


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


def shard_simulation(mesh, state, comm, coarse=None):
    """(mesh', state', coarse') of the rank of `comm`: the mesh's sums
    followed by comm.psum (newton_step with this comm checks it)."""
    mesh2, pad = shard_mesh_data(mesh, comm.rank, comm.size,
                                 reduce=comm.psum)
    state2 = shard_sim_state(state, comm.rank, comm.size, pad)
    cs2 = None if coarse is None else shard_coarse_space(
        coarse, mesh, comm.rank, comm.size, pad)
    return mesh2, state2, cs2


def shard_scene(sim, comm):
    """The rank's Simulation (io/scene.py) of a loaded scene: its mesh,
    state and coarse space sliced (shard_simulation), a banded plan rebuilt
    over the rank's elements where the scene has one (its sums too
    followed by comm.psum), the Gauss-Seidel coloring, the boundary
    conditions and the press controllers whole, `comm`, which
    Simulation.step hands to the step, and the unsharded mesh as
    `whole_mesh`, over which the host solvers' systems are assembled
    (optimizer/newton_direct.py). The render meshes' embeddings name
    elements of the whole mesh, so the rank's Simulation has none:
    skinned_surfaces is the unsharded Simulation's."""
    mesh, state, coarse = shard_simulation(sim.mesh, sim.state, comm,
                                           sim.coarse)
    plan = None if sim.matvec_plan is None else assembly.with_reduce(
        opmod.build_banded_plan(mesh), comm.psum)
    return dataclasses.replace(sim, mesh=mesh, state=state, coarse=coarse,
                               matvec_plan=plan, skinning=(), comm=comm,
                               whole_mesh=sim.mesh)


def gather_elements(comm, x: torch.Tensor, E: int) -> torch.Tensor:
    """The whole (E, ...) element array from each rank's slice (the padding
    dropped): the inverse of the slicing, on every rank."""
    return torch.cat(comm.all_gather(x))[:E]
