"""Carry the JAX package's mesh, state (contact frames included),
coarse space (geometric or grid), boundary conditions, press controllers,
banded plan and stencil plan across to the port.

The JAX objects are handed over as dicts of numpy arrays (one entry per
dataclass field, nested dataclasses as nested dicts, static fields such as
``models``, ``naggr``, ``order`` and ``h`` as plain Python values), so this
module needs neither JAX nor ``mixedfem_tpu``. Both packages then step from
identical inputs.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from mixedfem_tpu_torch.bc.boundary_conditions import BCSpec, BCState
from mixedfem_tpu_torch.bc.press import PressSpec, PressState
from mixedfem_tpu_torch.device import resolve_device
from mixedfem_tpu_torch.integrators.bdf import BDFState
from mixedfem_tpu_torch.mesh.mesh import MeshData, mesh_from_arrays
from mixedfem_tpu_torch.ops.banded_scatter import plan_from_arrays
from mixedfem_tpu_torch.ops.stencil import StencilPlan, plan_from_terms
from mixedfem_tpu_torch.optimizer.newton import SimState, StepStats
from mixedfem_tpu_torch.solvers.coarse import CoarseSpace, coarse_from_arrays
from mixedfem_tpu_torch.solvers.operator import BandedPlan
from mixedfem_tpu_torch.variables.mixed_collision import contact_frames

_MESH_FIELDS = (
    "V0", "T", "dphidX", "vols", "mass_coeff", "mass_lumped", "mass_diag",
    "free_mask", "mu", "lam", "model_id", "ext_force", "obj_id", "F_srf",
    "E_srf",
)


def mesh_from_numpy(d: Mapping, dtype, device) -> MeshData:
    if d.get("shell") or d.get("rod") or d.get("dim", 3) != 3:
        raise NotImplementedError("only 3D tet solids are ported")
    return mesh_from_arrays(
        **{k: d[k] for k in _MESH_FIELDS}, models=tuple(d["models"]),
        dtype=dtype, device=device,
    )


def coarse_from_numpy(d: Mapping, dtype, device) -> CoarseSpace:
    """A geometric or a grid (lattice-block, `grid` set) coarse space."""
    return coarse_from_arrays(
        agg_id=d["agg_id"], r=d["r"], pair_id=d["pair_id"],
        pair_rows=d["pair_rows"], pair_cols=d["pair_cols"],
        naggr=d["naggr"], dtype=dtype, device=device, grid=d.get("grid"),
    )


def bc_state_from_numpy(d: Mapping) -> BCState:
    return BCState(
        elapsed=float(np.asarray(d["elapsed"])),
        reversed=bool(np.asarray(d["reversed"])),
        done=bool(np.asarray(d["done"])),
    )


def press_state_from_numpy(d: Mapping) -> PressState:
    return PressState(**{k: float(np.asarray(d[k]))
                         for k in ("f", "marker_pos", "marker_pos0")})


def state_from_numpy(d: Mapping, dtype, device) -> SimState:
    def f(a):
        return torch.tensor(np.asarray(a), dtype=dtype, device=device)

    st, bdf = d["stats"], d["bdf"]
    if np.asarray(d.get("R", np.zeros((0, 3, 3)))).shape[0]:
        raise NotImplementedError("rotation_warm_start state")
    cf = d["contact"]
    return SimState(
        x=f(d["x"]),
        s=f(d["s"]),
        la=f(d["la"]),
        bdf=BDFState(
            x_hist=f(bdf["x_hist"]), v_hist=f(bdf["v_hist"]),
            order=int(bdf["order"]), h=float(bdf["h"]),
        ),
        bc_states=tuple(bc_state_from_numpy(b) for b in d["bc_states"]),
        # the JAX ContactFrames, with the frame plan built from them
        contact=contact_frames(cf["frames"], cf["ftype"], cf["fmask"],
                               np.asarray(d["x"]).shape[0], dtype, device),
        press_states=tuple(
            press_state_from_numpy(p) for p in d["press_states"]
        ),
        step_count=int(np.asarray(d["step_count"])),
        stats=StepStats(
            **{k: f(st[k]) for k in (
                "energy", "energy_res", "decrement", "alpha", "solver_error",
                "vanilla_grad",
            )},
            solver_iters=torch.tensor(
                np.asarray(st["solver_iters"], np.int32), device=device
            ),
            iterations=int(np.asarray(st["iterations"])),
            # not recorded by the JAX package
            active_frames=torch.zeros(len(st["energy"]), dtype=torch.int32,
                                      device=device),
            min_distance=torch.full((len(st["energy"]),), float("inf"),
                                    dtype=dtype, device=device),
        ),
        precond=f(d["precond"]),
    )


def from_jax_numpy(mesh=None, state=None, coarse=None, *, dtype=torch.float64,
                   device="cuda"):
    """(MeshData, SimState, CoarseSpace) of the port, each None where the
    corresponding dict is None."""
    dev = resolve_device(device)
    return (
        None if mesh is None else mesh_from_numpy(mesh, dtype, dev),
        None if state is None else state_from_numpy(state, dtype, dev),
        None if coarse is None else coarse_from_numpy(coarse, dtype, dev),
    )


def bc_spec_from_numpy(d: Mapping, dtype, device) -> BCSpec:
    dev = resolve_device(device)

    def f(a):
        return torch.tensor(np.asarray(a), dtype=dtype, device=dev)

    return BCSpec(
        **{k: f(d[k]) for k in ("group0", "group1", "fixed", "center",
                                "center0", "center1", "vel_vec")},
        type=d["type"], velocity=float(d["velocity"]),
        duration=float(d["duration"]), flip=bool(d["flip"]),
    )


def press_spec_from_numpy(d: Mapping, dtype, device) -> PressSpec:
    dev = resolve_device(device)
    return PressSpec(
        forced=torch.tensor(np.asarray(d["forced"]), dtype=dtype, device=dev),
        axis=int(d["axis"]), marker=int(d["marker"]),
        target_velocity=float(d["target_velocity"]),
        max_force=float(d["max_force"]),
        max_displacement=float(d["max_displacement"]),
    )


def banded_plan_from_numpy(d: Mapping, device) -> BandedPlan:
    """The JAX BandedPlan (lidx, win_start in lane units, nrows, chunk, W,
    nv) with K4's fixed-order plan derived from it."""
    return plan_from_arrays(
        lidx=d["lidx"], win_start=d["win_start"], nrows=int(d["nrows"]),
        chunk=int(d["chunk"]), W=int(d["W"]), nv=int(d["nv"]),
        device=resolve_device(device),
    )


def stencil_plan_from_numpy(d: Mapping, device) -> StencilPlan:
    """The JAX StencilPlan (masks, NI, NJ, NK, nslots, terms, vec_terms)
    with the port's tables built from it. Its element order is the one the
    JAX mesh was built in (cell-major after build_stencil_plan's
    permutation), which mesh_from_numpy keeps, so both packages step the
    same elements."""
    return plan_from_terms(
        int(d["NI"]), int(d["NJ"]), int(d["NK"]), int(d["nslots"]),
        d["terms"], d["vec_terms"], d["masks"], resolve_device(device),
    )
