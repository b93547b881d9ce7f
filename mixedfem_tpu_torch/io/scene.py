"""Scene loading: the reference's JSON scene vocabulary -> Simulation (port
of mixedfem_tpu/io/scene.py): 3D tet meshes (.mesh) and 2D triangle meshes
(.obj, z-truncated, not normalized, with dim=2).

The JSON schema is the JAX package's: dt, body_force, time_integrator,
linear_solver, max_newton_iterations, max_linesearch_iterations,
max_iterative_solver_iters, iterative_solver_tolerance,
objects[{path, offset, transformation, initial_velocity, normalize,
material_index, material_ids, boundary_condition, external_force,
skinning_mesh}], material_models[{youngs_modulus, poissons_ratio, density,
energy}], mixed_variables, variables, initial_state{x_path, v_path},
enable_ccd, dhat, kappa; this loader also reads rhs_precision and
rotation_warm_start (f64 islands and warm-started rotations of the step),
which the JAX loader leaves at their defaults. Multi-object scenes are
concatenated into one global mesh. A scene that omits mixed_variables gets mixed-stretch and
mixed-collision (IPC contact), as in the JAX package.

On the card the loader mirrors the JAX package's accelerator choices:
elements in banded order (sorted by min vertex id) and a banded plan for
scenes of 2000 elements or more, so every assembly and condensed matvec
goes through kernel K4; a two-level coarse space (target 48) for such
scenes with the 'pcg' solver only, and the vertex coloring (GSPlan) for
'gauss-seidel'. On the CPU the scene keeps its natural element order.
Simulation.step routes the host solvers ('direct', 'pcg-ic', 'amgcl':
the reference's default eigen-llt, eigen-ldlt, eigen-lu, cholmod,
eigen-pcg-IC and subspace-amgcl) to optimizer/newton_direct.py, with the
banded plan for its device sums, and every other name to newton_step.

With contact, Simulation.step runs the host broadphase once per step
(collision/broadphase.py: candidates_3d over the surface, candidates_2d
over the boundary edges; under the profiler span `scene.broadphase`) with
a margin that covers the expected motion, and re-runs the step from the
saved pre-step state with a wider margin when the step moved a vertex
further than that. A rank's share of an element-sharded scene
(parallel/sharding.py shard_scene) runs the same broadphase over the
whole positions, which every rank holds, and so finds the same frames and
makes the same retries as every other rank.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import List, Optional, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from mixedfem_tpu_torch.bc.boundary_conditions import (
    BCConfig, BCSpec, BCState, boundary_groups, build_bc,
)
from mixedfem_tpu_torch.bc.external_force import ExtConfig, build_external_force
from mixedfem_tpu_torch.bc.press import PressSpec, press_init
from mixedfem_tpu_torch.collision import broadphase as bp
from mixedfem_tpu_torch.config import MaterialConfig, SimConfig
from mixedfem_tpu_torch.device import resolve_device
from mixedfem_tpu_torch.io import mesh_io
from mixedfem_tpu_torch.materials.models import MATERIAL_NAMES, model_index
from mixedfem_tpu_torch.mesh.mesh import MeshData, build_mesh_data
from mixedfem_tpu_torch.optimizer.newton import (
    HOST_SOLVERS, SimState, check_supported, init_state, newton_step,
)
from mixedfem_tpu_torch.optimizer.newton_direct import newton_step_direct
from mixedfem_tpu_torch.solvers import coarse as coarsemod
from mixedfem_tpu_torch.solvers import gauss_seidel as gsmod
from mixedfem_tpu_torch.solvers import operator as opmod
from mixedfem_tpu_torch.solvers.factory import resolve_solver
from mixedfem_tpu_torch.utils.skinning import apply_skinning, embed_in_tets
from mixedfem_tpu_torch.variables.mixed_collision import contact_frames

# scenes of this many elements or more get the banded plan (on the card)
# and the two-level coarse space, as in the JAX package
BANDED_MIN_TETS = 2000

_DTYPES = {"float32": torch.float32, "float64": torch.float64}


@dataclasses.dataclass
class Simulation:
    """A loaded scene: static data, state and what one step needs."""

    mesh: MeshData
    config: SimConfig
    bc_specs: Tuple[BCSpec, ...]
    state: SimState
    dim: int
    obj_slices: List[slice]
    coarse: Optional[coarsemod.CoarseSpace] = None
    press_specs: Tuple = ()
    skinning: Tuple = ()  # per object (V_render, F_render, tet_id, bary)
    matvec_plan: Optional[opmod.BandedPlan] = None
    gs_plan: Optional[gsmod.GSPlan] = None  # the 'gauss-seidel' coloring
    retries: int = 0  # contact steps re-run with a wider margin
    # a rank's comm (parallel/comm.py) when this is a rank's share of an
    # element-sharded scene (parallel/sharding.py shard_scene), else None
    comm: Optional[object] = None
    # the unsharded mesh of a rank's share, over which the host solvers
    # assemble their system (optimizer/newton_direct.py), else None
    whole_mesh: Optional[MeshData] = None
    broadphase_ms: float = 0.0  # host ms of the broadphase, summed

    def skinned_surfaces(self):
        """The attached render meshes, advected with the current positions."""
        X = self.state.x.cpu().numpy()
        T = self.mesh.T.cpu().numpy()
        return [(apply_skinning(X, T, tid, bary), Fr)
                for (Vr, Fr, tid, bary) in self.skinning]

    def _one_step(self) -> SimState:
        if resolve_solver(self.config.solver) in HOST_SOLVERS:
            return newton_step_direct(
                self.mesh, self.config, self.bc_specs, self.state,
                self.press_specs, self.matvec_plan, comm=self.comm,
                whole_mesh=self.whole_mesh,
            )
        return newton_step(
            self.mesh, self.config, self.bc_specs, self.state, self.coarse,
            self.press_specs, self.matvec_plan, self.gs_plan, comm=self.comm,
        )

    def step(self) -> SimState:
        c = self.config
        if not ("mixed-collision" in c.mixed_variables
                or "collision" in c.variables or "friction" in c.variables):
            self.state = self._one_step()
            return self.state

        # The candidate set is fixed within a step and built with a margin
        # that covers the expected motion. If the step moved a vertex
        # further than that budget, a contact may have been missed: re-run
        # the whole step from the pre-step state with a margin that covers
        # the observed motion. newton_step writes into no tensor of the
        # state it is given, so pre_state is intact for the retry.
        pre_state = self.state
        budget = self._update_contact_candidates()
        for _attempt in range(4):
            self.state = self._one_step()
            moved = float(torch.linalg.vector_norm(
                self.state.x - pre_state.x, dim=1).amax())
            if moved <= budget:
                break
            self.retries += 1
            self.state = pre_state
            budget = self._update_contact_candidates(min_motion=1.5 * moved)
        return self.state

    @record_function("scene.broadphase")
    def _update_contact_candidates(self, min_motion: float = 0.0) -> float:
        """Host broadphase once per step with margin 1.1 dhat plus twice the
        expected motion; returns the per-vertex motion budget that margin
        covers."""
        t0 = time.perf_counter()
        V = self.state.x.cpu().numpy()
        v = self.state.bdf.v_hist[0].cpu().numpy()
        motion = np.linalg.norm(v, axis=1).max() * self.config.h if len(v) else 0.0
        # always budget at least one dhat of unpredicted motion (it covers
        # acceleration from rest, such as gravity's onset)
        motion = max(motion, min_motion, self.config.dhat)
        margin = 1.1 * self.config.dhat + 2.0 * motion

        E_srf = self.mesh.E_srf.cpu().numpy()
        if self.dim == 3:
            F_srf = self.mesh.F_srf.cpu().numpy()
            frames, types = bp.candidates_3d(
                V, F_srf, E_srf, np.unique(F_srf.reshape(-1)), margin)
        else:
            frames, types = bp.candidates_2d(
                V, E_srf, np.unique(E_srf.reshape(-1)), margin)
        cap = (bp.capacity(len(frames), self.config.max_contact_frames)
               if len(frames) else 0)
        f, t, m = bp.pad_candidates(frames, types, cap)
        x = self.state.x
        self.state = dataclasses.replace(self.state, contact=contact_frames(
            f, t, m, self.mesh.nv, x.dtype, x.device))
        self.broadphase_ms += (time.perf_counter() - t0) * 1e3
        return motion

    def attach_precond_cache(self):
        """Size the cached coarse inverse when coarse_refresh_every > 1."""
        if self.coarse is not None and self.config.coarse_refresh_every > 1:
            ncd = self.coarse.ncd
            self.state = dataclasses.replace(
                self.state, precond=self.state.x.new_zeros((ncd, ncd))
            )
        return self

    def enable_coarse_preconditioner(self, target_size: int = 64):
        self.coarse = coarsemod.build_coarse_space(
            self.mesh.V0.cpu().numpy(),
            self.mesh.T.cpu().numpy(),
            ~self.mesh.free_mask.cpu().numpy().astype(bool),
            target_size=target_size,
            dtype=self.mesh.V0.dtype,
            device=self.mesh.device,
        )
        return self.attach_precond_cache()

    def run(self, n: Optional[int] = None):
        for _ in range(n if n is not None else self.config.timesteps):
            self.step()
        return self.state


def _resolve_path(path: str, scene_dir: str) -> str:
    """Model paths as the reference scenes write them: absolute, relative
    to the scene's directory, or to one or two levels above it."""
    for c in (
        path,
        os.path.join(scene_dir, path),
        os.path.join(scene_dir, "..", path),
        os.path.join(scene_dir, "..", "..", path),
    ):
        if os.path.exists(c):
            return c
    raise FileNotFoundError(f"cannot resolve mesh path '{path}' from {scene_dir}")


def _check_scene(config: SimConfig, dim: int) -> None:
    if dim not in (2, 3):
        raise ValueError(f"scenes of dimension {dim}")
    check_supported(config)


def _load_object_mesh(path: str, dim: int, normalize: bool):
    """An object's (V, T): a .obj of triangles, its unreferenced vertices
    dropped and z truncated (2D; never normalized), or a .mesh of tets,
    scaled by its largest coordinate when `normalize` (3D; a 3D .obj, a
    shell, raises NotImplementedError)."""
    if dim == 2:
        V, T = mesh_io.remove_unreferenced(*mesh_io.read_obj(path))
        return V[:, :2].copy(), T
    if path.lower().endswith(".obj"):
        raise NotImplementedError(
            "a 3D .obj (a shell): the scene loader reads 3D objects as .mesh "
            "tets, as the JAX package's does; shells are built with "
            "mesh.build_mesh_data(..., shell=True)")
    V, T, _ = mesh_io.read_mesh(path)
    return (V / V.max() if normalize else V), T


def load_scene(
    path_or_dict,
    dim: int,
    *,
    dtype: Optional[str] = None,
    overrides: Optional[dict] = None,
    device="cuda",
) -> Simulation:
    """Load a scene JSON file (or dict) into a Simulation on `device`."""
    dev = resolve_device(device)
    if isinstance(path_or_dict, dict):
        args = dict(path_or_dict)
        scene_dir = os.getcwd()
    else:
        with open(path_or_dict) as f:
            args = json.load(f)
        scene_dir = os.path.dirname(os.path.abspath(path_or_dict))
    if overrides:
        args.update(overrides)

    # ---- global config
    solver_name = args.get("linear_solver")
    config = SimConfig(
        h=args.get("dt", 0.034),
        body_force=tuple(args.get("body_force", (0.0, -9.8, 0.0))),
        enable_ccd=args.get("enable_ccd", False),
        dhat=args.get("dhat", 1e-2),
        kappa=args.get("kappa", 10.0),
        timesteps=args.get("timesteps", 300),
        inertia_blend_factor=args.get("inertia_blend_factor", 1.0),
        outer_steps=args.get("max_newton_iterations", 5),
        ls_iters=args.get("max_linesearch_iterations", 20),
        max_iterative_solver_iters=args.get("max_iterative_solver_iters", 500),
        itr_tol=args.get("iterative_solver_tolerance", 1e-4),
        integrator=args.get("time_integrator", "BDF1"),
        optimizer=args.get("optimizer", "newton"),
        mixed_variables=tuple(
            args.get("mixed_variables", ("mixed-stretch", "mixed-collision"))
        ),
        variables=tuple(args.get("variables", ())),
        show_data=args.get("print_stats", True),
        show_timing=args.get("print_timing", True),
        # the step's numerics options (read here so that a scene or
        # `overrides` can set them; the JAX loader leaves them at these
        # defaults): f64 islands, warm-started rotations (init_state then
        # seeds SimState.R)
        rhs_precision=args.get("rhs_precision", "native"),
        rotation_warm_start=bool(args.get("rotation_warm_start", False)),
        # scenes that omit the key get condensed PCG with the two-level
        # preconditioner, as in the JAX package
        solver=resolve_solver(solver_name) if solver_name is not None else "pcg",
        **({"dtype": dtype} if dtype is not None else {}),
    )
    _check_scene(config, dim)
    tdtype = _DTYPES[config.dtype]

    # ---- materials
    mat_cfgs = [
        MaterialConfig(
            model=m.get("energy", "Stable-Neohookean"),
            ym=m.get("youngs_modulus", 1e6),
            pr=m.get("poissons_ratio", 0.45),
            density=m.get("density", 1000.0),
        )
        for m in args.get("material_models", [{}])
    ] or [MaterialConfig()]

    # ---- objects
    Vs, Ts = [], []
    mu_e, la_e, rho_e, model_e = [], [], [], []
    ext_list, v0_list, press_cfgs, skinning_raw = [], [], [], []
    obj_slices: List[slice] = []
    bc_build_args = []  # built once the total vertex count is known

    offset_v = 0
    for obj in args.get("objects", []):
        V, T = _load_object_mesh(_resolve_path(obj["path"], scene_dir), dim,
                                 obj.get("normalize", True))
        V = V + np.asarray(obj.get("offset", (0.0, 0.0, 0.0)))[:dim]
        if "transformation" in obj:
            Tm = np.asarray(obj["transformation"], np.float64).reshape(dim, dim)
            centroid = V.mean(axis=0)
            V = (V - centroid) @ Tm.T + centroid

        # materials: per-tet ids or one index
        if "material_ids" in obj:
            ids = mesh_io.read_dmat(
                _resolve_path(obj["material_ids"], scene_dir)
            ).astype(int).reshape(-1)
        else:
            ids = np.full(len(T), int(obj.get("material_index", 0)))
        if len(ids) and not (0 <= ids.min() and ids.max() < len(mat_cfgs)):
            raise ValueError(f"material ids outside [0, {len(mat_cfgs)})")
        mu_e.append(np.array([mat_cfgs[i].mu for i in ids]))
        la_e.append(np.array([mat_cfgs[i].la for i in ids]))
        rho_e.append(np.array([mat_cfgs[i].density for i in ids]))
        model_e.append(np.array([model_index(mat_cfgs[i].model) for i in ids]))

        iv = np.zeros((len(V), dim))
        if "initial_velocity" in obj:
            iv[:] = np.asarray(obj["initial_velocity"])[:dim]
        v0_list.append(iv)

        bc_raw = obj.get("boundary_condition", {})
        bc_cfg = BCConfig(
            type=bc_raw.get("type", "null"),
            ratio=bc_raw.get("ratio", 0.1),
            axis=bc_raw.get("axis", 0),
            velocity=bc_raw.get("velocity", 0.1),
            duration=bc_raw.get("duration", 1.0),
            flip=bc_raw.get("flip", False),
        )
        ext_raw = obj.get("external_force", {})
        ext_cfg = ExtConfig(
            type=ext_raw.get("type", "area"),
            is_body_force=ext_raw.get("is_body_force", True),
            force=tuple(ext_raw.get("force", config.body_force)),
            axis=ext_raw.get("axis", 0),
            ratio=ext_raw.get("ratio", 0.1),
            max_force=ext_raw.get("max_force", 100.0),
            target_velocity=ext_raw.get("target_velocity", 0.1),
            max_displacement=ext_raw.get("max_displacement", 0.3),
        )

        if "skinning_mesh" in obj:
            Vr, Fr = mesh_io.read_obj(_resolve_path(obj["skinning_mesh"],
                                                    scene_dir))
            skinning_raw.append((Vr / Vr.max(), Fr, V.copy(), T.copy(),
                                 offset_v))

        bc_build_args.append((V.copy(), bc_cfg, offset_v))
        ext_list.append(build_external_force(V, ext_cfg))
        if ext_cfg.type == "press":
            press_cfgs.append((ext_cfg, offset_v, len(V)))
        obj_slices.append(slice(offset_v, offset_v + len(V)))
        Vs.append(V)
        Ts.append(T)
        offset_v += len(V)

    nv_total = offset_v
    # BCs need the global vertex count; their set-up may move V (scale ...)
    bc_specs: List[BCSpec] = []
    bc_states: List[BCState] = []
    all_fixed = []
    for i, (V_obj, bc_cfg, off_i) in enumerate(bc_build_args):
        spec, st, fixed, V_new = build_bc(V_obj, bc_cfg, nv_total, off_i,
                                          dtype=tdtype, device=dev)
        bc_specs.append(spec)
        bc_states.append(st)
        all_fixed.append(fixed)
        Vs[i] = V_new

    V = np.concatenate(Vs, axis=0)
    T = np.concatenate([t + sl.start for t, sl in zip(Ts, obj_slices)], axis=0)
    obj_id = np.concatenate([np.full(len(v), i) for i, v in enumerate(Vs)])
    is_fixed = np.concatenate(all_fixed)
    ext_force = np.concatenate(ext_list, axis=0)
    v0 = np.concatenate(v0_list, axis=0)

    # initial_state resume
    if "initial_state" in args:
        ist = args["initial_state"]
        if "x_path" in ist:
            V = mesh_io.read_dmat(_resolve_path(ist["x_path"], scene_dir))
        if "v_path" in ist:
            v0 = mesh_io.read_dmat(_resolve_path(ist["v_path"], scene_dir))

    # model names present, in registry order
    used = sorted(set(int(i) for arr in model_e for i in np.unique(arr)))
    models_present = tuple(MATERIAL_NAMES[i] for i in used)
    remap = np.zeros(len(MATERIAL_NAMES), np.int64)
    remap[used] = np.arange(len(used))
    model_id = remap[np.concatenate(model_e).astype(np.int64)]
    mu_all = np.concatenate(mu_e)
    la_all = np.concatenate(la_e)
    rho_all = np.concatenate(rho_e)

    # On the card: banded element order, so that K4's chunks of rows span
    # narrow vertex windows (a static reorder of every per-element array).
    # The CPU keeps the scene's order.
    use_banded = dev.type != "cpu"
    elem_perm = None
    if use_banded:
        elem_perm = opmod.sort_elements_banded(T)
        T = T[elem_perm]
        mu_all = mu_all[elem_perm]
        la_all = la_all[elem_perm]
        rho_all = rho_all[elem_perm]
        model_id = model_id[elem_perm]

    mesh = build_mesh_data(
        V, T, density=rho_all, mu=mu_all, lam=la_all, model_id=model_id,
        models=models_present, is_fixed=is_fixed, ext_force=ext_force,
        obj_id=obj_id, dtype=tdtype, device=dev,
    )
    x0 = torch.tensor(np.asarray(V), dtype=tdtype, device=dev)

    matvec_plan = None
    if use_banded and len(T) >= BANDED_MIN_TETS:
        matvec_plan = opmod.build_banded_plan(mesh)

    coarse = None
    if len(T) >= BANDED_MIN_TETS and config.solver == "pcg":
        coarse = coarsemod.build_coarse_space(
            V, T, is_fixed, target_size=48, dtype=tdtype, device=dev
        )

    gs_plan = None
    if config.solver == "gauss-seidel":
        gs_plan = gsmod.build_gs_plan(T, nv_total, dtype=tdtype, device=dev)

    # MechanicalPress controllers
    press_specs, press_states = [], []
    for ecfg, off_i, nvo in press_cfgs:
        V_obj = V[off_i : off_i + nvo]
        forced = np.zeros(nv_total)
        if ecfg.is_body_force:
            forced[off_i : off_i + nvo] = 1.0
            marker = off_i
        else:
            _, g1 = boundary_groups(V_obj, ecfg.ratio, ecfg.axis)
            idx = np.nonzero(g1)[0]
            forced[off_i + idx] = 1.0
            marker = off_i + (idx[0] if len(idx) else 0)
        spec = PressSpec(
            forced=torch.tensor(forced, dtype=tdtype, device=dev),
            axis=ecfg.axis, marker=int(marker),
            target_velocity=ecfg.target_velocity, max_force=ecfg.max_force,
            max_displacement=ecfg.max_displacement,
        )
        press_specs.append(spec)
        press_states.append(press_init(spec, x0, ecfg.force[ecfg.axis]))

    state = init_state(
        mesh, config, tuple(bc_states), x0,
        torch.tensor(np.asarray(v0), dtype=tdtype, device=dev),
        press_states=tuple(press_states),
    )

    # skinning embeddings, tet ids in the mesh's (possibly banded) order
    inv_perm = None
    if elem_perm is not None:
        inv_perm = np.empty(len(elem_perm), np.int64)
        inv_perm[elem_perm] = np.arange(len(elem_perm))
    skinning = []
    for (Vr, Fr, V_obj, T_obj, off_i) in skinning_raw:
        tid, bary = embed_in_tets(Vr, V_obj, T_obj)
        tet_offset = sum(len(t) for t, sl in zip(Ts, obj_slices)
                         if sl.start < off_i)
        tid_g = tid + tet_offset
        if inv_perm is not None:
            tid_g = inv_perm[tid_g]
        skinning.append((Vr, Fr, tid_g, bary))

    return Simulation(
        mesh=mesh, config=config, bc_specs=tuple(bc_specs), state=state,
        dim=dim, obj_slices=obj_slices, coarse=coarse,
        press_specs=tuple(press_specs), skinning=tuple(skinning),
        matvec_plan=matvec_plan, gs_plan=gs_plan,
    )
