#!/usr/bin/env python3
"""Drive mixedfem_tpu_torch on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py [--profile DIR]

Run from the root of a checkout. Phases, none of which catches its own
failure:

1. card: exit non-zero when torch.cuda.is_available() is false; print the
   card's name and power limit (nvidia-smi).
2. build: compile mixedfem_tpu_torch/csrc/kernels.cu with nvcc for sm_90a.
3. kernels: hold K1 (element_apply), K2 (segment_sum at the widths the step
   uses: 3, 9, the coarse restriction's 6 and the coarse Galerkin sums'
   36, whose plan splits long segments into pieces), K3 (contract_G_Gw)
   and K4 (banded_sum at 3 and 9, on the banded beam's plan, W=896, and on
   the scene's plan of phase 6, whose vertex ids are unordered, W=22,400)
   to their plain PyTorch versions at the 100k-tet shapes, in float32 (to
   1e-5 of the output's scale: the plain versions run index_add_, which
   adds in another order on the card) and float64 (to 1e-12); time each
   kernel (the whole wrapper call: K2 with pieces launches twice), its
   plain version and the one PyTorch call that computes the same function
   where there is one, and K4's rows also through K2 over the mesh's
   incidence plan (the same vertex sum); time K2 at m=36 over the pair
   plan split at several piece lengths L, the sweep that chose L; time K3
   in float64 too, and at each tile size TE (elements per block) in both
   types, the sweep that chose TE. K5 (stencil_apply) and K6
   (stencil_assemble) are held to theirs on the bench's 100k-tet box grid
   of phase 8 in both types and timed in both; K5 cold (W copies larger
   than L2, as every other kernel is timed) and hot (the same W, fresh x,
   as the CG loop reads it). K2 is also held to its plain version and
   timed at the contact shapes of phase 11's scene: the frame plan of its
   first candidate set at m=3 (contact rhs and matvec) and m=9 (contact
   diagonal blocks), and the coarse contact pair plan of its first
   refresh (the frames active at the start) at m=36.
4. main path: the bench's 100k-tet beam (bench.py:build(40, 25, 20),
   banded element order, x=0 face pinned, gravity; Stable-Neo-Hookean,
   BDF1, h=0.02, 5 Newton iterations, itr_tol 1e-4, two-level coarse space
   of target size 48 refreshed every 10 steps) in float32 through
   newton_step: one warm-up step and three timed steps, host clock around
   work that ends in torch.cuda.synchronize(). Every launch counter is set
   to 0 just before and read just after; each kernel must have run.
5. trajectory: a 1000-tet beam, 3 float64 steps, on the card with the
   kernels and on the CPU with the plain versions: positions agree to 1e-9
   relative and the CG counts are equal.
6. scene path: the same 100k-tet beam with its vertex ids in a seeded
   random order, written as a .mesh with a scene JSON (twist BC, gravity,
   SNH, BDF1, dt 0.02, 5 Newton iterations, itr_tol 1e-4, default solver:
   pcg with the two-level coarse space refreshed every step) into a
   temporary directory, loaded with load_scene on the card (banded element
   order and plan: every assembly and CG matvec goes through K4) and
   stepped through Simulation.step in float32: one warm-up step and three
   timed steps, counters set to 0 just before and read just after.
7. scene trajectory: a 2000-tet scene (load_scene builds the banded plan
   and the coarse space), 3 float64 steps of 3 Newton iterations, on the
   card and on the CPU (the same loaded objects moved there, so the plain
   versions run over the same element order and plan): positions agree to
   1e-9 of scale, CG and Newton counts are equal.
8. grid path: the bench's headline configuration (bench.py:build(40, 25,
   20) with its stencil plan and element permutation, value_stencil_100k):
   the same beam in cell-major element order with the lattice-block coarse
   space of build_coarse_space_grid, refreshed every 10 steps, in float32
   through newton_step with the StencilPlan (the lattice body: K3, K6,
   K5, K2): one warm-up step and three timed steps, counters set to 0
   just before and read just after; then one float64 step of the same
   beam.
9. grid trajectory: a 1500-tet box grid, 3 float64 steps of 3 Newton
   iterations with a grid coarse space, on the card and on the CPU:
   positions agree to 1e-9 of scale, CG and Newton counts are equal.
10. grid float64 step: one float64 step of phase 8's 100k-tet grid, whose
   CG counts stand beside the float32 ones.
11. contact scene: a slab box_tet_mesh(60, 4, 60) over (2.0, 0.1, 2.0)
   held at its far x end by a hangends BC, and on it a free
   box_tet_mesh(16, 16, 16) over (0.5, 0.5, 0.5) whose bottom lies half
   of dhat above the slab (92,480 tets, 23,518 vertices), as .mesh files
   and a scene JSON that omits mixed_variables, so the loader's default
   adds mixed-collision: SNH (E=1e6, nu=0.4, rho=1000), gravity, BDF1,
   dt 0.01, CCD on, dhat 1e-2, kappa 1e5, 5 Newton iterations, pcg with
   the two-level coarse space; loaded on the card in float32 and stepped
   through Simulation.step (broadphase, ACCD, the retry): one warm-up
   step and three timed steps, counters set to 0 just before and read
   just after. It prints ms per step and per Newton iteration, CG per
   Newton, candidate and active frame counts, retries, the broadphase's
   host ms per step and the least mixed distance, which must be > 0.
12. contact trajectory: the drop scene of tests/test_collision.py (a
   pinned slab and a box 2 dhat above it, dhat 3e-2) written as a scene,
   3 float64 steps of 3 Newton iterations on the card and on the CPU:
   positions agree to 1e-9 of scale; Newton counts, CG counts and active
   frames per iteration are equal.
13. 2D kernels: the triangle instances K1 (element_apply_k3d2, k=3, d=2)
   and K3 (contract_G_Gw_n3, N=3), K2 at m=2 and m=4 over the incidence
   plan of phase 14's mesh, and K4 at m=2 and m=4 over phase 15's banded
   plan, held to their plain versions in float32 (1e-5 of scale) and
   float64 (1e-12) and timed as in phase 3 (K1 and K3 in float64 too),
   each beside its bound and, where there is one, the PyTorch call for
   the same function (index_add_ for K2 and K4, the two einsums for K3).
14. 2D main path: grid_tri_mesh(400, 125) over (4, 1) (100,000
   triangles, 50,526 vertices; the beam's 2D counterpart), banded element
   order, x=0 edge pinned, gravity; SNH (E=1e6, nu=0.45, rho=1000), BDF1,
   h=0.02, 5 Newton iterations, itr_tol 1e-4, two-level coarse space of
   target size 48 refreshed every 10 steps; float32 through newton_step,
   one warm-up step and three timed steps, counters set to 0 just before
   and read just after (K1 2D, K2 m=2, m=4, m=6, m=36 and K3 N=3 must
   have run).
15. 2D contact scene: a slab grid_tri_mesh(500, 40) over (2.0, 0.1) held
   at its far x end by a hangends BC and a free box grid_tri_mesh(175,
   175) over (0.5, 0.5) half of dhat above it (101,250 triangles, 51,517
   vertices), as .obj files and a scene JSON without mixed_variables,
   loaded with load_scene(dim=2) on the card in float32 (SNH E=1e6,
   nu=0.4, gravity, BDF1, dt 0.01, CCD, dhat 1e-2, kappa 1e5, 5 Newton
   iterations, pcg with the two-level coarse space) and stepped through
   Simulation.step: one warm-up step and three timed steps, counters set
   to 0 just before and read just after (K4 m=2 and m=4, and K2 over the
   frame plan, must have run); it prints what phase 11 prints, and the
   least mixed distance must be > 0.
16. 2D trajectories, float64, card against CPU, 3 steps each: a
   1000-triangle cantilever through newton_step (swinging from the start,
   coarse space refreshed every 2nd step), a 2000-triangle two-object
   scene without contact with a scripted rotation, moving down from the
   start (load_scene builds the banded plan and the coarse space), and
   the 2D drop scene of
   tests/test_collision.py with contact, 3 Newton iterations: positions
   agree to 1e-9 of scale; Newton counts, CG counts and (with contact)
   active frames per iteration are equal.
17. the solver family at full width: phase 4's 100k-tet beam (banded
   element order, its incidence plan, so that the condensed matvec is K1 +
   K2; float32, no coarse space, as load_scene gives every solver but
   pcg) through newton_step with minres-kkt, dual-cg, pcg-laplacian,
   pcg-diag, gauss-seidel, admm and minres-kkt-admm, one timed step
   each, cut to 2 Newton iterations (admm to 1: about 27 s each at 500
   sweeps) to keep the script inside its time; then phase 11's 92k-tet
   contact scene through load_scene with eigen-pcg-dualascent and
   minres-indefinite-block (one timed step each; a kept
   step's least mixed distance must be > 0; eigen-pcg-dualascent keeps no
   step on this scene, as its dual-ascent loop diverges, PERF.md, and is
   logged so). For each name: ms per step and per Newton
   iteration, solver iterations per Newton, the last decrement, and the
   K1-K4 launch counts, set to 0 just before and read just after (K2 and
   K3 must run for every name, K1 for pcg-laplacian, pcg-diag and
   gauss-seidel, and K3 inside the Laplacian preconditioner's rows,
   solvers/laplacian.py:laplacian_rows, for pcg-laplacian and
   eigen-pcg-dualascent); one JSON line {"solvers": ...} of them.
18. solver-family trajectories, float64, card against CPU, 1 step (cut
   from 3, then 2, to keep the script inside its time): the
   eight new names on a 1000-tet beam through newton_step, and the drop
   scene through load_scene with eigen-pcg-dualascent,
   minres-indefinite-block, subspace-CG and admm-solver (ADMM capped at
   40 sweeps a Newton iteration): positions agree to 1e-9 of scale,
   Newton counts (and active frames) are equal, Gauss-Seidel's and ADMM's
   sweeps are equal, and the Krylov counts, which rounding decides on
   these systems (tests/solver_parity.py), agree to 2% on the beam and
   10% with contact.
19. the host solve paths and the vanilla stretch, float32: (a) phase 4's
   100k-tet beam (its incidence plan, no coarse space) with the vanilla
   stretch alone and pcg-block-jacobi through newton_step, one warm-up
   and three timed steps (K2 at m=3 and m=9 must run, K1 and K3 must
   not); through load_scene and Simulation.step, (b) eigen-pcg-IC on
   phase 6's 100k-tet scene (5 Newton iterations, one timed step), (c)
   eigen-llt on phase 6's writer at box_tet_mesh(40, 10, 10) (20,000
   tets, 3 Newton iterations) with mixed-stretch (one warm-up and one
   timed step) and with the vanilla stretch alone (one timed step), and
   (d) subspace-amgcl at box_tet_mesh(20, 5, 5) (2,500 tets, 3 Newton
   iterations, one timed step). Each prints ms per step and per Newton
   iteration, host ms per Newton iteration by stage (the device update
   waited for, assembly, factorization and solve, AMG setup), linear
   iterations per Newton, nnz of A or S, the IC shift, the AMG levels and
   the K1-K4 launches, set to 0 just before and read just after (K3 and
   K2 or K4 on every mixed case, no K3 on the vanilla ones); one JSON
   line {"host_solvers": ...} of them.
20. host paths and vanilla stretch, float64, card against CPU, 3 steps:
   a 1000-tet beam scene with eigen-llt, eigen-pcg-IC and subspace-amgcl,
   the drop scene with eigen-llt (mixed-collision, and the nodal
   collision and friction variables in its place), and on a 1000-tet beam
   through newton_step (newton_step_direct for eigen-llt) the vanilla
   stretch alone with pcg-block-jacobi and with eigen-llt, beside
   mixed-stretch with minres-kkt on the beam with Fung's material (10
   iterations a Newton iteration: the two devices' MINRES iterates part
   by rounding beyond that, as the packages' do,
   tests/test_torch_vanilla_steps.py), and the vanilla gradient recorded
   at the mixed iterates of eigen-llt and of newton_step's
   pcg-block-jacobi on the Fung beam: positions to 1e-9 of scale, Newton
   counts and active frames equal, linear counts equal (IC-PCG, AMG-CG,
   MINRES and the recorded case's CG within 2%), the gradient norms to
   1e-9 relative.
21. the lattice-resident CG (the 'lattice_cg' body, where the JAX step
   refuses its row body): phase 8's 100k-tet grid, f32, (a) with an
   inertia blend of 0.5 and the grid coarse space, (b) pcg-block-jacobi
   alone with that blend, one warm-up and three timed steps each (ms per
   step and per Newton iteration, CG per Newton, the last decrement; K5,
   K6, K3 and K2 must launch); then 3 float64 steps of phase 9's
   1500-tet grid in (a), (b) and with the vanilla gradient recorded, card
   against CPU: positions to 1e-9 of scale, Newton and CG counts equal,
   the gradient norms to 1e-9 of the largest.
22. shells: tests/test_shell.py's cloth at 224 x 224 cells (100,352
   triangles, 50,625 vertices: grid_tri_mesh at z = 0, two corners
   pinned, gravity along -z, SNH E = 1e5, nu = 0.40, density 100,
   thickness 1e-3), f32, default pcg without a coarse space, h 0.01, 5
   Newton iterations, CG to 1e-4. K1's shell instance (element_apply_k3d3)
   and K7 (contract_Gw_k3d3) are held to their plain versions at its
   shapes in f32 and f64 and off the tile (E = 1, 31, 33, 103, 100,003,
   aligned and one element off) and timed (K7 beside one torch.einsum);
   one warm-up and three timed steps: K1, K7 and K2 must launch, K3 must
   not.
23. rods: 1,024 strands of 100 segments along +x (102,400 segments),
   their roots pinned on a 32 x 32 grid in the y-z plane 0.02 apart,
   gravity along -y, tests/test_rod.py's material (ARAP, E = 1e7, nu =
   0.40, density 1000, radius 5e-3), with phase 22's checks and step for
   K1's rod instance (element_apply_k2d3) and K7 (contract_Gw_k2d3); then
   3 float64 steps, card against CPU, of the 6 x 6 cloth, the 9-node rod
   and a 2 x 2 bundle of 8-segment strands (CG to 1e-8): positions to 1e-9
   of scale, Newton and CG counts equal.
24. f64 islands (rhs_precision='float64') on float32 states, each case
   beside the same run's island-less phase (ms per step and per Newton
   iteration, CG per Newton, the last and least decrement): (a) phase 4's
   beam, pcg with its coarse space, one warm-up and three timed steps;
   (b) phase 8's grid, through the 'lattice_cg' body (K5 and K6 must
   launch), likewise; (c) pcg-diag on the beam at phase 17's depth, one
   step; (d) phase 11's contact scene, one warm-up and one timed step, the
   least mixed distance > 0. The launch counters, set to 0 after the
   warm-up and read after the timed steps, are split by type: the
   coefficient update runs through K3 in float64 once a Newton iteration
   and in float32 only in a coarse refresh (none in (a)-(c), one an
   attempt in (d)), the rhs through K2 in float64. Then card against CPU:
   the island pieces (the f64 inertia gradient, coefficients, rhs, local
   solves, and the merit at alpha = 0 and 0.5) at one float32 state of a
   1000-tet beam and of the drop scene, to 1e-12 relative; and
   tests/test_newton.py's small_beam(8, 3, 3) with 12 Newton iterations
   without and with islands on both devices: the islands' least decrement
   under 5e-7 and at most 1.05 times the native run's.
25. warm-started rotations (rotation_warm_start), float32: (a) the 100k-tet
   beam with its free part squashed to 10% along x (mirrored through the
   pinned face, every free element inverted), warm and stateless, one
   warm-up and three timed steps each, printing ms per step, CG per
   Newton and, after each step, the inverted elements and the least det F
   (finiteness only); (c) phase 8's grid with warm start, one warm-up and
   one timed step through the 'lattice_cg' body. (b) the squashed
   small_beam(6, 3, 3) in float64, 4 steps, card against CPU and against
   the CPU from x0 moved by one ulp: this trajectory is rounding-chaotic,
   so positions and R are held to 1e-9 of scale or, where the CPU's own
   one-ulp parting is larger, to twice that parting, CG counts to 2%
   (whether the 1e-9 and equal-count criterion held is printed); Newton
   counts equal, every det F > 0 at the end.
26-28. the sharded steps (mixedfem_tpu_torch/parallel/), float32, on
   SHARD_RANKS = 4 ranks on the one card in one process group over gloo
   staged through pinned host buffers (NCCL refuses two ranks on one
   device, so the card shows no scaling), one warm-up and one timed step
   each: 26 the vertex-partitioned 100k-tet beam (RCM order, two-level
   coarse space), run twice from the same start, whose positions must
   repeat bit for bit; 27 the I-slab sharded stencil step on phase 8's
   100k-tet grid (41 I-planes over 4 slabs); 28 the element-sharded
   100k-tet beam (phase 4's configuration without a banded plan). Each
   prints ms per step and per Newton iteration, CG per Newton, the host
   ms inside collectives and the bytes sent per step (the maximum over
   ranks), and each rank's launches by name: K1, K2 and K3 (26), K3,
   K5, K6 and K2 (27), K1, K2 and K3 (28) must launch on every rank.
29. float64 at the CPU tests' sizes: the paths of 26-28 and the
   vertex-partitioned step with contact on the drop mesh, 2 ranks on the
   card against 2 gloo ranks on the CPU started beside them, 2 steps: to
   1e-9 of scale, Newton counts equal, CG within 2% (contact 10%); each
   card run also against the single-rank card step of the same size.
30-31. the element-sharded Simulation.step (parallel/sharding.py
   shard_scene) on ES_RANKS = 2 ranks on the one card, as in 26-28, one
   warm-up and one timed step, float32: 30 phase 11's contact scene
   (load_scene on each rank: banded order, the rank's banded plan, coarse
   space, the broadphase on every rank); 31 phase 22's cloth. Each prints
   what 26-28 print and the broadphase's ms on each rank; K1, K2, K3 and
   K4 (30) and K1 and K7 k3d3 (31) must launch on every rank, and the
   ranks must hold the same frames and positions.
32. float64 (one case f32) at the CPU tests' sizes: one case of every
   path of the element-sharded step through Simulation.step (3D and 2D
   mixed contact, nodal collision (its box moved off the slab's vertex,
   _es_small_cases), friction, a 2D solid, a shell, rods,
   the eight on-device solvers, the banded plan, warm rotations, the
   vanilla stretch, a press, the three host solvers, f64 islands on an
   f32 state), 2 ranks on the card against 2 gloo ranks on the CPU
   started beside them, 2 steps: to 1e-9 of scale (the islands' f32
   state 1e-5), Newton counts equal, Krylov counts within 2% (contact
   10%), equal frames, the host solvers' ranks bit for bit; every
   mismatch is listed before the phase fails.
33. one JSON line of phases 21-23's runs, one of phases 24-25's, one of
   phases 26-31's, one of kernel results (the 2D instances and widths
   with launches_by_path for tri_step and tri_contact_step, the shell and
   rod instances for shell_step and rod_step, the sharded paths, for each
   solver of phase 17, each case of phase 19, of phase 21, of phases
   24-25 and of phases 26-31), then the device line last.

--profile DIR additionally traces one more step of each main path with
torch.profiler, logs the device time of each hand kernel in it, and writes
the per-kernel tables to DIR/profile_step.txt (phase 4),
DIR/profile_scene_step.txt (phase 6), DIR/profile_grid_step.txt
(phase 8), DIR/profile_contact_step.txt (phase 11),
DIR/profile_tri_step.txt (phase 14), DIR/profile_tri_contact_step.txt
(phase 15) and DIR/profile_host_<case>.txt (each case of phase 19).
"""

from __future__ import annotations

import argparse
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

# published H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, and FLOP/s
# outside the tensor cores for float32 and float64
PEAK_BYTES = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.float64: 34e12}
L2_BYTES = 50 * 2**20


_T0 = time.perf_counter()


def log(msg: str) -> None:
    """Print a line; a phase's first line carries the script's seconds so
    far."""
    if msg.startswith("phase "):
        msg += f" [{time.perf_counter() - _T0:.0f} s]"
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# phase 1: the card
# ---------------------------------------------------------------------------

def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# the bench's beam
# ---------------------------------------------------------------------------

def _sim(V, T, dtype, device):
    """bench.py:build's mesh, config and initial state on the port (V (nv,
    3) tets or V (nv, 2) triangles)."""
    from mixedfem_tpu_torch.config import SimConfig, enu_to_lame
    from mixedfem_tpu_torch.mesh import mesh as meshmod
    from mixedfem_tpu_torch.optimizer import newton

    la, mu = enu_to_lame(1e6, 0.45)
    mesh = meshmod.build_mesh_data(
        V, T,
        density=np.full(len(T), 1000.0), mu=np.full(len(T), mu),
        lam=np.full(len(T), la), model_id=np.zeros(len(T), int),
        models=("Stable-Neohookean",), is_fixed=V[:, 0] < 1e-9,
        ext_force=np.tile(np.array([0.0, -9.8, 0.0])[:V.shape[1]], (len(V), 1)),
        dtype=dtype, device=device,
    )
    config = SimConfig(
        h=0.02, outer_steps=5, newton_tol=0.0, max_iterative_solver_iters=500,
        itr_tol=1e-4, coarse_refresh_every=10,
        dtype="float64" if dtype == torch.float64 else "float32",
    )
    x0 = torch.tensor(V, dtype=dtype, device=device)
    return mesh, config, newton.init_state(mesh, config, (), x0,
                                           torch.zeros_like(x0))


def beam(nx, ny, nz, dtype, device):
    """bench.py:build on the port, banded element order: mesh, config,
    initial state, geometric coarse space."""
    from mixedfem_tpu_torch.mesh import generators
    from mixedfem_tpu_torch.solvers import coarse as coarsemod
    from mixedfem_tpu_torch.solvers.operator import sort_elements_banded

    V, T = generators.box_tet_mesh(nx, ny, nz, size=(4.0, 1.0, 1.0))
    T = T[sort_elements_banded(T)]
    mesh, config, state = _sim(V, T, dtype, device)
    cs = coarsemod.build_coarse_space(
        V, T, V[:, 0] < 1e-9, target_size=48, dtype=dtype, device=device
    )
    return mesh, config, state, cs


def grid_beam(nx, ny, nz, dtype, device):
    """bench.py:build on the port with its stencil plan: the element
    permutation of build_stencil_plan, the lattice-block coarse space of
    build_coarse_space_grid and a zero coarse cache (bench.py:339-360).
    Mesh, config, initial state, coarse space, plan."""
    from mixedfem_tpu_torch.mesh import generators
    from mixedfem_tpu_torch.ops import stencil as stmod
    from mixedfem_tpu_torch.solvers import coarse as coarsemod

    V, T = generators.box_tet_mesh(nx, ny, nz, size=(4.0, 1.0, 1.0))
    dims = (nx + 1, ny + 1, nz + 1)
    plan, perm = stmod.build_stencil_plan(T, len(V), dims, device=device)
    if plan is None:
        raise AssertionError("the box grid was not recognised as one")
    T = T[perm]
    mesh, config, state = _sim(V, T, dtype, device)
    cs = coarsemod.build_coarse_space_grid(V, T, V[:, 0] < 1e-9, dims,
                                           dtype=dtype, device=device)
    state.precond = torch.zeros((cs.ncd, cs.ncd), dtype=dtype, device=device)
    return mesh, config, state, cs, plan


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def device_ms(fn, arg_sets, reps=30) -> float:
    """Device time of one call, from CUDA events around `reps` calls that
    cycle through `arg_sets` (copies of the inputs, together larger than the
    L2 cache, so every call reads its inputs from device memory). A sleep
    kernel ahead of the window keeps the stream busy while the host
    enqueues, so the window holds device time, not launch overhead."""
    for args in arg_sets:
        fn(*args)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(reps):
        fn(*arg_sets[i % len(arg_sets)])
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(2e9 * (2.0 * host_s + 1e-3)))  # ~2 GHz clock
    start.record()
    for i in range(reps):
        fn(*arg_sets[i % len(arg_sets)])
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def copies(make, bytes_per_set):
    n = min(16, max(2, math.ceil(2 * L2_BYTES / max(bytes_per_set, 1)) + 1))
    return [make() for _ in range(n)]


def step_inputs(mesh, state, dt):
    """What the main path hands the kernels: D, Hs, Gw at a perturbed state
    of `mesh` (tets or triangles), a vector p, and the corner rows of the
    matvec (rows_p, m = d) and of the diagonal blocks (rows_blk, m = d^2)."""
    from mixedfem_tpu_torch.materials import models as mat
    from mixedfem_tpu_torch.mesh import mesh as meshmod
    from mixedfem_tpu_torch.mesh import rod as rodmod
    from mixedfem_tpu_torch.ops import psd, rotation, smallops
    from mixedfem_tpu_torch.solvers import operator as opmod
    from mixedfem_tpu_torch.variables import mixed_stretch as ms

    g = torch.Generator(device=mesh.device).manual_seed(0)
    dev, dtype = mesh.device, mesh.vols.dtype
    x = state.x + 0.01 * torch.randn(state.x.shape, generator=g, device=dev,
                                     dtype=dtype) * mesh.free_mask[:, None]
    s = ms.reset(mesh, x)[0]
    d = mesh.dim
    R, S = rotation.polar(meshmod.def_grad(mesh, x), d)
    D = rotation.dsdF(R, S, d).contiguous()
    Hs = psd.psd_fix_sqrt(dt * dt * mat.hess_s_all(
        s, mesh.mu, mesh.lam, mesh.model_id, mesh.models), tol=1e-8)[2]
    Hs = Hs.contiguous()
    G = None
    if mesh.shell or mesh.rod:
        # G = D : dF/dx, the Jacobian of the shell's or rod's F
        JT = (meshmod.shell_def_grad_jacobian(mesh, x) if mesh.shell else
              rodmod.rod_def_grad_jacobian(x, *meshmod._rod_args(mesh)))
        G = torch.einsum("eiac,ekrac->eikr", D, JT).contiguous()
        Gw = smallops.contract_Gw_plain(Hs, G, mesh.vols)
    else:
        Gw = smallops.contract_G_Gw_plain(D, mesh.dphidX, Hs, mesh.vols)[1]
    Gw = Gw.contiguous()
    p = torch.randn((mesh.nv, d), generator=g, device=dev, dtype=dtype)
    rows_p = opmod.element_apply_plain(
        mesh.T, Gw, mesh.mass_coeff, mesh.free_mask, p).reshape(-1, d)
    rows_p = rows_p.contiguous()
    rows_blk = torch.einsum("eikr,eiks->ekrs", Gw, Gw).reshape(-1, d * d)
    return dict(D=D, Hs=Hs, G=G, Gw=Gw, p=p, rows_p=rows_p,
                rows_blk=rows_blk.contiguous(), g=g)


def kernel_cases(mesh, cs, state, dt):
    """K1, K2 and K3 (K7 for shells and rods) on the inputs the main path
    gives them: the coefficients at a perturbed state of the 100k-tet beam
    (or of the 100k triangle cantilever, the cloth or the hair, whose
    instances and row widths the kernels take by their shape). K2 at m = d
    and d^2 over the mesh's incidence plan, and at the coarse widths 6 and
    36 where a coarse space `cs` is given."""
    from mixedfem_tpu_torch import cuda
    from mixedfem_tpu_torch.ops import assembly, smallops
    from mixedfem_tpu_torch.solvers import operator as opmod

    dev, dtype = mesh.device, mesh.vols.dtype
    E, k = mesh.T.shape
    d = mesh.dim
    shape = cuda.SHAPES[(k, d)]
    N, k1_name, k3_name = shape.N, shape.k1, shape.k3
    ins = step_inputs(mesh, state, dt)
    D, Hs, Gw, p, g = ins["D"], ins["Hs"], ins["Gw"], ins["p"], ins["g"]
    rows_p, rows_blk = ins["rows_p"], ins["rows_blk"]
    seg_v = mesh.T.reshape(-1).long()

    def k2_case(name, plan, rows, seg):
        base = torch.zeros((plan.nseg, rows.shape[1]), dtype=dtype, device=dev)
        ins = (plan.row_ptr, plan.slots, rows)
        return dict(
            name=name, replaces="mixedfem_tpu/ops/brick.py:442",
            kernel=k2, plain=assembly.segment_sum_plain,
            library=lambda pl, r: torch.index_add(base, 0, seg, r),
            make=lambda: (clone(plan), rows.clone()),
            # what the function must move: rows, slots, row_ptr, out (the
            # plan's piece arrays are not counted)
            bytes=nbytes(*ins) + plan.nseg * rows.shape[1] * rows.element_size(),
            flops=rows.numel(),
            npieces=plan.npieces,
        )

    k1_ins = (mesh.T, Gw, mesh.mass_coeff, mesh.free_mask, p)
    k3_ins = (D, mesh.dphidX, Hs, mesh.vols)
    sq = torch.sqrt(mesh.vols)
    nG = N * k * d  # values of G (and of Gw) per element

    def k3_library(D_, dphi, Hs_, vols):
        G = torch.einsum("eirc,ekc->eikr", D_, dphi)
        return G, torch.einsum("e,eij,ejkr->eikr", sq, Hs_, G)

    cases = [
        dict(
            name=k1_name, replaces="mixedfem_tpu/ops/brick.py:176",
            kernel=cuda.element_apply, plain=opmod.element_apply_plain,
            library=None, make=lambda: tuple(t.clone() for t in k1_ins),
            bytes=nbytes(*k1_ins) + E * k * d * p.element_size(),
            # per element: k d mask products, Gw pe and Gw^T q (2 x N k d
            # FMA), mass (k k d FMA): tets 12 + 2 x 144 + 96
            flops=E * (k * d + 2 * 2 * nG + 2 * k * k * d),
        ),
        k2_case(f"segment_sum_m{d}", mesh.plan, rows_p, seg_v),
        k2_case(f"segment_sum_m{d * d}", mesh.plan, rows_blk, seg_v),
    ]
    if cs is not None:
        rows6 = torch.randn((mesh.nv, 6), generator=g, device=dev, dtype=dtype)
        rows36 = torch.randn((cs.pair_plan.slots.shape[0], 36), generator=g,
                             device=dev, dtype=dtype)
        cases += [
            k2_case("segment_sum_m6", cs.agg_plan, rows6, cs.agg_id),
            k2_case("segment_sum_m36", cs.pair_plan, rows36,
                    cs.pair_id.reshape(-1)),
        ]
    if k3_name is None:
        G = ins["G"]
        k7_ins = (Hs, G, mesh.vols)
        return cases + [
            dict(
                name=shape.k7, replaces="mixedfem_tpu/ops/smallops.py:22",
                kernel=cuda.contract_Gw, plain=smallops.contract_Gw_plain,
                library=lambda Hs_, G_, v: torch.einsum(
                    "e,eij,ejkr->eikr", sq, Hs_, G_),
                make=lambda: tuple(t.clone() for t in k7_ins),
                bytes=nbytes(*k7_ins) + E * nG * G.element_size(),
                # per element: Hs G (nG x N FMA), scale (nG)
                flops=E * (2 * nG * N + nG),
            ),
        ]
    return cases + [
        dict(
            name=k3_name, replaces="mixedfem_tpu/ops/smallops.py:22",
            kernel=cuda.contract_G_Gw, plain=smallops.contract_G_Gw_plain,
            library=k3_library,
            make=lambda: tuple(t.clone() for t in k3_ins),
            bytes=nbytes(*k3_ins) + 2 * E * nG * D.element_size(),
            # per element: G (nG x d FMA), Hs G (nG x N FMA), scale (nG):
            # tets 2 x 216 + 2 x 432 + 72
            flops=E * (2 * nG * d + 2 * nG * N + nG),
        ),
    ]


def clone(obj):
    """A copy of a plan dataclass with every tensor field cloned, nested
    plans included."""
    import dataclasses

    def c(v):
        if torch.is_tensor(v):
            return v.clone()
        return clone(v) if dataclasses.is_dataclass(v) else v

    return dataclasses.replace(obj, **{
        f.name: c(getattr(obj, f.name)) for f in dataclasses.fields(obj)})


def k2(pl, rows):
    """K2's launcher over incidence plan `pl`, pieces included."""
    from mixedfem_tpu_torch import cuda

    return cuda.segment_sum(pl.row_ptr, pl.slots, rows, pl.nseg, pl.piece_ptr,
                            pl.seg_pieces)


def plan_line(name, pl) -> str:
    from mixedfem_tpu_torch.ops import assembly

    longest = int(pl.row_ptr.diff().max()) if pl.nseg else 0
    return (f"{name}: {pl.nseg} segments, {pl.nrows} rows, longest {longest}, "
            f"L {assembly.PIECE_ROWS}, "
            f"pieces {pl.npieces if pl.piece_ptr is not None else 0}")


def piece_sweep(cs, rows36, Ls=(64, 128, 256, 512, 1024, 2**30)):
    """K2 at m=36 (whole wrapper call) over the coarse pair plan split at
    each piece length L (2**30: no pieces), device us per call."""
    from mixedfem_tpu_torch.ops import assembly

    seg = cs.pair_id.reshape(-1).cpu().numpy()
    sets = [rows36, rows36.clone()]
    out = {}
    for L in Ls:
        pl = assembly.build_incidence_plan(seg, cs.pair_plan.nseg,
                                           rows36.device, piece_rows=L)
        out[L] = device_ms(lambda r: k2(pl, r), [(r,) for r in sets]) * 1e3
        log(f"  K2 m=36, L {L}: {pl.npieces if pl.piece_ptr is not None else 0} "
            f"pieces, {out[L]:9.2f} us")
    return out


def tile_sweep(case):
    """K3 (whole wrapper call) in tiles of each of CONTRACT_TILES elements
    on the copies of `case`, device us per call."""
    from mixedfem_tpu_torch import cuda

    sets = copies(case["make"], case["bytes"])
    out = {}
    for tile in cuda.CONTRACT_TILES:
        out[str(tile)] = device_ms(
            lambda *a: cuda.contract_G_Gw_tile(*a, tile), sets) * 1e3
        log(f"  K3 {sets[0][0].dtype}, TE {tile}: {out[str(tile)]:9.2f} us")
    return out


def k4_cases(plan, inc, rows_p, rows_blk, label):
    """K4 at m = d (matvec, rhs, inertia gradient: 3 for tets, 2 for
    triangles) and m = d^2 (diagonal blocks) on `plan`, with the corner rows
    in element order padded to its Rp; K2 over the mesh's incidence plan
    `inc` on the same rows is timed beside it (the same function, another
    design)."""
    from mixedfem_tpu_torch import cuda
    from mixedfem_tpu_torch.ops import banded_scatter as bs

    Rp = plan.lidx.shape[0]
    R = inc.slots.shape[0]
    dev = rows_p.device
    # the vertex of every row, from K4's CSR (the zero padding rows: 0)
    seg = torch.zeros(Rp, dtype=torch.int64, device=dev)
    seg[plan.csr.slots.long()] = plan.csr.seg

    def case(rows):
        m = rows.shape[1]
        rows = bs.pad_rows(plan, rows)
        base = torch.zeros((plan.nv, m), dtype=rows.dtype, device=dev)
        return dict(
            name=f"banded_sum_m{m}", label=label, W=plan.W,
            replaces="mixedfem_tpu/ops/pallas_scatter.py:100",
            kernel=lambda pl, r, _: cuda.banded_sum(
                pl.csr.row_ptr, pl.csr.slots, r, pl.nv, pl.csr.piece_ptr,
                pl.csr.seg_pieces),
            plain=lambda pl, r, _: bs.banded_sum_plain(pl, r),
            library=lambda pl, r, _: torch.index_add(base, 0, seg, r),
            k2=lambda _, r, ip: k2(ip, r[:R]),
            make=lambda: (clone(plan), rows.clone(), clone(inc)),
            # what the function must move: the rows, one int32 vertex id per
            # row and the output (the measure of K2's bound)
            bytes=nbytes(rows) + Rp * 4 + plan.nv * m * rows.element_size(),
            flops=Rp * m,
        )

    return [case(rows_p), case(rows_blk)]


def stencil_cases(mesh, plan, state, dt, dtype):
    """K5 and K6 on what the grid path gives them: Gw at a perturbed state
    of the 100k-tet box grid, its mass blocks, W assembled from them by
    the plain version, a lattice vector x and the lattice free mask, all
    cast to `dtype`."""
    from mixedfem_tpu_torch.ops import stencil as stmod

    ins = step_inputs(mesh, state, dt)
    Gw, mass = ins["Gw"].to(dtype), mesh.mass_coeff.to(dtype)
    W = stmod.assemble_W_plain(plan, Gw, mass)
    x = stmod.to_lat(plan, torch.randn((mesh.nv, 3), generator=ins["g"],
                                       device=mesh.device).to(dtype))
    fm = stmod.to_lat(plan, mesh.free_mask[:, None].expand(-1, 3).to(dtype))
    npad, es, E = plan.npad, x.element_size(), mesh.nelem
    nused = len(plan.used)
    # K6 adds 16 blocks a element: 6 x 9 products and sums, 3 mass adds
    # and 9 adds into the plane
    k6_flops = 16 * E * (2 * 54 + 3 + 9)
    return [
        dict(
            name="stencil_apply", replaces="mixedfem_tpu/ops/stencil.py:378",
            kernel=lambda W_, x_, f_: stmod.matvec_lat(plan, W_, x_, f_),
            plain=lambda W_, x_, f_: stmod.stencil_apply_plain(plan, W_, x_, f_),
            library=None, make=lambda: (W.clone(), x.clone(), fm.clone()),
            # the CG loop's view: one W, a new x each iteration
            hot=lambda: (W, x.clone(), fm),
            # the planes the plan uses, x and fm read once, y written once
            bytes=nused * 9 * npad * es + 3 * 3 * npad * es,
            flops=mesh.nv * (nused * 9 * 2 + 3),
        ),
        dict(
            name="stencil_assemble", replaces="mixedfem_tpu/ops/stencil.py:187",
            kernel=lambda Gw_, m_: stmod.assemble_W(plan, Gw_, m_),
            plain=lambda Gw_, m_: stmod.assemble_W_plain(plan, Gw_, m_),
            library=None, make=lambda: (Gw.clone(), mass.clone()),
            # Gw and mass read once, the planes the plan uses written once
            # (the 8 planes no term touches are zeros the kernel need not
            # store)
            bytes=nbytes(Gw, mass) + nused * 9 * npad * es,
            flops=k6_flops,
        ),
    ]


def max_err(a, b) -> tuple[float, float]:
    a = a if isinstance(a, tuple) else (a,)
    b = b if isinstance(b, tuple) else (b,)
    err = max((x - y).abs().max().item() for x, y in zip(a, b))
    scale = max(y.abs().max().item() for y in b)
    return err, scale


def case_key(c) -> str:
    return c["name"] + (f" ({c['label']})" if "label" in c else "")


def check_kernels(cases, dtype, tol, cast=None):
    """Each kernel against its plain version on the same inputs; `cast`
    converts the inputs first (float64 copies of float32 cases)."""
    results = {}
    for c in cases:
        args = c["make"]()
        if cast is not None:
            args = tuple(cast(a) for a in args)
        got = c["kernel"](*args)
        ref = c["plain"](*args)
        torch.cuda.synchronize()
        err, scale = max_err(got, ref)
        log(f"  {case_key(c):28s} {str(dtype):14s} max_abs_err {err:.3e} "
            f"(scale {scale:.3e}, tolerance {tol:g} x scale)")
        if not err <= tol * scale:
            raise AssertionError(f"{case_key(c)} disagrees with its plain version")
        results[case_key(c)] = err
    return results


def time_kernels(cases, dtype):
    out = []
    for c in cases:
        sets = copies(c["make"], c["bytes"])
        ms = device_ms(c["kernel"], sets)
        plain_ms = device_ms(c["plain"], sets)
        lib_ms = None if c["library"] is None else device_ms(c["library"], sets)
        k2_ms = device_ms(c["k2"], sets) if "k2" in c else None
        hot_ms = (device_ms(c["kernel"], [c["hot"]() for _ in range(4)])
                  if "hot" in c else None)
        bytes_ms = c["bytes"] / PEAK_BYTES * 1e3
        ops_ms = c["flops"] / PEAK_FLOPS[dtype] * 1e3
        out.append(dict(
            name=c["name"], key=case_key(c), ms=ms, plain_ms=plain_ms,
            library_ms=lib_ms, bound_ms=max(bytes_ms, ops_ms),
            bound_by="bytes" if bytes_ms >= ops_ms else "operations",
            k2_same_rows_ms=k2_ms, hot_ms=hot_ms,
        ))
        log(f"  {case_key(c):28s} kernel {ms * 1e3:9.2f} us  plain "
            f"{plain_ms * 1e3:9.2f} us  library "
            f"{'-' if lib_ms is None else f'{lib_ms * 1e3:9.2f}'} us  bound "
            f"{max(bytes_ms, ops_ms) * 1e3:7.2f} us ({c['bytes'] / 1e6:.2f} MB)"
            + ("" if k2_ms is None else f"  K2 on these rows {k2_ms * 1e3:9.2f} us")
            + ("" if hot_ms is None else f"  hot (W in L2) {hot_ms * 1e3:9.2f} us"))
    return out


# ---------------------------------------------------------------------------
# phases 4 and 5: the step
# ---------------------------------------------------------------------------

def run_steps(mesh, config, state, cs, n, plan=None):
    from mixedfem_tpu_torch.optimizer import newton

    states = []
    for _ in range(n):
        state = newton.newton_step(mesh, config, (), state, cs, (), plan)
        states.append(state)
    return states


def describe(st) -> str:
    it = st.stats.iterations
    return (f"newton {it} cg {st.stats.solver_iters[:it].tolist()} alpha "
            f"{st.stats.alpha[:it].tolist()} energy "
            f"{[float(f'{e:.9g}') for e in st.stats.energy[:it].tolist()]}")


def step_figures(states, times) -> dict:
    """ms per step and per Newton iteration, CG iterations per Newton, and
    the last and least decrement of the timed steps `states` (host times
    `times`, ms)."""
    its = sum(st.stats.iterations for st in states)
    cg = sum(sum(st.stats.solver_iters[:st.stats.iterations].tolist())
             for st in states)
    decs = [d for st in states
            for d in st.stats.decrement[:st.stats.iterations].tolist()]
    pos = [d for d in decs if d > 0]
    return dict(ms_per_step=sum(times) / len(times),
                ms_per_newton=sum(times) / its if its else None,
                cg_per_newton=cg / its if its else None,
                last_decrement=decs[-1] if decs else None,
                least_decrement=min(pos) if pos else None,
                newton_iterations=its)


def main_path(mesh, config, state, cs, plan=None, what="100k-tet"):
    """One warm-up step and three timed ones: (the last state, ms per
    step, launches over the four steps, step_figures of the timed
    steps)."""
    from mixedfem_tpu_torch import cuda

    cuda.clear_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    (state,) = run_steps(mesh, config, state, cs, 1, plan)
    torch.cuda.synchronize()
    warm_ms = (time.perf_counter() - t0) * 1e3
    log(f"  warm-up step {warm_ms:.1f} ms: {describe(state)}")
    check_energies(state)
    states, times = [], []
    for _ in range(3):
        t0 = time.perf_counter()
        (state,) = run_steps(mesh, config, state, cs, 1, plan)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        states.append(state)
    step_ms = sum(times) / 3
    launches = dict(cuda.LAUNCHES)
    for k, (st, ms) in enumerate(zip(states, times)):
        log(f"  step {k + 1}: {ms:.3f} ms, {describe(st)}")
    cg = [st.stats.solver_iters[:st.stats.iterations].tolist() for st in states]
    newton_its = sum(st.stats.iterations for st in states)
    log(f"  ms_per_step {step_ms:.3f} (3 timed steps), ms per Newton "
        f"iteration {sum(times) / newton_its:.3f}, CG iterations per "
        f"Newton {sum(map(sum, cg)) / newton_its:.2f}, launches over 4 "
        f"steps {launches}")
    final = states[-1]
    if final.x.shape != (mesh.nv, mesh.dim) or not torch.isfinite(final.x).all():
        raise AssertionError(f"the {what} step produced non-finite positions")
    for st in states:
        check_energies(st)
    return final, step_ms, launches, step_figures(states, times)


def check_energies(st):
    """Finite Newton energies whose last is below the first, up to the line
    search's rounding band."""
    e = st.stats.energy[:st.stats.iterations]
    eps = torch.finfo(e.dtype).eps
    if not (torch.isfinite(e).all() and e[-1] <= e[0] + 16 * eps * abs(e[0])):
        raise AssertionError(f"energies do not decrease: {e.tolist()}")


def trajectory():
    """3 float64 steps of a 1000-tet beam on the card and on the CPU."""
    import dataclasses

    out = {}
    for dev in ("cuda", "cpu"):
        mesh, config, state, cs = beam(10, 5, 4, torch.float64, dev)
        config = dataclasses.replace(config, outer_steps=3,
                                     coarse_refresh_every=2)
        out[dev] = run_steps(mesh, config, state, cs, 3)
    for k, (g, c) in enumerate(zip(out["cuda"], out["cpu"])):
        scale = c.x.abs().max().item()
        err = (g.x.cpu() - c.x).abs().max().item()
        cg_g = g.stats.solver_iters.tolist()
        cg_c = c.stats.solver_iters.tolist()
        log(f"  step {k}: max |x_card - x_cpu| {err:.3e} (scale {scale:.3f}), "
            f"CG card {cg_g} cpu {cg_c}")
        if not err <= 1e-9 * scale:
            raise AssertionError("the card's trajectory leaves the CPU's")
        if cg_g != cg_c or g.stats.iterations != c.stats.iterations:
            raise AssertionError("CG or Newton counts differ")


def grid_float64_step():
    """One float64 step of the 100k-tet grid path on the card: its CG
    counts per Newton iteration beside the float32 ones."""
    mesh, config, state, cs, plan = grid_beam(40, 25, 20, torch.float64, "cuda")
    t0 = time.perf_counter()
    (st,) = run_steps(mesh, config, state, cs, 1, plan)
    torch.cuda.synchronize()
    log(f"  float64 step {(time.perf_counter() - t0) * 1e3:.1f} ms: {describe(st)}")
    check_energies(st)


def grid_trajectory():
    """3 float64 steps of a 1500-tet box grid with a grid coarse space on
    the card (K3, K5, K6, K2) and on the CPU (plain versions)."""
    import dataclasses

    out = {}
    for dev in ("cuda", "cpu"):
        mesh, config, state, cs, plan = grid_beam(10, 6, 5, torch.float64, dev)
        config = dataclasses.replace(config, outer_steps=3,
                                     coarse_refresh_every=2)
        out[dev] = run_steps(mesh, config, state, cs, 3, plan)
    log(f"  E {mesh.nelem} nv {mesh.nv} aggregates {cs.naggr} block "
        f"{cs.grid[1]}")
    for k, (g, c) in enumerate(zip(out["cuda"], out["cpu"])):
        scale = c.x.abs().max().item()
        err = (g.x.cpu() - c.x).abs().max().item()
        cg_g = g.stats.solver_iters.tolist()
        cg_c = c.stats.solver_iters.tolist()
        log(f"  step {k}: max |x_card - x_cpu| {err:.3e} (scale {scale:.3f}), "
            f"CG card {cg_g} cpu {cg_c}, alpha card {g.stats.alpha.tolist()} "
            f"cpu {c.stats.alpha.tolist()}")
        if not err <= 1e-9 * scale:
            raise AssertionError("the card's grid trajectory leaves the CPU's")
        if cg_g != cg_c or g.stats.iterations != c.stats.iterations:
            raise AssertionError("CG or Newton counts differ")


# ---------------------------------------------------------------------------
# phases 6 and 7: the scene path
# ---------------------------------------------------------------------------

def write_scene(d, nx, ny, nz, newton, seed):
    """The bench's beam, box (4, 1, 1), with its vertex ids in a seeded
    random order (as a mesher's file looks to the loader), as beam.mesh and
    a scene JSON in the reference vocabulary in directory `d`."""
    from mixedfem_tpu_torch.io import mesh_io
    from mixedfem_tpu_torch.mesh import generators

    V, T = generators.box_tet_mesh(nx, ny, nz, size=(4.0, 1.0, 1.0))
    perm = np.random.default_rng(seed).permutation(len(V))
    inv = np.empty_like(perm)
    inv[perm] = np.arange(len(perm))
    mesh_io.write_mesh(os.path.join(d, "beam.mesh"), V[perm], inv[T])
    scene = {
        "time_integrator": "BDF1", "dt": 0.02,
        "max_newton_iterations": newton, "iterative_solver_tolerance": 1e-4,
        "mixed_variables": ["mixed-stretch"],
        "material_models": [{
            "energy": "Stable-Neohookean", "youngs_modulus": 1e6,
            "poissons_ratio": 0.45, "density": 1000.0,
        }],
        "objects": [{
            "path": "beam.mesh", "normalize": False,
            "boundary_condition": {"type": "twist", "ratio": 0.1, "axis": 0},
        }],
    }
    path = os.path.join(d, "scene.json")
    with open(path, "w") as f:
        json.dump(scene, f)
    return path


def scene_main_path(sim):
    """One warm-up Simulation.step and three timed ones; launch counts over
    the four steps."""
    from mixedfem_tpu_torch import cuda

    x0 = sim.state.x.clone()
    cuda.clear_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sim.step()
    torch.cuda.synchronize()
    log(f"  warm-up step {(time.perf_counter() - t0) * 1e3:.1f} ms: "
        f"{describe(sim.state)}")
    check_energies(sim.state)
    states, times = [], []
    for _ in range(3):
        t0 = time.perf_counter()
        sim.step()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        states.append(sim.state)
    launches = dict(cuda.LAUNCHES)
    for k, (st, ms) in enumerate(zip(states, times)):
        log(f"  step {k + 1}: {ms:.3f} ms, {describe(st)}")
        check_energies(st)
    newton_its = sum(st.stats.iterations for st in states)
    cg = sum(sum(st.stats.solver_iters[:st.stats.iterations].tolist())
             for st in states)
    step_ms = sum(times) / 3
    log(f"  ms_per_step {step_ms:.3f} (3 timed steps), ms per Newton "
        f"iteration {sum(times) / newton_its:.3f}, CG iterations per Newton "
        f"{cg / newton_its:.2f}, launches over 4 steps {launches}")
    x = sim.state.x
    if x.shape != (sim.mesh.nv, 3) or not torch.isfinite(x).all():
        raise AssertionError("the scene step produced non-finite positions")
    pinned = sim.mesh.free_mask == 0
    moved = (x - x0)[pinned].abs().max().item()
    log(f"  the twisted ends moved {moved:.4e}")
    if not moved > 1e-3:
        raise AssertionError("the twist BC did not move the pinned ends")
    return step_ms, launches


def scene_trajectory(path, dim=3):
    """3 float64 steps of the scene at `path` (of 2000 elements or more) on
    the card (K4 over the banded plan) and on the CPU (the same objects
    moved there: the plain versions over the same element order and
    plan)."""
    from mixedfem_tpu_torch.device import to_device
    from mixedfem_tpu_torch.io.scene import load_scene

    card = load_scene(path, dim=dim, dtype="float64", device="cuda")
    if card.matvec_plan is None or card.coarse is None:
        raise AssertionError("a 2000-element scene loads without the banded plan")
    cpu = to_device(card, "cpu")
    log(f"  E {card.mesh.nelem} nv {card.mesh.nv} W {card.matvec_plan.W}")
    for k in range(3):
        g, c = card.step(), cpu.step()
        scale = c.x.abs().max().item()
        err = (g.x.cpu() - c.x).abs().max().item()
        cg_g = g.stats.solver_iters.tolist()
        cg_c = c.stats.solver_iters.tolist()
        log(f"  step {k}: max |x_card - x_cpu| {err:.3e} (scale {scale:.3f}), "
            f"CG card {cg_g} cpu {cg_c}")
        if not err <= 1e-9 * scale:
            raise AssertionError("the card's scene trajectory leaves the CPU's")
        if cg_g != cg_c or g.stats.iterations != c.stats.iterations:
            raise AssertionError("CG or Newton counts differ")


# ---------------------------------------------------------------------------
# phases 11 and 12: the contact scene
# ---------------------------------------------------------------------------

CONTACT_DHAT = 1e-2
SNH_04 = {"energy": "Stable-Neohookean", "youngs_modulus": 1e6,
          "poissons_ratio": 0.4, "density": 1000.0}


def write_contact_scene(d):
    """Phase 11's slab and box as slab.mesh, box.mesh and a scene JSON
    without mixed_variables in directory `d`."""
    from mixedfem_tpu_torch.io import mesh_io
    from mixedfem_tpu_torch.mesh import generators

    Vs, Ts = generators.box_tet_mesh(60, 4, 60, size=(2.0, 0.1, 2.0))
    Vb, Tb = generators.box_tet_mesh(16, 16, 16, size=(0.5, 0.5, 0.5))
    mesh_io.write_mesh(os.path.join(d, "slab.mesh"), Vs, Ts)
    mesh_io.write_mesh(os.path.join(d, "box.mesh"), Vb, Tb)
    scene = {
        "time_integrator": "BDF1", "dt": 0.01, "enable_ccd": True,
        "dhat": CONTACT_DHAT, "kappa": 1e5, "max_newton_iterations": 5,
        "material_models": [SNH_04],
        "objects": [
            {"path": "slab.mesh", "normalize": False,
             "boundary_condition": {"type": "hangends", "axis": 0}},
            {"path": "box.mesh", "normalize": False,
             "offset": [0.75, 0.1 + 0.5 * CONTACT_DHAT, 0.75]},
        ],
    }
    path = os.path.join(d, "contact.json")
    with open(path, "w") as f:
        json.dump(scene, f)
    return path


def write_drop_scene(d, dhat=3e-2):
    """The drop scene of tests/test_collision.py (drop_scene): a slab
    box_tet_mesh(2, 1, 2) over (1, 0.25, 1), pinned whole (hangends along
    y with ratio 2), and a box_tet_mesh(2, 1, 2) over (0.4, 0.2, 0.4) at
    (0.3, 0.27, 0.3); float64 contact at `dhat`, 3 Newton iterations."""
    from mixedfem_tpu_torch.io import mesh_io
    from mixedfem_tpu_torch.mesh import generators

    V1, T1 = generators.box_tet_mesh(2, 1, 2, size=(1.0, 0.25, 1.0))
    V2, T2 = generators.box_tet_mesh(2, 1, 2, size=(0.4, 0.2, 0.4))
    mesh_io.write_mesh(os.path.join(d, "slab.mesh"), V1, T1)
    mesh_io.write_mesh(os.path.join(d, "box.mesh"), V2, T2)
    scene = {
        "dt": 0.01, "enable_ccd": True, "dhat": dhat, "kappa": 1e5,
        "max_newton_iterations": 3, "iterative_solver_tolerance": 1e-8,
        "material_models": [SNH_04],
        "objects": [
            {"path": "slab.mesh", "normalize": False, "boundary_condition":
             {"type": "hangends", "axis": 1, "ratio": 2.0}},
            {"path": "box.mesh", "normalize": False,
             "offset": [0.3, 0.27, 0.3]},
        ],
    }
    path = os.path.join(d, "drop.json")
    with open(path, "w") as f:
        json.dump(scene, f)
    return path


def first_contact_pairs(sim):
    """The coarse contact pair plan of the scene's first coarse refresh:
    the frames active at the initial positions (optimizer/newton.py)."""
    from mixedfem_tpu_torch.solvers import coarse as coarsemod
    from mixedfem_tpu_torch.variables import mixed_collision as mc

    cf, x, c = sim.state.contact, sim.state.x, sim.config
    z = x.new_zeros((cf.nreal,))
    cc0 = mc.update(sim.mesh, cf, x, z, z, z, c.dhat, c.kappa)
    act = torch.nonzero(cc0.active).squeeze(1)
    return coarsemod.contact_pairs(sim.coarse, cf.frames[act].cpu().numpy(),
                                   x.device)


def contact_k2_cases(cf, pairs):
    """K2 over the contact frame plan of candidate set `cf` (m=3, 9) and
    the coarse contact pair plan `pairs` (m=36), on seeded rows of those
    shapes."""
    from mixedfem_tpu_torch.ops import assembly

    g = torch.Generator(device="cuda").manual_seed(1)

    def case(m, label, plan):
        rows = torch.randn((plan.nrows, m), generator=g, device="cuda")
        seg = torch.empty(plan.nrows, dtype=torch.int64, device="cuda")
        seg[plan.slots.long()] = plan.seg
        base = torch.zeros((plan.nseg, m), device="cuda")
        ins = (plan.row_ptr, plan.slots, rows)
        return dict(
            name=f"segment_sum_m{m}", label=label,
            replaces="mixedfem_tpu/ops/brick.py:442",
            kernel=k2, plain=assembly.segment_sum_plain,
            library=lambda pl, r: torch.index_add(base, 0, seg, r),
            make=lambda: (clone(plan), rows.clone()),
            bytes=nbytes(*ins) + plan.nseg * m * rows.element_size(),
            flops=rows.numel(), npieces=plan.npieces,
        )

    return [case(3, "contact frames", cf.plan),
            case(9, "contact frames", cf.plan),
            case(36, "contact pairs", pairs.plan)]


def contact_main_path(sim):
    """One warm-up Simulation.step and three timed ones of the contact
    scene; the broadphase's host time is read around each candidate
    build. Launch counts over the four steps."""
    from mixedfem_tpu_torch import cuda

    build = sim._update_contact_candidates
    builds = []

    def timed_build(*a, **k):
        t0 = time.perf_counter()
        out = build(*a, **k)
        builds.append((len(times), time.perf_counter() - t0))
        return out

    sim._update_contact_candidates = timed_build
    times, states, cands = [], [], []
    cuda.clear_launches()
    torch.cuda.synchronize()
    for k in range(4):
        t0 = time.perf_counter()
        sim.step()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        states.append(sim.state)
        cands.append(sim.state.contact.nreal)
    launches = dict(cuda.LAUNCHES)
    del sim._update_contact_candidates
    bp_ms = [1e3 * sum(t for i, t in builds if i == k) for k in range(4)]
    for k, (st, ms) in enumerate(zip(states, times)):
        it = st.stats.iterations
        log(f"  {'warm-up step' if k == 0 else f'step {k}'}: {ms:.3f} ms "
            f"(broadphase {bp_ms[k]:.3f} ms), candidates {cands[k]}, active "
            f"frames {st.stats.active_frames[:it].tolist()}, min mixed "
            f"distance {st.stats.min_distance[:it].min().item():.6e}, "
            f"{describe(st)}")
        check_energies(st)
    timed = states[1:]
    newton_its = sum(st.stats.iterations for st in timed)
    cg = sum(sum(st.stats.solver_iters[:st.stats.iterations].tolist())
             for st in timed)
    step_ms = sum(times[1:]) / 3
    dmin = min(st.stats.min_distance[:st.stats.iterations].min().item()
               for st in states)
    active = max(int(st.stats.active_frames[:st.stats.iterations].max())
                 for st in states)
    log(f"  ms_per_step {step_ms:.3f} (3 timed steps), ms per Newton "
        f"iteration {sum(times[1:]) / newton_its:.3f}, CG iterations per "
        f"Newton {cg / newton_its:.2f}, broadphase ms per step "
        f"{sum(bp_ms[1:]) / 3:.3f}, retries {sim.retries}, min mixed "
        f"distance {dmin:.6e}, most active frames {active}, launches over "
        f"4 steps {launches}")
    x = sim.state.x
    if x.shape != (sim.mesh.nv, sim.mesh.dim) or not torch.isfinite(x).all():
        raise AssertionError("the contact step produced non-finite positions")
    if not (active > 0 and 0 < dmin < math.inf):
        raise AssertionError(f"no feasible contact: {active} active frames, "
                             f"min mixed distance {dmin}")
    return step_ms, launches, step_figures(timed, times[1:])


def contact_trajectory(path, dim=3):
    """3 float64 steps of the drop scene at `path` on the card and on the
    CPU (the same loaded objects moved there)."""
    from mixedfem_tpu_torch.device import to_device
    from mixedfem_tpu_torch.io.scene import load_scene

    card = load_scene(path, dim=dim, dtype="float64", device="cuda")
    cpu = to_device(card, "cpu")
    log(f"  E {card.mesh.nelem} nv {card.mesh.nv} variables "
        f"{card.config.mixed_variables}")
    for k in range(3):
        g, c = card.step(), cpu.step()
        scale = c.x.abs().max().item()
        err = (g.x.cpu() - c.x).abs().max().item()
        it = c.stats.iterations
        counts = {dev: (st.stats.iterations, st.stats.solver_iters.tolist(),
                        st.stats.active_frames.tolist())
                  for dev, st in (("card", g), ("cpu", c))}
        log(f"  step {k}: max |x_card - x_cpu| {err:.3e} (scale {scale:.3f}), "
            f"candidates {c.contact.nreal}, (newton, CG, active) card "
            f"{counts['card']} cpu {counts['cpu']}, alpha {c.stats.alpha.tolist()}")
        if not err <= 1e-9 * scale:
            raise AssertionError("the card's contact trajectory leaves the CPU's")
        if counts["card"] != counts["cpu"]:
            raise AssertionError("Newton, CG or active-frame counts differ")
        if not int(c.stats.active_frames[:it].max()) > 0:
            raise AssertionError("the drop scene has no active contact")


# ---------------------------------------------------------------------------
# phases 13-16: the 2D paths (linear triangles)
# ---------------------------------------------------------------------------

def tri_beam(nx, ny, dtype, device):
    """The bench beam's 2D counterpart on the port: grid_tri_mesh(nx, ny)
    over (4, 1) in banded element order, x=0 edge pinned, gravity; SNH
    (E=1e6, nu=0.45, rho=1000), BDF1, h=0.02, 5 Newton iterations, itr_tol
    1e-4, two-level coarse space of target size 48 refreshed every 10
    steps. Mesh, config, initial state, coarse space."""
    from mixedfem_tpu_torch.mesh import generators
    from mixedfem_tpu_torch.solvers import coarse as coarsemod
    from mixedfem_tpu_torch.solvers.operator import sort_elements_banded

    V, T = generators.grid_tri_mesh(nx, ny, size=(4.0, 1.0))
    T = T[sort_elements_banded(T)]
    mesh, config, state = _sim(V, T, dtype, device)
    cs = coarsemod.build_coarse_space(
        V, T, V[:, 0] < 1e-9, target_size=48, dtype=dtype, device=device
    )
    return mesh, config, state, cs


def write_tri_scene(d, objects, **extra):
    """A 2D scene in directory `d`: each of `objects` is (name, (V, T),
    scene object dict), the mesh written as <name>.obj; the JSON (SNH
    E=1e6, nu=0.4, dt 0.01, and the keys `extra`) as scene2d.json, whose
    path is returned."""
    from mixedfem_tpu_torch.io import mesh_io

    objs = []
    for name, (V, T), obj in objects:
        mesh_io.write_obj(os.path.join(d, f"{name}.obj"), V, T)
        objs.append(dict(obj, path=f"{name}.obj"))
    scene = {"dt": 0.01, "material_models": [SNH_04], "objects": objs}
    scene.update(extra)
    path = os.path.join(d, "scene2d.json")
    with open(path, "w") as f:
        json.dump(scene, f)
    return path


def write_tri_contact_scene(d):
    """Phase 15's slab grid_tri_mesh(500, 40) over (2.0, 0.1), held at its
    far x end by a hangends BC, and a free box grid_tri_mesh(175, 175) over
    (0.5, 0.5) whose bottom lies half of dhat above it (101,250 triangles,
    51,517 vertices), as .obj files and a scene JSON without
    mixed_variables (the loader's default adds mixed-collision): gravity,
    BDF1, CCD, dhat 1e-2, kappa 1e5, 5 Newton iterations, pcg with the
    two-level coarse space."""
    from mixedfem_tpu_torch.mesh import generators

    return write_tri_scene(
        d,
        [("slab", generators.grid_tri_mesh(500, 40, size=(2.0, 0.1)),
          {"normalize": False,
           "boundary_condition": {"type": "hangends", "axis": 0}}),
         ("box", generators.grid_tri_mesh(175, 175, size=(0.5, 0.5)),
          {"normalize": False,
           "offset": [0.75, 0.1 + 0.5 * CONTACT_DHAT, 0.0]})],
        time_integrator="BDF1", enable_ccd=True, dhat=CONTACT_DHAT,
        kappa=1e5, max_newton_iterations=5)


def write_tri_two_objects(d):
    """A 2D scene of 2,000 triangles without contact (mixed_variables
    mixed-stretch only), so that load_scene builds the banded plan and the
    coarse space: a beam grid_tri_mesh(40, 10) over (2, 0.5) twisted (in
    the plane) by a scripted BC, and a block grid_tri_mesh(30, 20) over
    (0.6, 0.4) below it, pinned at its far x end; 3 Newton iterations.
    Both start moving down at 1 m/s: from rest, the first step's third
    Newton iteration sits on the rounding floor (decrement 1e-7), where a
    CG count depends on the order of a reduction."""
    from mixedfem_tpu_torch.mesh import generators

    down = [0.0, -1.0, 0.0]
    return write_tri_scene(
        d,
        [("beam", generators.grid_tri_mesh(40, 10, size=(2.0, 0.5)),
          {"normalize": False, "initial_velocity": down,
           "boundary_condition":
           {"type": "twist", "ratio": 0.1, "axis": 0, "velocity": 0.5}}),
         ("block", generators.grid_tri_mesh(30, 20, size=(0.6, 0.4)),
          {"normalize": False, "offset": [0.5, -1.0, 0.0],
           "initial_velocity": down,
           "boundary_condition": {"type": "hangends", "axis": 0}})],
        dt=0.02, max_newton_iterations=3, mixed_variables=["mixed-stretch"])


def write_tri_drop_scene(d, dhat=3e-2):
    """The 2D drop scene of tests/test_collision.py (drop_scene(dim=2)): a
    slab grid_tri_mesh(4, 1) over (1, 0.2), pinned whole (hangends along y
    with ratio 2), and a box grid_tri_mesh(2, 1) over (0.3, 0.15) at
    (0.35, 0.23); float64 contact at `dhat`, 3 Newton iterations."""
    from mixedfem_tpu_torch.mesh import generators

    return write_tri_scene(
        d,
        [("slab", generators.grid_tri_mesh(4, 1, size=(1.0, 0.2)),
          {"normalize": False, "boundary_condition":
           {"type": "hangends", "axis": 1, "ratio": 2.0}}),
         ("box", generators.grid_tri_mesh(2, 1, size=(0.3, 0.15)),
          {"normalize": False, "offset": [0.35, 0.23, 0.0]})],
        enable_ccd=True, dhat=dhat, kappa=1e5, max_newton_iterations=3,
        iterative_solver_tolerance=1e-8)


def tri_trajectory():
    """3 float64 steps of a 1000-triangle cantilever (grid_tri_mesh(50,
    10)) on the card and on the CPU, swinging from the start (v_y = -2 x /
    4, so that no Newton iteration of the three sits on the rounding
    floor), with the coarse space refreshed every 2nd step."""
    import dataclasses

    from mixedfem_tpu_torch.optimizer import newton

    out = {}
    for dev in ("cuda", "cpu"):
        mesh, config, state, cs = tri_beam(50, 10, torch.float64, dev)
        config = dataclasses.replace(config, outer_steps=3,
                                     coarse_refresh_every=2)
        v0 = torch.zeros_like(state.x)
        v0[:, 1] = -2.0 * mesh.V0[:, 0] / 4.0
        state = newton.init_state(mesh, config, (), state.x, v0)
        out[dev] = run_steps(mesh, config, state, cs, 3)
    log(f"  E {mesh.nelem} nv {mesh.nv} aggregates {cs.naggr}")
    for k, (g, c) in enumerate(zip(out["cuda"], out["cpu"])):
        scale = c.x.abs().max().item()
        err = (g.x.cpu() - c.x).abs().max().item()
        cg_g = g.stats.solver_iters.tolist()
        cg_c = c.stats.solver_iters.tolist()
        log(f"  step {k}: max |x_card - x_cpu| {err:.3e} (scale {scale:.3f}), "
            f"CG card {cg_g} cpu {cg_c}, alpha card {g.stats.alpha.tolist()} "
            f"cpu {c.stats.alpha.tolist()}")
        if not err <= 1e-9 * scale:
            raise AssertionError("the card's 2D trajectory leaves the CPU's")
        if cg_g != cg_c or g.stats.iterations != c.stats.iterations:
            raise AssertionError("CG or Newton counts differ")


# ---------------------------------------------------------------------------
# phases 17 and 18: the solver family
# ---------------------------------------------------------------------------

# phase 18's float64 steps, card against CPU, of each name (3 until the
# script neared its time limit, then 2 until phases 24-25 were added; the
# CPU's steps take most of the phase)
PHASE18_STEPS = 1
# phase 17's beam solvers, one timed step each of PHASE17_NEWTON Newton
# iterations (the beam's 5 cut to keep the script inside its time: every
# one of these paths is host-bound, most at the 500-iteration cap, so a
# step's time is its Newton count times a Newton iteration's), ADMM's of
# ADMM_NEWTON (about 27 s a Newton iteration at 500 sweeps)
BEAM_SOLVERS = ("minres-kkt", "dual-cg", "pcg-laplacian", "pcg-diag",
                "gauss-seidel", "admm", "minres-kkt-admm")
PHASE17_NEWTON = 2
ADMM_NEWTON = 1
# the paths whose step builds the Laplacian preconditioner's rows on K3
LAPLACIAN_SOLVERS = ("pcg-laplacian", "pcg-dualascent",
                     "eigen-pcg-dualascent")


def count_laplacian_k3():
    """Wrap solvers/laplacian.py:laplacian_rows (the step looks it up at
    each call) so that K3's launches made inside it are counted: a dict
    whose "n" the caller sets to 0 and reads, and the function that undoes
    the wrap."""
    from mixedfem_tpu_torch import cuda
    from mixedfem_tpu_torch.solvers import laplacian as lapmod

    orig = lapmod.laplacian_rows
    counts = {"n": 0}

    def rows(mesh):
        before = cuda.LAUNCHES["contract_G_Gw"]
        out = orig(mesh)
        counts["n"] += cuda.LAUNCHES["contract_G_Gw"] - before
        return out

    lapmod.laplacian_rows = rows
    return counts, lambda: setattr(lapmod, "laplacian_rows", orig)


def check_laplacian_k3(name, result, counts):
    """Record the Laplacian rows' K3 launches of one solver's run; a
    Laplacian path must have launched K3 there."""
    result["laplacian_rows_k3"] = counts["n"]
    if name in LAPLACIAN_SOLVERS:
        log(f"  {name}: K3 launches in the Laplacian rows {counts['n']}")
        if counts["n"] == 0:
            raise AssertionError(f"{name}: the Laplacian rows did not run "
                                 "on K3")
CONTACT_SOLVERS = ("eigen-pcg-dualascent", "minres-indefinite-block")
# the kernels that must launch on each beam solver's run, beside K2 and K3
NEEDS_K1 = ("pcg-laplacian", "pcg-diag", "gauss-seidel")
# card against CPU: the Krylov counts of these paths are decided by
# rounding (tests/solver_parity.py): 2% on the beam, 10% with contact
KRYLOV_BAND = 0.02
CONTACT_BAND = 0.1


def kernel_counts(launches) -> dict:
    """The launch counts of K1-K4 (each instance and width summed)."""
    out = {"K1": 0, "K2": 0, "K3": 0, "K4": 0}
    for k, n in launches.items():
        key = ("K1" if k.startswith("element_apply")
               else "K2" if k.startswith("segment_sum")
               else "K3" if k.startswith("contract_G_Gw")
               else "K4" if k.startswith("banded_sum") else None)
        if key:
            out[key] += n
    return out


def solver_report(name, states, times, launches, warm):
    """Log one solver's run: ms per step and per Newton iteration, solver
    iterations per Newton, the last decrement and the launch counts; check
    finite positions and decreasing energies. `states`/`times` are the
    timed steps; `warm` says whether a warm-up step ran before them."""
    newton_its = sum(st.stats.iterations for st in states)
    solver_its = sum(sum(st.stats.solver_iters[:st.stats.iterations].tolist())
                     for st in states)
    last = states[-1]
    dec = (float(last.stats.decrement[last.stats.iterations - 1])
           if last.stats.iterations else None)
    counts = kernel_counts(launches)
    for k, (st, ms) in enumerate(zip(states, times)):
        log(f"  {name} step {k + 1}: {ms:.3f} ms, {describe(st)}")
        if st.stats.iterations:
            check_energies(st)
        if not torch.isfinite(st.x).all():
            raise AssertionError(f"{name}: non-finite positions")
    per = (lambda v: v / newton_its) if newton_its else (lambda v: None)
    decs = [d for st in states
            for d in st.stats.decrement[:st.stats.iterations].tolist() if d > 0]
    out = dict(ms_per_step=sum(times) / len(times),
               ms_per_newton=per(sum(times)),
               solver_iters_per_newton=per(solver_its),
               last_decrement=dec, least_decrement=min(decs, default=None),
               timed_steps=len(times), warm_up=warm, launches=counts)
    log(f"  {name}: ms_per_step {out['ms_per_step']:.3f}, ms per Newton "
        f"iteration {out['ms_per_newton']}, solver iterations per Newton "
        f"{out['solver_iters_per_newton']}, last decrement {dec}, launches "
        f"over {len(times) + warm} steps {counts}")
    return out


def solver_family_beam(mesh, config, state):
    """Phase 17's beam: each solver of BEAM_SOLVERS through newton_step
    with no coarse space, one step from the same initial state; counters
    set to 0 just before each solver's run and read just after."""
    import dataclasses

    from mixedfem_tpu_torch import cuda
    from mixedfem_tpu_torch.optimizer import newton
    from mixedfem_tpu_torch.solvers import gauss_seidel as gsmod

    t0 = time.perf_counter()
    gs_plan = gsmod.build_gs_plan(mesh.T.cpu().numpy(), mesh.nv,
                                  dtype=mesh.vols.dtype, device="cuda")
    log(f"  vertex coloring: {gs_plan.ncolors} colors in "
        f"{time.perf_counter() - t0:.1f} s (host)")
    results = {}
    lap_k3, unwrap = count_laplacian_k3()
    for name in BEAM_SOLVERS:
        cfg = dataclasses.replace(
            config, solver=name,
            outer_steps=ADMM_NEWTON if name == "admm" else PHASE17_NEWTON)
        cuda.clear_launches()
        lap_k3["n"] = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st = newton.newton_step(mesh, cfg, (), state, gs_plan=gs_plan)
        torch.cuda.synchronize()
        times = [(time.perf_counter() - t0) * 1e3]
        launches = dict(cuda.LAUNCHES)
        results[name] = solver_report(name, [st], times, launches, False)
        results[name]["launches_by_kernel"] = launches
        check_laplacian_k3(name, results[name], lap_k3)
        c = results[name]["launches"]
        missing = [k for k in ("K2", "K3") + (("K1",) if name in NEEDS_K1
                                              else ()) if c[k] == 0]
        if missing:
            raise AssertionError(f"{name}: kernels not launched: {missing}")
    unwrap()
    return results


def solver_family_contact(path):
    """Phase 17's contact scene with each of CONTACT_SOLVERS through
    load_scene and Simulation.step: one step, counters set to 0 just
    before and read just after; the least mixed distance must be > 0."""
    from mixedfem_tpu_torch import cuda
    from mixedfem_tpu_torch.io.scene import load_scene

    results = {}
    lap_k3, unwrap = count_laplacian_k3()
    for name in CONTACT_SOLVERS:
        sim = load_scene(path, dim=3, dtype="float32", device="cuda",
                         overrides={"linear_solver": name})
        states, times = [], []
        cuda.clear_launches()
        lap_k3["n"] = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sim.step()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        states.append(sim.state)
        launches = dict(cuda.LAUNCHES)
        r = solver_report(name, states, times, launches, False)
        ran = [st for st in states if st.stats.iterations]
        dmin = min((st.stats.min_distance[:st.stats.iterations].min().item()
                    for st in ran), default=math.inf)
        active = max((int(st.stats.active_frames[:st.stats.iterations].max())
                      for st in ran), default=0)
        log(f"  {name}: candidates {sim.state.contact.nreal}, most active "
            f"frames {active}, min mixed distance {dmin:.6e}, retries "
            f"{sim.retries}, steps kept {len(ran)} of 1")
        if name == "eigen-pcg-dualascent" and not ran:
            # every attempt of the step moved past its candidate margin
            # and Simulation.step handed back the pre-step state: the
            # dual-ascent loop, as the JAX package writes it, grows
            # geometrically on this scene (PERF.md, PR 9)
            log(f"  {name}: no step kept (4 attempts each); the pre-step "
                f"state stands")
        elif not (active > 0 and 0 < dmin < math.inf):
            raise AssertionError(f"{name}: no feasible contact ({active} "
                                 f"active frames, min distance {dmin})")
        c = r["launches"]
        if c["K2"] == 0 or c["K3"] == 0:
            raise AssertionError(f"{name}: K2 or K3 not launched: {c}")
        r.update(launches_by_kernel=launches, retries=sim.retries,
                 steps_kept=len(ran), active_frames=active,
                 min_mixed_distance=dmin if ran else None)
        check_laplacian_k3(name, r, lap_k3)
        results[name] = r
        del sim
    unwrap()
    return results


def band_ok(a, b, frac) -> bool:
    """Equal counts, or within frac of the larger (at least 1)."""
    return all(x == y or (frac and abs(x - y) <= max(1, math.ceil(frac * max(x, y))))
               for x, y in zip(a, b))


def solver_trajectories():
    """Phase 18: every new beam solver on a 1000-tet beam for
    PHASE18_STEPS float64 steps of 3 Newton iterations, on the card and on
    the CPU (the same
    start; the Laplacian's power-iteration start drawn on the CPU for
    both)."""
    import dataclasses

    from mixedfem_tpu_torch.optimizer import newton
    from mixedfem_tpu_torch.solvers import gauss_seidel as gsmod

    names = ("pcg-diag", "pcg-laplacian", "pcg-dualascent", "gauss-seidel",
             "minres-kkt", "minres-kkt-admm", "dual-cg", "admm")
    built = {dev: beam(10, 5, 4, torch.float64, dev) for dev in ("cuda", "cpu")}
    for name in names:
        out = {}
        for dev, (mesh, config, state, _) in built.items():
            cfg = dataclasses.replace(config, outer_steps=3, solver=name)
            gs = gsmod.build_gs_plan(mesh.T.cpu().numpy(), mesh.nv,
                                     dtype=torch.float64, device=dev)
            st, out[dev] = state, []
            for _ in range(PHASE18_STEPS):
                st = newton.newton_step(mesh, cfg, (), st, gs_plan=gs)
                out[dev].append(st)
        exact = name in ("gauss-seidel", "admm")
        for k, (g, c) in enumerate(zip(out["cuda"], out["cpu"])):
            scale = c.x.abs().max().item()
            err = (g.x.cpu() - c.x).abs().max().item()
            ng, nc = g.stats.solver_iters.tolist(), c.stats.solver_iters.tolist()
            log(f"  {name} step {k}: max |x_card - x_cpu| {err:.3e} (scale "
                f"{scale:.3f}), solver iterations card {ng} cpu {nc}")
            if not err <= 1e-9 * scale:
                raise AssertionError(f"{name}: the card leaves the CPU")
            if g.stats.iterations != c.stats.iterations or not band_ok(
                    ng, nc, 0.0 if exact else KRYLOV_BAND):
                raise AssertionError(f"{name}: Newton or solver counts differ")


def solver_contact_trajectories(path):
    """Phase 18 with contact: the drop scene with each contact solver
    (ADMM capped at 40 sweeps a Newton iteration), PHASE18_STEPS float64
    steps on the card and on the CPU (the same loaded objects moved
    there)."""
    from mixedfem_tpu_torch.device import to_device
    from mixedfem_tpu_torch.io.scene import load_scene

    for name, over in (("eigen-pcg-dualascent", {}),
                       ("minres-indefinite-block", {}), ("subspace-CG", {}),
                       ("admm-solver", {"max_iterative_solver_iters": 40})):
        card = load_scene(path, dim=3, dtype="float64", device="cuda",
                          overrides=dict(over, linear_solver=name))
        cpu = to_device(card, "cpu")
        for k in range(PHASE18_STEPS):
            g, c = card.step(), cpu.step()
            scale = c.x.abs().max().item()
            err = (g.x.cpu() - c.x).abs().max().item()
            ng, nc = g.stats.solver_iters.tolist(), c.stats.solver_iters.tolist()
            ag, ac = g.stats.active_frames.tolist(), c.stats.active_frames.tolist()
            log(f"  {name} step {k}: max |x_card - x_cpu| {err:.3e} (scale "
                f"{scale:.3f}), solver iterations card {ng} cpu {nc}, active "
                f"frames card {ag} cpu {ac}")
            if not err <= 1e-9 * scale:
                raise AssertionError(f"{name}: the card leaves the CPU")
            if (g.stats.iterations != c.stats.iterations or ag != ac
                    or not band_ok(ng, nc, 0.0 if name == "admm-solver"
                                   else CONTACT_BAND)):
                raise AssertionError(f"{name}: Newton, solver or active-frame "
                                     f"counts differ")


# ---------------------------------------------------------------------------
# phases 19 and 20: the host solve paths and the vanilla stretch variable
# ---------------------------------------------------------------------------

def host_report(name, states, times, launches, host_ms, newton_its, system):
    """Log one host-path case: ms per step and per Newton iteration, host
    ms per Newton iteration by stage, linear iterations per Newton, the
    system's size, the K1-K4 launches; check finite positions and
    decreasing energies. `newton_its` counts every step run (warm-up
    included), as `host_ms` and `launches` do."""
    timed_its = sum(st.stats.iterations for st in states)
    lin = sum(sum(st.stats.solver_iters[:st.stats.iterations].tolist())
              for st in states)
    for k, (st, ms) in enumerate(zip(states, times)):
        log(f"  {name} step {k + 1}: {ms:.3f} ms, {describe(st)}")
        check_energies(st)
        if not torch.isfinite(st.x).all():
            raise AssertionError(f"{name}: non-finite positions")
    out = dict(ms_per_step=sum(times) / len(times),
               ms_per_newton=sum(times) / timed_its,
               linear_iters_per_newton=lin / timed_its,
               host_ms_per_newton={k: v / newton_its
                                   for k, v in sorted(host_ms.items())},
               timed_steps=len(times), launches=kernel_counts(launches),
               **system)
    log(f"  {name}: ms_per_step {out['ms_per_step']:.3f}, ms per Newton "
        f"iteration {out['ms_per_newton']:.3f}, linear iterations per Newton "
        f"{out['linear_iters_per_newton']:.2f}, host ms per Newton "
        f"{ {k: round(v, 3) for k, v in out['host_ms_per_newton'].items()} }, "
        f"system {system}, launches {out['launches']}")
    return out


def _timed_steps(step, warm, timed):
    """Run `warm` untimed and `timed` timed steps (step() returns the
    state) with the launch counters and the host stage times set to 0
    just before and read just after: (states, times, launches, host_ms,
    Newton iterations of every step)."""
    from mixedfem_tpu_torch import cuda
    from mixedfem_tpu_torch.optimizer import newton_direct

    cuda.clear_launches()
    newton_direct.HOST_MS.clear()
    newton_direct.LAST_SYSTEM.clear()
    torch.cuda.synchronize()
    its = 0
    for _ in range(warm):
        t0 = time.perf_counter()
        st = step()
        torch.cuda.synchronize()
        its += st.stats.iterations
        log(f"  warm-up step {(time.perf_counter() - t0) * 1e3:.1f} ms: "
            f"{describe(st)}")
    states, times = [], []
    for _ in range(timed):
        t0 = time.perf_counter()
        st = step()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        states.append(st)
        its += st.stats.iterations
    return (states, times, dict(cuda.LAUNCHES),
            dict(newton_direct.HOST_MS), its)


def _system():
    from mixedfem_tpu_torch.optimizer import newton_direct

    return {k: v for k, v in newton_direct.LAST_SYSTEM.items()
            if v is not None}


def _need(name, launches, keys, absent=()):
    missing = [k for k in keys if launches.get(k, 0) == 0]
    if missing:
        raise AssertionError(f"{name}: kernels not launched: {missing}")
    ran = [k for k in absent if launches.get(k, 0)]
    if ran:
        raise AssertionError(f"{name}: kernels launched that must not: {ran}")


def host_solvers(profile_dir=None):
    """Phase 19: the vanilla stretch alone on the 100k-tet beam through
    newton_step, eigen-pcg-IC on phase 6's 100k-tet scene, eigen-llt on a
    20k-tet beam scene (mixed, then the vanilla stretch alone) and
    subspace-amgcl on a 2.5k-tet beam scene, all float32; returns the
    {"host_solvers": ...} results. With `profile_dir`, one more step of
    each case is traced (profile_step)."""
    import dataclasses

    from mixedfem_tpu_torch.io.scene import load_scene
    from mixedfem_tpu_torch.optimizer import newton

    results, seconds = {}, {}
    t_case = time.perf_counter()
    # (a) the vanilla baseline at full width: K2 at m=3 and m=9, no K3
    mesh, config, state, _ = beam(40, 25, 20, torch.float32, "cuda")
    cfg = dataclasses.replace(config, solver="pcg-block-jacobi",
                              mixed_variables=(), variables=("stretch",))
    box = [state]

    def vstep():
        box[0] = newton.newton_step(mesh, cfg, (), box[0])
        return box[0]

    run = _timed_steps(vstep, 1, 3)
    name = "vanilla pcg-block-jacobi 100k"
    _need(name, run[2], ("segment_sum_m3", "segment_sum_m9"),
          absent=("contract_G_Gw", "element_apply"))
    results[name] = host_report(name, *run[:4], run[4], {})
    results[name]["launches_by_kernel"] = run[2]
    if profile_dir:
        profile_step(vstep, profile_dir, "host_a_vanilla",
                     results[name]["ms_per_step"])
    del mesh, state, box
    seconds["a"] = time.perf_counter() - t_case

    scenes = (
        # (case, name, (nx, ny, nz), Newton iterations, overrides,
        #  warm-up steps, timed steps)
        ("b", "eigen-pcg-IC 100k", (40, 25, 20), 5,
         {"linear_solver": "eigen-pcg-IC"}, 0, 1),
        ("c", "eigen-llt 20k", (40, 10, 10), 3,
         {"linear_solver": "eigen-llt"}, 1, 1),
        ("c", "eigen-llt vanilla 20k", (40, 10, 10), 3,
         {"linear_solver": "eigen-llt", "variables": ["stretch"],
          "mixed_variables": []}, 0, 1),
        ("d", "subspace-amgcl 2.5k", (20, 5, 5), 3,
         {"linear_solver": "subspace-amgcl"}, 0, 1),
    )
    for case, name, cells, newton_its, over, warm, timed in scenes:
        t_case = time.perf_counter()
        with tempfile.TemporaryDirectory() as d:
            sim = load_scene(write_scene(d, *cells, newton=newton_its, seed=0),
                             dim=3, dtype="float32", device="cuda",
                             overrides=over)
        log(f"  {name}: E {sim.mesh.nelem} nv {sim.mesh.nv}, banded plan "
            f"{sim.matvec_plan is not None}, solver {sim.config.solver}, "
            f"variables {sim.config.mixed_variables + sim.config.variables}, "
            f"loaded in {time.perf_counter() - t_case:.1f} s")
        run = _timed_steps(sim.step, warm, timed)
        vanilla = "stretch" in sim.config.variables
        sums = ("banded_sum_m3",) if sim.matvec_plan is not None else (
            "segment_sum_m3",)
        _need(name, run[2], sums + (() if vanilla else ("contract_G_Gw",)),
              absent=("contract_G_Gw",) if vanilla else ())
        results[name] = host_report(name, *run[:4], run[4], _system())
        results[name]["launches_by_kernel"] = run[2]
        if profile_dir:
            slug = re.sub(r"[^a-z0-9]+", "_", name.lower()).strip("_")
            profile_step(sim.step, profile_dir, f"host_{case}_{slug}",
                         results[name]["ms_per_step"])
        del sim
        seconds[case] = seconds.get(case, 0.0) + time.perf_counter() - t_case
    log(f"  phase 19 seconds by case: "
        f"{ {k: round(v, 1) for k, v in seconds.items()} }")
    return results


def _compare(label, g, c, band=0.0, vanilla_grad=False):
    """Card state g against CPU state c: positions to 1e-9 of scale, equal
    Newton counts (and active frames), linear counts equal or within
    `band` (band_ok), the vanilla gradient norms to 1e-9 relative."""
    scale = c.x.abs().max().item()
    err = (g.x.cpu() - c.x).abs().max().item()
    ng, nc = g.stats.solver_iters.tolist(), c.stats.solver_iters.tolist()
    log(f"  {label}: max |x_card - x_cpu| {err:.3e} (scale {scale:.3f}), "
        f"Newton {g.stats.iterations}/{c.stats.iterations}, linear "
        f"iterations card {ng} cpu {nc}")
    if not err <= 1e-9 * scale:
        raise AssertionError(f"{label}: the card leaves the CPU")
    if (g.stats.iterations != c.stats.iterations
            or g.stats.active_frames.tolist() != c.stats.active_frames.tolist()
            or not band_ok(ng, nc, band)):
        raise AssertionError(f"{label}: Newton, linear or active-frame counts "
                             f"differ")
    if vanilla_grad:
        vg, vc = g.stats.vanilla_grad.cpu(), c.stats.vanilla_grad
        rel = ((vg - vc).abs().max() / vc.abs().max()).item()
        log(f"  {label}: vanilla gradient norms {vc.tolist()}, rel. err "
            f"{rel:.3e}")
        if not (rel <= 1e-9 and (vc[:c.stats.iterations] > 0).all()):
            raise AssertionError(f"{label}: vanilla gradient norms differ")


def host_trajectories():
    """Phase 20: 3 float64 steps on the card and on the CPU of the host
    paths (a 1000-tet beam scene with eigen-llt, eigen-pcg-IC and
    subspace-amgcl; the drop scene with eigen-llt, with mixed-collision
    and with the nodal collision and friction variables) and of the
    vanilla stretch on a 1000-tet beam (alone with pcg-block-jacobi and
    with eigen-llt, beside mixed-stretch with minres-kkt at 10 iterations,
    and its gradient recorded at eigen-llt's mixed iterates and at
    newton_step's block-Jacobi PCG iterates on the Fung beam)."""
    import dataclasses

    from mixedfem_tpu_torch.device import to_device
    from mixedfem_tpu_torch.io.scene import load_scene
    from mixedfem_tpu_torch.optimizer import newton, newton_direct

    with tempfile.TemporaryDirectory() as d:
        beam_scene = write_scene(d, 10, 5, 4, newton=3, seed=1)
        drop = write_drop_scene(d)
        cases = [("eigen-llt beam", beam_scene, {"linear_solver": "eigen-llt"}),
                 ("eigen-pcg-IC beam", beam_scene,
                  {"linear_solver": "eigen-pcg-IC"}),
                 ("subspace-amgcl beam", beam_scene,
                  {"linear_solver": "subspace-amgcl"}),
                 ("eigen-llt drop", drop, {"linear_solver": "eigen-llt"}),
                 ("eigen-llt drop collision+friction", drop,
                  {"linear_solver": "eigen-llt",
                   "mixed_variables": ["mixed-stretch"],
                   "variables": ["collision", "friction"]})]
        for label, path, over in cases:
            card = load_scene(path, dim=3, dtype="float64", device="cuda",
                              overrides=over)
            cpu = to_device(card, "cpu")
            for k in range(3):
                g, c = card.step(), cpu.step()
                _compare(f"{label} step {k}", g, c,
                         0.0 if over["linear_solver"] == "eigen-llt"
                         else KRYLOV_BAND)
    built = {dev: beam(10, 5, 4, torch.float64, dev) for dev in ("cuda", "cpu")}
    # (label, solver, host path, material, config, count band): MINRES
    # beside the vanilla stretch runs on the Fung beam, where a 1e-13 change
    # of the start moves its 3-step trajectory by 1.5e-10 (7e-6 with
    # Stable-Neo-Hookean, whose vanilla Hessian is indefinite there); the
    # gradient is recorded on the host path, whose counts no rounding
    # decides, and on newton_step's generic body with block-Jacobi PCG on
    # the Fung beam, its CG counts within the Krylov band (on the
    # Stable-Neo-Hookean beam the card took 80 CG iterations where the CPU
    # took 81, positions 5e-13 apart); there CG stops at 1e-8, since the
    # stiff gradient magnifies a position difference about 3e3 times and
    # at 1e-4 a CG stop that rounding decides left the devices 1.2e-11
    # apart and the recorded norms 3.3e-8 apart (2.1e-9 of the largest)
    runs = (("vanilla pcg-block-jacobi", "pcg-block-jacobi", False, None,
             dict(mixed_variables=(), variables=("stretch",)), 0.0),
            ("vanilla eigen-llt", "eigen-llt", True, None,
             dict(mixed_variables=(), variables=("stretch",)), 0.0),
            ("mixed+vanilla minres-kkt (Fung)", "minres-kkt", False, ("Fung",),
             dict(variables=("stretch",), max_iterative_solver_iters=10),
             KRYLOV_BAND),
            ("record_vanilla_gradient eigen-llt", "eigen-llt", True, None,
             dict(record_vanilla_gradient=True), 0.0),
            ("record_vanilla_gradient pcg-block-jacobi (Fung)",
             "pcg-block-jacobi", False, ("Fung",),
             dict(record_vanilla_gradient=True, itr_tol=1e-8), KRYLOV_BAND))
    for label, solver, host, models, cfg, band in runs:
        out = {}
        for dev, (mesh, config, state, _) in built.items():
            if models:
                mesh = dataclasses.replace(mesh, models=models)
            c = dataclasses.replace(config, outer_steps=3, solver=solver,
                                    mixed_variables=("mixed-stretch",))
            c = dataclasses.replace(c, **cfg)
            st, out[dev] = state, []
            for _ in range(3):
                st = (newton_direct.newton_step_direct(mesh, c, (), st) if host
                      else newton.newton_step(mesh, c, (), st))
                out[dev].append(st)
        for k, (g, c) in enumerate(zip(out["cuda"], out["cpu"])):
            _compare(f"{label} step {k}", g, c, band,
                     vanilla_grad="record" in label)


# ---------------------------------------------------------------------------
# phase 21: the lattice-resident CG; phases 22 and 23: shells and rods
# ---------------------------------------------------------------------------

# phase 21's cases on the grid: where the JAX step refuses its row body
# and solves with CG on the lattice (the port's 'lattice_cg' body)
LATTICE_CG_CASES = {
    "lattice_cg_blend_grid_coarse": dict(inertia_blend_factor=0.5),
    "lattice_cg_block_jacobi": dict(solver="pcg-block-jacobi",
                                    inertia_blend_factor=0.5),
}


def _stepper(mesh, cfg, state, coarse=None, plan=None):
    """A step() for _timed_steps: newton_step from `state` onwards."""
    from mixedfem_tpu_torch.optimizer import newton

    held = {"st": state}

    def step():
        held["st"] = newton.newton_step(mesh, cfg, (), held["st"], coarse, (),
                                        plan)
        return held["st"]

    return step


def lattice_cg_main_path():
    """Phase 21: phase 8's 100k-tet grid through the lattice-CG body, f32,
    (a) with an inertia blend of 0.5 and the grid coarse space, (b)
    pcg-block-jacobi alone with the same blend: one warm-up and three
    timed steps each, counters set to 0 just before and read just after;
    K5, K6, K3 and K2 must launch."""
    import dataclasses

    from mixedfem_tpu_torch.optimizer import newton

    mesh, config, state, cs, plan = grid_beam(40, 25, 20, torch.float32,
                                              "cuda")
    results = {}
    for name, over in LATTICE_CG_CASES.items():
        cfg = dataclasses.replace(config, **over)
        coarse = cs if cfg.solver == "pcg" else None
        body = newton._select_body(cfg, cfg.solver, coarse, plan, False, 3)
        if body != "lattice_cg":
            raise AssertionError(f"{name}: body {body}, not lattice_cg")
        states, times, launches, _, _ = _timed_steps(
            _stepper(mesh, cfg, state, coarse, plan), 1, 3)
        r = solver_report(name, states, times, launches, True)
        _need(name, launches, ("stencil_apply", "stencil_assemble",
                               "contract_G_Gw", "segment_sum_m3"))
        r.update(body=body, launches_by_kernel=launches)
        results[name] = r
    return results


def lattice_cg_trajectories():
    """Phase 21, float64: 3 steps of phase 9's 1500-tet grid (3 Newton
    iterations, coarse refresh every 2nd step) through the lattice-CG body
    on the card and on the CPU, in (a), (b) and with the vanilla gradient
    recorded (pcg, grid coarse space): positions to 1e-9 of scale, Newton
    and CG counts equal, the gradient norms to 1e-9 of the largest."""
    import dataclasses

    cases = dict(LATTICE_CG_CASES,
                 lattice_cg_recorded_gradient=dict(record_vanilla_gradient=True))
    for name, over in cases.items():
        out = {}
        for dev in ("cuda", "cpu"):
            mesh, config, state, cs, plan = grid_beam(10, 6, 5, torch.float64,
                                                      dev)
            cfg = dataclasses.replace(config, outer_steps=3,
                                      coarse_refresh_every=2, **over)
            out[dev] = run_steps(mesh, cfg, state,
                                 cs if cfg.solver == "pcg" else None, 3, plan)
        for k, (g, c) in enumerate(zip(out["cuda"], out["cpu"])):
            _compare(f"{name} step {k}", g, c,
                     vanilla_grad="recorded" in name)


def _membrane_config(dtype, **over):
    """The cloth's and the hair's step: BDF1, h = 0.01 (tests/test_shell.py
    and tests/test_rod.py), default pcg with no coarse space; in f32 5
    Newton iterations to CG 1e-4."""
    from mixedfem_tpu_torch.config import SimConfig

    kw = dict(h=0.01, outer_steps=5, newton_tol=0.0, itr_tol=1e-4,
              max_iterative_solver_iters=500,
              mixed_variables=("mixed-stretch",),
              dtype="float64" if dtype == torch.float64 else "float32")
    kw.update(over)
    return SimConfig(**kw)


def cloth(nx, ny, dtype, device, **over):
    """tests/test_shell.py:cloth at nx x ny cells: grid_tri_mesh over the
    unit square at z = 0 (2 nx ny triangles), two corners pinned, gravity
    along -z, Stable-Neo-Hookean (E = 1e5, nu = 0.40), density 100,
    thickness 1e-3: mesh, config, state at rest."""
    from mixedfem_tpu_torch.config import enu_to_lame
    from mixedfem_tpu_torch.mesh import generators
    from mixedfem_tpu_torch.mesh import mesh as meshmod
    from mixedfem_tpu_torch.optimizer import newton

    V2, T = generators.grid_tri_mesh(nx, ny, size=(1.0, 1.0))
    V = np.concatenate([V2, np.zeros((len(V2), 1))], axis=1)
    la, mu = enu_to_lame(1e5, 0.40)
    fixed = np.zeros(len(V), bool)
    fixed[np.argmin(V[:, 0] + V[:, 1])] = True
    fixed[np.argmin(-V[:, 0] + V[:, 1])] = True
    ext = np.zeros_like(V)
    ext[:, 2] = -9.8
    mesh = meshmod.build_mesh_data(
        V, T, density=np.full(len(T), 100.0), mu=np.full(len(T), mu),
        lam=np.full(len(T), la), model_id=np.zeros(len(T), int),
        models=("Stable-Neohookean",), is_fixed=fixed, ext_force=ext,
        dtype=dtype, device=device, shell=True, thickness=1e-3)
    config = _membrane_config(dtype, **over)
    x0 = mesh.V0.clone()
    return mesh, config, newton.init_state(mesh, config, (), x0,
                                           torch.zeros_like(x0))


def hair(side, segments, dtype, device, length=1.0, spacing=0.02, **over):
    """side x side strands of `segments` segments along +x, `length` long,
    their roots pinned on a grid in the y-z plane `spacing` apart, gravity
    along -y; tests/test_rod.py:chain_rod's material (ARAP, E = 1e7, nu =
    0.40, density 1000, radius 5e-3): mesh, config, state at rest."""
    from mixedfem_tpu_torch.config import enu_to_lame
    from mixedfem_tpu_torch.mesh import mesh as meshmod
    from mixedfem_tpu_torch.optimizer import newton

    n = segments + 1
    s = np.arange(side * side)
    V = np.zeros((side * side, n, 3))
    V[:, :, 0] = np.linspace(0.0, length, n)
    V[:, :, 1] = (spacing * (s // side))[:, None]
    V[:, :, 2] = (spacing * (s % side))[:, None]
    V = V.reshape(-1, 3)
    E = (np.stack([np.arange(n - 1), np.arange(1, n)], axis=1)[None]
         + n * s[:, None, None]).reshape(-1, 2)
    fixed = np.zeros(len(V), bool)
    fixed[n * s] = True
    la, mu = enu_to_lame(1e7, 0.40)
    mesh = meshmod.build_rod_mesh_data(
        V, E, density=np.full(len(E), 1000.0), mu=np.full(len(E), mu),
        lam=np.full(len(E), la), model_id=np.zeros(len(E), int),
        models=("ARAP",), is_fixed=fixed,
        ext_force=np.tile(np.array([0.0, -9.8, 0.0]), (len(V), 1)),
        radius=5e-3, dtype=dtype, device=device)
    config = _membrane_config(dtype, **over)
    x0 = mesh.V0.clone()
    return mesh, config, newton.init_state(mesh, config, (), x0,
                                           torch.zeros_like(x0))


def off_tile_checks(k, d):
    """K1 and K7 at (k, d) against their plain versions at E = 1, 31, 33,
    103 and 100,003 (K7 tiles of 32: one element, a tile one short, a tile
    and one, partial last tiles), in f32 (1e-5 of scale) and f64 (1e-12),
    from aligned buffers and from buffers one element off 16 bytes."""
    from mixedfem_tpu_torch import cuda
    from mixedfem_tpu_torch.ops import smallops
    from mixedfem_tpu_torch.solvers import operator as opmod

    sh = cuda.SHAPES[(k, d)]
    N = sh.N
    dev = torch.device("cuda")
    worst = {}
    for dt, tol in ((torch.float32, 1e-5), (torch.float64, 1e-12)):
        for off in (0, 1):
            for E in (1, 31, 33, 103, 100003):
                g = torch.Generator(device=dev).manual_seed(E + off)

                def rnd(*shape):
                    n = int(np.prod(shape))
                    buf = torch.randn(n + off, generator=g, device=dev,
                                      dtype=dt)
                    return buf[off:].view(shape)

                Hs, G, vols = rnd(E, N, N), rnd(E, N, k, d), rnd(E).abs() + 0.1
                nv = E + 2
                T = torch.randint(0, nv, (E, k), generator=g, device=dev,
                                  dtype=torch.int32)
                Gw, mass, p = rnd(E, N, k, d), rnd(E, k, k), rnd(nv, d)
                fm = (torch.rand(nv, generator=g, device=dev) > 0.2).to(dt)
                for name, got, ref in (
                        (sh.k7, cuda.contract_Gw(Hs, G, vols),
                         smallops.contract_Gw_plain(Hs, G, vols)),
                        (sh.k1, cuda.element_apply(T, Gw, mass, fm, p),
                         opmod.element_apply_plain(T, Gw, mass, fm, p))):
                    err, scale = max_err(got, ref)
                    if not err <= tol * scale:
                        raise AssertionError(
                            f"{name} {dt} E {E} offset {off}: {err:.3e} of "
                            f"{scale:.3e}")
                    key = (name, str(dt))
                    worst[key] = max(worst.get(key, 0.0),
                                     err / max(scale, 1e-300))
    for (name, dt), e in worst.items():
        log(f"  {name} {dt} off the tile (E 1, 31, 33, 103, 100003, aligned "
            f"and offset): worst error {e:.3e} of scale")


def membrane_kernels(build, label):
    """K1 and K7 at the shape of the mesh `build(dtype)` makes (the cloth's
    or the hair's), with K2 at m = 3 and 9 over its incidence plan, held to
    their plain versions in f32 and f64 at the main path's shapes and off
    the tile; K1 and K7 timed in both types. (K1's and K7's errors, f32
    timings, f64 timings by name.)"""
    dt = 0.01
    mesh, _, state = build(torch.float32)
    log(f"  {label}: E {mesh.nelem} nv {mesh.nv}; " +
        plan_line("vertex plan", mesh.plan))
    c32 = kernel_cases(mesh, None, state, dt)
    errs = check_kernels(c32, torch.float32, 1e-5)
    mesh64, _, state64 = build(torch.float64)
    c64 = kernel_cases(mesh64, None, state64, dt)
    check_kernels(c64, torch.float64, 1e-12)
    mine = [c for c in c64 if not c["name"].startswith("segment")]
    t64 = {t["name"]: t for t in time_kernels(mine, torch.float64)}
    del mesh64, state64, c64, mine
    k, d = mesh.T.shape[1], mesh.dim
    off_tile_checks(k, d)
    mine = [c for c in c32 if not c["name"].startswith("segment")]
    t32 = time_kernels(mine, torch.float32)
    return {c["name"]: errs[c["name"]] for c in mine}, t32, t64


def membrane_main_path(name, mesh, config, state):
    """One warm-up and three timed f32 steps through newton_step, counters
    set to 0 just before and read just after: K1 and K7 at the mesh's
    shape and K2 must launch, K3 must not."""
    from mixedfem_tpu_torch import cuda

    sh = cuda.SHAPES[(mesh.T.shape[1], mesh.dim)]
    states, times, launches, _, _ = _timed_steps(
        _stepper(mesh, config, state), 1, 3)
    r = solver_report(name, states, times, launches, True)
    _need(name, launches, (sh.k1, sh.k7, "segment_sum_m3", "segment_sum_m9"),
          absent=("contract_G_Gw", "contract_G_Gw_n3"))
    final = states[-1]
    if not torch.isfinite(final.x).all():
        raise AssertionError(f"{name}: non-finite positions")
    fixed = mesh.free_mask == 0
    if not (final.x[fixed] - mesh.V0[fixed]).abs().max().item() <= 1e-6:
        raise AssertionError(f"{name}: a pinned vertex moved")
    r["launches_by_kernel"] = launches
    return r


def membrane_trajectories():
    """Phases 22 and 23, float64: 3 steps on the card and on the CPU of the
    6 x 6 cloth (tests/test_shell.py's drape, CG to 1e-8), the 9-node rod
    (tests/test_rod.py's hanging chain_rod) and a bundle of 2 x 2 strands
    of 8 segments (CG to 1e-8): positions to 1e-9 of scale, Newton counts
    equal, CG counts within KRYLOV_BAND. The flat cloth's out-of-plane
    stiffness is its mass alone, and its CG iterates part by rounding:
    the card's and the CPU's positions lay 4.4e-11 apart after the first
    step with equal counts, and a stop at the tolerance then moved by one
    (52 against 53 in the second step's last solve; PERF.md)."""
    from mixedfem_tpu_torch import cuda

    runs = (
        ("cloth 6x6", lambda dev: cloth(6, 6, torch.float64, dev,
                                        outer_steps=3, itr_tol=1e-8)),
        ("chain_rod(9)", lambda dev: hair(1, 8, torch.float64, dev,
                                          outer_steps=3, itr_tol=1e-8,
                                          max_iterative_solver_iters=2000)),
        ("bundle 2x2", lambda dev: hair(2, 8, torch.float64, dev,
                                        spacing=0.1, outer_steps=3,
                                        itr_tol=1e-8,
                                        max_iterative_solver_iters=2000)),
    )
    for label, build in runs:
        out = {}
        for dev in ("cuda", "cpu"):
            mesh, config, state = build(dev)
            cuda.clear_launches()
            out[dev] = run_steps(mesh, config, state, None, 3)
            launches = dict(cuda.LAUNCHES)
            if dev == "cuda":
                sh = cuda.SHAPES[(mesh.T.shape[1], 3)]
                _need(label, launches, (sh.k1, sh.k7),
                      absent=("contract_G_Gw",))
        for k, (g, c) in enumerate(zip(out["cuda"], out["cpu"])):
            _compare(f"{label} step {k}", g, c, KRYLOV_BAND)


# ---------------------------------------------------------------------------
# phases 24 and 25: f64 islands and warm-started rotations
# ---------------------------------------------------------------------------

def small_beam(nx, ny, nz, dtype, device):
    """tests/test_newton.py:small_beam on the port: box_tet_mesh(nx, ny, nz)
    over (2, 0.5, 0.5), x=0 face pinned, gravity; SNH (E=1e6, nu=0.45,
    rho=1000). (mesh, rest positions)."""
    from mixedfem_tpu_torch.config import enu_to_lame
    from mixedfem_tpu_torch.mesh import generators
    from mixedfem_tpu_torch.mesh import mesh as meshmod

    V, T = generators.box_tet_mesh(nx, ny, nz, size=(2.0, 0.5, 0.5))
    la, mu = enu_to_lame(1e6, 0.45)
    mesh = meshmod.build_mesh_data(
        V, T, density=np.full(len(T), 1000.0), mu=np.full(len(T), mu),
        lam=np.full(len(T), la), model_id=np.zeros(len(T), int),
        models=("Stable-Neohookean",), is_fixed=V[:, 0] < 1e-9,
        ext_force=np.tile(np.array([0.0, -9.8, 0.0]), (len(V), 1)),
        dtype=dtype, device=device)
    return mesh, V


def squashed(V, free):
    """tests/test_rotation_warm.py's start: the free part squashed to 10%
    along x about the pinned face (which mirrors it: every free element
    inverts)."""
    V2 = np.asarray(V, np.float64).copy()
    x_pin = V2[~free, 0].max()
    V2[:, 0] = np.where(free, x_pin - 0.1 * (V2[:, 0] - x_pin), V2[:, 0])
    return V2


def _fmt(v):
    return "n/a" if v is None else f"{v:.6g}"


def _figures_line(label, fig):
    return (f"  {label}: ms_per_step {_fmt(fig['ms_per_step'])}, ms per "
            f"Newton iteration {_fmt(fig['ms_per_newton'])}, CG per Newton "
            f"{_fmt(fig['cg_per_newton'])}, last decrement "
            f"{_fmt(fig['last_decrement'])}, least decrement "
            f"{_fmt(fig['least_decrement'])}")


def timed_run(name, step, warm, timed, check=True):
    """`warm` untimed steps, then _timed_steps' `timed` timed steps (step()
    returns the state) with the launch counters set to 0 after the
    warm-up: (states, times, launches, launches by type)."""
    from mixedfem_tpu_torch import cuda

    for _ in range(warm):
        t0 = time.perf_counter()
        st = step()
        torch.cuda.synchronize()
        log(f"  {name} warm-up step {(time.perf_counter() - t0) * 1e3:.1f} "
            f"ms: {describe(st)}")
    states, times, launches, _, _ = _timed_steps(step, 0, timed)
    for k, (st, ms) in enumerate(zip(states, times)):
        log(f"  {name} step {k + 1}: {ms:.3f} ms, {describe(st)}")
        if not torch.isfinite(st.x).all():
            raise AssertionError(f"{name}: non-finite positions")
        if check:
            check_energies(st)
    return states, times, launches, dict(cuda.LAUNCHES_BY_TYPE)


def island_report(name, states, times, launches, typed, twin, twin_label,
                  refreshes=0, need=()):
    """Log an island case beside its island-less twin, and check that the
    coefficient update ran through K3 in float64 once a Newton iteration
    and in float32 only in the coarse refreshes (`refreshes`, the JAX
    step's `_build_precond`)."""
    fig = step_figures(states, times)
    log(_figures_line(f"{name} (f64 islands)", fig))
    log(_figures_line(f"{name} twin without islands ({twin_label})", twin))
    k64 = typed.get("contract_G_Gw_f64", 0)
    k32 = typed.get("contract_G_Gw_f32", 0)
    log(f"  {name}: K3 launches float64 {k64}, float32 {k32} (coarse "
        f"refreshes {refreshes}), launches by type {typed}")
    if k64 != fig["newton_iterations"] or k32 != refreshes:
        raise AssertionError(
            f"{name}: K3 ran {k64} times in f64 and {k32} in f32 over "
            f"{fig['newton_iterations']} Newton iterations and {refreshes} "
            f"coarse refreshes")
    _need(name, launches, ("contract_G_Gw", "segment_sum_m3") + tuple(need))
    if not typed.get("segment_sum_m3_f64", 0):
        raise AssertionError(f"{name}: no f64 K2 launch (the island rhs)")
    return dict(fig, twin=twin, twin_label=twin_label,
                launches_by_type=typed, launches_by_kernel=launches)


def islands_main_paths(twins, contact_path):
    """Phase 24: f64 islands at full width on float32 states, each beside
    the same run's island-less phase: (a) phase 4's beam, pcg with its
    coarse space, one warm-up and three timed steps; (b) phase 8's grid
    (body 'lattice_cg': K5 and K6 must launch); (c) pcg-diag on the beam
    at phase 17's depth, one step; (d) phase 11's contact scene, one
    warm-up and one timed step, the least mixed distance > 0."""
    import dataclasses

    from mixedfem_tpu_torch.io.scene import load_scene
    from mixedfem_tpu_torch.optimizer import newton

    results = {}
    mesh, config, state, cs = beam(40, 25, 20, torch.float32, "cuda")
    cfg = dataclasses.replace(config, rhs_precision="float64")
    states, times, launches, typed = timed_run(
        "island_beam_step", _stepper(mesh, cfg, state, cs), 1, 3)
    results["island_beam_step"] = island_report(
        "island_beam_step", states, times, launches, typed, twins["beam"],
        "phase 4", need=("element_apply", "segment_sum_m6"))
    cfg = dataclasses.replace(config, solver="pcg-diag",
                              outer_steps=PHASE17_NEWTON,
                              rhs_precision="float64")
    states, times, launches, typed = timed_run(
        "island_pcg_diag", _stepper(mesh, cfg, state), 0, 1)
    results["island_pcg_diag"] = island_report(
        "island_pcg_diag", states, times, launches, typed, twins["pcg-diag"],
        "phase 17", need=("element_apply",))
    del mesh, state, cs

    mesh, config, state, cs, plan = grid_beam(40, 25, 20, torch.float32,
                                              "cuda")
    cfg = dataclasses.replace(config, rhs_precision="float64")
    body = newton._select_body(cfg, cfg.solver, cs, plan, False, 3, hp=True)
    if body != "lattice_cg":
        raise AssertionError(f"island grid: body {body}, not lattice_cg")
    states, times, launches, typed = timed_run(
        "island_grid_step", _stepper(mesh, cfg, state, cs, plan), 1, 3)
    results["island_grid_step"] = island_report(
        "island_grid_step", states, times, launches, typed, twins["grid"],
        "phase 8", need=("stencil_apply", "stencil_assemble"))
    results["island_grid_step"]["body"] = body
    del mesh, state, cs, plan

    sim = load_scene(contact_path, dim=3, dtype="float32", device="cuda",
                     overrides={"rhs_precision": "float64"})
    t0 = time.perf_counter()
    sim.step()
    torch.cuda.synchronize()
    log(f"  island_contact_step warm-up step "
        f"{(time.perf_counter() - t0) * 1e3:.1f} ms: {describe(sim.state)}")
    r0 = sim.retries
    states, times, launches, typed = timed_run("island_contact_step",
                                               sim.step, 0, 1)
    st = states[-1]
    it = st.stats.iterations
    dmin = st.stats.min_distance[:it].min().item()
    attempts = 1 + sim.retries - r0
    log(f"  island_contact_step: candidates {st.contact.nreal}, active "
        f"frames {st.stats.active_frames[:it].tolist()}, least mixed "
        f"distance {dmin:.6e}, retries {sim.retries - r0}")
    if not 0 < dmin < math.inf:
        raise AssertionError(f"island contact step: least mixed distance {dmin}")
    results["island_contact_step"] = island_report(
        "island_contact_step", states, times, launches, typed,
        twins["contact"], "phase 11",
        refreshes=attempts if sim.coarse is not None else 0,
        need=("segment_sum_m9",) + (("banded_sum_m3",)
                                    if sim.matvec_plan is not None else ()))
    results["island_contact_step"]["least_mixed_distance"] = dmin
    return results


def _rel(a, b) -> float:
    scale = b.abs().max().item()
    return (a.cpu() - b).abs().max().item() / (scale if scale > 0 else 1.0)


def island_pieces(mesh, bdf, x, s, dx, R=None, cf=None, contact=None,
                  dhat=0.0, kappa=0.0, blend=1.0, h2=4e-4):
    """The f64 islands' pieces of one Newton iteration at a float32 state
    (newton.island_update, island_local_solve, island_merit at alpha = 0
    and 0.5), as a dict of float64 tensors."""
    from mixedfem_tpu_torch.optimizer import newton

    mesh_hp = newton._cast(mesh, torch.float64)
    bdf_hp = newton._cast(bdf, torch.float64)
    g, b, c, cc = newton.island_update(
        mesh_hp, bdf_hp, x, s, 0.02, blend=blend, R_prev=R, cf=cf,
        contact=contact, dhat=dhat, kappa=kappa)
    ds, la, dd, cla = newton.island_local_solve(mesh_hp, cf, c, cc, s,
                                                torch.zeros_like(s), dx)
    out = dict(inertia=g, rhs=b, G=c.G, Gw=c.Gw, H=c.H, Sv=c.Sv, ds=ds, la=la)
    cact = None
    if cc is not None:
        cact = cc.active.to(x.dtype)
        out.update(contact_D=cc.D, contact_H=cc.H, dd=dd, contact_la=cla)
    merit = newton.island_merit(mesh_hp, bdf_hp, h2, x, s, dx, ds, la, cf=cf,
                                cc=cc, dd=dd, cla=cla, cact=cact, dhat=dhat,
                                kappa=kappa)
    out["merit_0"] = merit(0.0).reshape(1)
    out["merit_0.5"] = merit(0.5).reshape(1)
    return out


def island_pieces_card_vs_cpu(drop_path):
    """Phase 24, card against CPU: the island pieces at one fixed float32
    state of a 1000-tet beam (with a warm-start seed) and of the drop scene
    (with its contact frames), float64, to 1e-12 relative."""
    from mixedfem_tpu_torch.device import to_device
    from mixedfem_tpu_torch.integrators import bdf as bdfmod
    from mixedfem_tpu_torch.io.scene import load_scene
    from mixedfem_tpu_torch.variables import mixed_stretch as ms

    # the float32 state, made once on the CPU (a state made on each device
    # would differ in its last bits) and copied to the card
    mesh, _, _, _ = beam(10, 5, 4, torch.float32, "cpu")
    g = np.random.default_rng(24)
    free = mesh.free_mask[:, None]

    def f32(a):
        return torch.tensor(a, dtype=torch.float32)

    x = mesh.V0 + f32(0.02 * g.standard_normal((mesh.nv, 3))) * free
    s = ms.reset(mesh, x)[0]
    state = dict(
        x=x, s=s + f32(0.01 * g.standard_normal(tuple(s.shape))),
        v=f32(0.3 * g.standard_normal((mesh.nv, 3))),
        dx=f32(1e-3 * g.standard_normal((mesh.nv, 3))) * free,
        R=ms.stretch_of_x(mesh, mesh.V0)[1])
    out = {}
    for dev in ("cuda", "cpu"):
        mesh, _, _, _ = beam(10, 5, 4, torch.float32, dev)
        t = {k: v.to(dev) for k, v in state.items()}
        bdf = bdfmod.bdf_init("BDF1", t["x"], t["v"], 0.02)
        out[dev] = island_pieces(mesh, bdf, t["x"], t["s"], t["dx"], R=t["R"],
                                 blend=0.5)
    worst = max(_rel(out["cuda"][k], out["cpu"][k]) for k in out["cpu"])
    log(f"  island pieces, 1000-tet beam: card against CPU, worst relative "
        f"difference {worst:.3e} over {sorted(out['cpu'])}")
    if not worst <= 1e-12:
        raise AssertionError("the card's island pieces leave the CPU's (beam)")

    card = load_scene(drop_path, dim=3, dtype="float32", device="cuda")
    card._update_contact_candidates()
    cpu = to_device(card, "cpu")
    g = np.random.default_rng(25)
    ds_host = torch.tensor(0.01 * g.standard_normal(tuple(cpu.state.s.shape)),
                           dtype=torch.float32)
    dx_host = torch.tensor(1e-3 * g.standard_normal(tuple(cpu.state.x.shape)),
                           dtype=torch.float32)
    out = {}
    for sim in (card, cpu):
        st, dev = sim.state, sim.state.x.device
        zero = st.x.new_zeros((st.contact.nreal,))
        out[dev.type] = island_pieces(
            sim.mesh, st.bdf, st.x, st.s + ds_host.to(dev),
            dx_host.to(dev) * sim.mesh.free_mask[:, None], cf=st.contact,
            contact=(zero, zero, zero), dhat=sim.config.dhat,
            kappa=sim.config.kappa, h2=sim.config.h ** 2)
    active = int(torch.count_nonzero(out["cpu"]["contact_H"]))
    worst = max(_rel(out["cuda"][k], out["cpu"][k]) for k in out["cpu"])
    log(f"  island pieces, drop scene ({active} frames inside dhat): card "
        f"against CPU, worst relative difference {worst:.3e}")
    if not (active > 0 and worst <= 1e-12):
        raise AssertionError("the card's island pieces leave the CPU's "
                             "(drop scene)")


def island_floor_card_vs_cpu():
    """Phase 24: tests/test_newton.py's TestMixedPrecision on both devices:
    one float32 step of small_beam(8, 3, 3) with 12 Newton iterations and
    CG to 1e-8, without and with islands; the islands' least decrement is
    under 5e-7 and at most 1.05 times the native run's."""
    from mixedfem_tpu_torch.config import SimConfig
    from mixedfem_tpu_torch.optimizer import newton

    out = {}
    for dev in ("cuda", "cpu"):
        mesh, V = small_beam(8, 3, 3, torch.float32, dev)
        for rp in ("native", "float64"):
            cfg = SimConfig(h=0.02, outer_steps=12, newton_tol=0.0,
                            itr_tol=1e-8, max_iterative_solver_iters=5000,
                            mixed_variables=("mixed-stretch",),
                            dtype="float32", rhs_precision=rp)
            x0 = torch.tensor(V, dtype=torch.float32, device=dev)
            st = newton.init_state(mesh, cfg, (), x0, torch.zeros_like(x0))
            st = newton.newton_step(mesh, cfg, (), st)
            d = st.stats.decrement[:st.stats.iterations]
            out[dev, rp] = (d[d > 0].min().item(), st)
            log(f"  small_beam(8, 3, 3) {dev} {rp}: least decrement "
                f"{out[dev, rp][0]:.4e}, {describe(st)}")
    for dev in ("cuda", "cpu"):
        hp, native = out[dev, "float64"][0], out[dev, "native"][0]
        if not (hp < 5e-7 and hp <= 1.05 * native):
            raise AssertionError(f"{dev}: the islands' least decrement {hp} "
                                 f"(native {native})")
    dist = (out["cuda", "float64"][1].x.cpu()
            - out["cpu", "float64"][1].x).abs().max().item()
    log(f"  island runs, card against CPU: max |x_card - x_cpu| {dist:.3e}")
    return {dev: {rp: out[dev, rp][0] for rp in ("native", "float64")}
            for dev in ("cuda", "cpu")}


def warm_main_paths(twins):
    """Phase 25: warm-started rotations at full width, f32: (a) the
    100k-tet beam with its free part squashed to 10% along x, warm and
    stateless, one warm-up and three timed steps each (the inverted
    elements and least det F after each step; finiteness only); (c) phase
    8's grid, one warm-up and one timed step, body 'lattice_cg'."""
    import dataclasses

    from mixedfem_tpu_torch.mesh import mesh as meshmod
    from mixedfem_tpu_torch.optimizer import newton

    results = {}
    mesh, config, state, cs = beam(40, 25, 20, torch.float32, "cuda")
    free = (mesh.free_mask > 0).cpu().numpy()
    x0 = torch.tensor(squashed(mesh.V0.cpu().numpy(), free),
                      dtype=torch.float32, device="cuda")
    for warm in (True, False):
        name = "warm_squashed_beam" if warm else "stateless_squashed_beam"
        cfg = dataclasses.replace(config, rotation_warm_start=warm)
        st0 = newton.init_state(mesh, cfg, (), x0, torch.zeros_like(x0))
        step = _stepper(mesh, cfg, st0, cs)
        inv = []

        def watched():
            st = step()
            det = torch.linalg.det(meshmod.def_grad(mesh, st.x))
            inv.append((int((det < 0).sum()), det.min().item()))
            return st

        states, times, launches, typed = timed_run(name, watched, 1, 3,
                                                   check=False)
        fig = step_figures(states, times)
        log(_figures_line(name, fig))
        log(f"  {name}: inverted elements and least det F after each step "
            f"(warm-up first) {inv}; launches by type {typed}")
        if warm and states[-1].R.shape != (mesh.nelem, 3, 3):
            raise AssertionError("the warm-start rotations were not carried")
        results[name] = dict(fig, inverted=inv, launches_by_type=typed,
                             launches_by_kernel=launches)
    del mesh, state, cs

    mesh, config, state, cs, plan = grid_beam(40, 25, 20, torch.float32,
                                              "cuda")
    cfg = dataclasses.replace(config, rotation_warm_start=True)
    state = dataclasses.replace(
        newton.init_state(mesh, cfg, (), state.x, torch.zeros_like(state.x)),
        precond=state.precond)
    body = newton._select_body(cfg, cfg.solver, cs, plan, False, 3,
                               warm=True)
    if body != "lattice_cg":
        raise AssertionError(f"warm grid: body {body}, not lattice_cg")
    states, times, launches, typed = timed_run(
        "warm_grid_step", _stepper(mesh, cfg, state, cs, plan), 1, 1)
    fig = step_figures(states, times)
    log(_figures_line("warm_grid_step", fig))
    log(_figures_line("warm_grid_step twin without warm start (phase 8)",
                      twins["grid"]))
    _need("warm_grid_step", launches, ("stencil_apply", "stencil_assemble",
                                       "contract_G_Gw", "segment_sum_m3"))
    results["warm_grid_step"] = dict(fig, body=body, twin=twins["grid"],
                                     launches_by_type=typed,
                                     launches_by_kernel=launches)
    return results


def warm_trajectory():
    """Phase 25 (b): tests/test_rotation_warm.py's squashed small_beam(6, 3,
    3), float64 with warm start (6 Newton iterations, CG to 1e-10), 4
    steps on the card and on the CPU, and on the CPU again from x0 moved
    by one ulp: the trajectory is rounding-chaotic (tests/test_torch_warm.py),
    so the card is held to 1e-9 of scale where the CPU's own one-ulp
    parting allows it and otherwise to twice that parting, positions and
    R; Newton counts equal, CG counts within 2%; every det F > 0 at the
    end."""
    from mixedfem_tpu_torch.config import SimConfig
    from mixedfem_tpu_torch.mesh import mesh as meshmod
    from mixedfem_tpu_torch.optimizer import newton

    cfg = SimConfig(h=0.02, outer_steps=6, newton_tol=0.0, itr_tol=1e-10,
                    max_iterative_solver_iters=5000,
                    mixed_variables=("mixed-stretch",), dtype="float64",
                    rotation_warm_start=True)
    runs = {}
    for key, dev, ulp in (("cuda", "cuda", False), ("cpu", "cpu", False),
                          ("cpu_ulp", "cpu", True)):
        mesh, V = small_beam(6, 3, 3, torch.float64, dev)
        free = (mesh.free_mask > 0).cpu().numpy()
        V2 = squashed(V, free)
        if ulp:
            V2[free] = np.nextafter(V2[free], np.inf)
        x0 = torch.tensor(V2, dtype=torch.float64, device=dev)
        st = newton.init_state(mesh, cfg, (), x0, torch.zeros_like(x0))
        states = []
        for _ in range(4):
            st = newton.newton_step(mesh, cfg, (), st)
            states.append(st)
        runs[key] = (mesh, states)
    exact = True
    for k in range(4):
        g, c, u = (runs[key][1][k] for key in ("cuda", "cpu", "cpu_ulp"))
        scale = c.x.abs().max().item()
        dx = (g.x.cpu() - c.x).abs().max().item()
        dR = (g.R.cpu() - c.R).abs().max().item()
        ux = (u.x - c.x).abs().max().item()
        uR = (u.R - c.R).abs().max().item()
        cg_g = g.stats.solver_iters.tolist()
        cg_c = c.stats.solver_iters.tolist()
        log(f"  step {k}: max |x_card - x_cpu| {dx:.3e} (scale {scale:.3f}; "
            f"CPU one ulp away {ux:.3e}), |R_card - R_cpu| {dR:.3e} ({uR:.3e})"
            f", CG card {cg_g} cpu {cg_c} cpu one ulp away "
            f"{u.stats.solver_iters.tolist()}")
        exact = exact and dx <= 1e-9 * scale and dR <= 1e-9 and cg_g == cg_c
        if g.stats.iterations != c.stats.iterations:
            raise AssertionError("Newton counts differ")
        if not (dx <= max(1e-9 * scale, 2 * ux) and dR <= max(1e-9, 2 * uR)):
            raise AssertionError("the card's warm trajectory leaves the CPU's")
        if any(abs(a - b) > max(1, math.ceil(KRYLOV_BAND * b))
               for a, b in zip(cg_g, cg_c)):
            raise AssertionError("CG counts differ beyond rounding's band")
    log(f"  positions and R to 1e-9 of scale with equal CG counts: "
        f"{'yes' if exact else 'no (within the CPU one-ulp band)'}")
    for key in ("cuda", "cpu"):
        mesh, states = runs[key]
        det = torch.linalg.det(meshmod.def_grad(mesh, states[-1].x))
        if not det.min().item() > 0:
            raise AssertionError(f"{key}: inverted elements remain")
    return exact


# ---------------------------------------------------------------------------
# phases 26-29: several ranks on the card (mixedfem_tpu_torch/parallel/)
# ---------------------------------------------------------------------------

# ranks of phases 26-28, all on the one card over gloo staged through the
# host (NCCL refuses two ranks on one device)
SHARD_RANKS = 4


def _host_beam(nx, ny, nz, reorder=False):
    """The bench's beam on the CPU, float32, for the ranks to take: (mesh,
    config, rest positions, geometric coarse space of target 48), its
    vertices in RCM order with `reorder`."""
    from mixedfem_tpu_torch.mesh import generators
    from mixedfem_tpu_torch.parallel import reorder as rcm
    from mixedfem_tpu_torch.solvers import coarse as coarsemod
    from mixedfem_tpu_torch.solvers.operator import sort_elements_banded

    V, T = generators.box_tet_mesh(nx, ny, nz, size=(4.0, 1.0, 1.0))
    if reorder:
        V, T = rcm.reorder_mesh_arrays(V, T)[:2]
    T = T[sort_elements_banded(T)]
    mesh, config, _ = _sim(V, T, torch.float32, "cpu")
    cs = coarsemod.build_coarse_space(V, T, V[:, 0] < 1e-9, target_size=48,
                                      dtype=torch.float32, device="cpu")
    return mesh, config, V, cs


def rank_figures(label, runs, need):
    """Print and check phases 26-28's readings of one path from its ranks'
    timed steps (`runs[r]` the list of rank r's steps): ms per step and
    per Newton iteration (the slowest rank's), CG per Newton, host ms in
    collectives and bytes sent per step (the maximum over ranks), and each
    rank's launches by name; every kernel of `need` must have launched on
    every rank. Returns the figures."""
    steps = len(runs[0])
    ms = [max(r[k]["ms"] for r in runs) for k in range(steps)]
    its = sum(s["iterations"] for s in runs[0])
    cg = sum(s["cg"] if "cg" in s else int(sum(s["solver_iters"]))
             for s in runs[0])
    comm_ms = max(sum(s["comm_ms"] for s in r) / steps for r in runs)
    comm_bytes = max(sum(s["comm_bytes"] for s in r) / steps for r in runs)
    launches = []
    for r in runs:
        tot = {}
        for s in r:
            for k, v in s["launches"].items():
                tot[k] = tot.get(k, 0) + v
        launches.append(tot)
    fig = dict(ranks=len(runs), transport=runs[0][0]["transport"],
               ms_per_step=sum(ms) / steps,
               ms_per_newton=sum(ms) / its, cg_per_newton=cg / its,
               newton_iterations=its, comm_ms_per_step=comm_ms,
               comm_bytes_per_step=comm_bytes, launches_by_rank=launches)
    log(f"  {label}: ms_per_step {fig['ms_per_step']:.3f}, ms per Newton "
        f"{fig['ms_per_newton']:.3f}, CG per Newton {fig['cg_per_newton']:.2f}"
        f" ({its} Newton iterations in {steps} timed steps), host ms in "
        f"collectives per step {comm_ms:.3f}, bytes sent per step "
        f"{comm_bytes:.0f} (max over ranks)")
    for r, tot in enumerate(launches):
        log(f"    rank {r} launches {dict(sorted(tot.items()))}")
        missing = [k for k in need if tot.get(k, 0) == 0]
        if missing:
            raise AssertionError(f"{label}: rank {r} launched no {missing}")
    for r in runs:
        for s in r:
            if not np.isfinite(s["x"]).all():
                raise AssertionError(f"{label}: non-finite positions")
    return fig


def sharded_main_paths():
    """Phases 26-28 in one process group of SHARD_RANKS ranks on the card:
    the vertex-partitioned 100k-tet beam (RCM order, two-level), the
    sharded stencil step on the 100k-tet grid, the element-sharded
    100k-tet beam; one warm-up and one timed step each (the vp run made
    twice). Returns (figures by path, launches by path summed over ranks)."""
    from mixedfem_tpu_torch import convert
    from mixedfem_tpu_torch.parallel import launch, ranks
    from mixedfem_tpu_torch.parallel import vp_step as vp

    D = SHARD_RANKS
    t0 = time.perf_counter()
    mesh, config, V, cs = _host_beam(40, 25, 20, reorder=True)
    plan = vp.build_vp_plan(mesh, D, coarse=cs)
    log(f"  vp beam: E {mesh.nelem} nv {mesh.nv}, RCM bandwidth "
        f"{int((mesh.T.max(1).values - mesh.T.min(1).values).max())}, "
        f"{D} ranks: nb {plan.nb} Bd {plan.Bd} Ep {plan.T_local.shape[1]}, "
        f"aggregates {cs.naggr}")
    xp = vp.pad_vertex_field(plan, V.astype(np.float32))
    vp_call = (ranks.vp_steps, (plan, config, xp, np.zeros_like(xp), 1),
               dict(warmup=1, repeat=True))
    gmesh, gconfig, _gs, gcs, gplan = grid_beam(40, 25, 20, torch.float32,
                                                "cpu")
    GV = gmesh.V0.numpy()
    log(f"  grid: lattice {(gplan.NI, gplan.NJ, gplan.NK)} over {D} I-slabs "
        f"of {-(-gplan.NI // D)} planes, aggregates {gcs.naggr}")
    st_call = (ranks.stencil_steps, (
        convert.mesh_to_numpy(gmesh), convert.stencil_plan_to_numpy(gplan),
        convert.coarse_to_numpy(gcs), gconfig, GV, np.zeros_like(GV), 1),
        dict(warmup=1))
    bmesh, bconfig, BV, bcs = _host_beam(40, 25, 20)
    es_call = (ranks.element_sharded_steps, (
        convert.mesh_to_numpy(bmesh), convert.coarse_to_numpy(bcs), bconfig,
        BV, np.zeros_like(BV), 1), dict(warmup=1))
    log(f"  host set-up {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    out = launch.run_ranks(ranks.sequence, D, devices=["cuda:0"] * D,
                           args=([vp_call, st_call, es_call],), timeout=60,
                           deadline=900)
    log(f"  {D} ranks on {torch.cuda.get_device_name(0)}, transport "
        f"{out[0][0][0]['transport']} (NCCL refuses two ranks on one "
        f"device): the three paths took {time.perf_counter() - t0:.1f} s")
    figs, launches = {}, {}
    for i, (name, phase, need) in enumerate((
            ("vp_step", 26, ("element_apply", "segment_sum_m3",
                             "contract_G_Gw")),
            ("stencil_shard_step", 27, ("contract_G_Gw", "stencil_apply",
                                        "stencil_assemble", "segment_sum_m3")),
            ("element_sharded_step", 28, ("element_apply", "segment_sum_m3",
                                          "contract_G_Gw")))):
        runs = [o[i] for o in out]
        log(f"phase {phase}: {name}, {D} ranks on one card, float32")
        figs[name] = rank_figures(name, runs, need)
        if name == "stencil_shard_step":
            # the slab's static data, built once before the steps
            figs[name]["slab_setup_ms"] = max(r[0]["slab_ms"] for r in runs)
            log(f"  rank_slab (once, before the steps): "
                f"{figs[name]['slab_setup_ms']:.1f} ms (max over ranks)")
        tot = {}
        for r in figs[name]["launches_by_rank"]:
            for k, v in r.items():
                tot[k] = tot.get(k, 0) + v
        launches[name] = tot
    same = [s["repeat_equal"] for o in out for s in o[0]]
    log(f"  vp_step repeated from the same start: positions bit for bit "
        f"equal on every rank: {all(same)}")
    if not all(same):
        raise AssertionError("the float32 vp step does not repeat bit for bit")
    figs["vp_step"]["repeat_bit_equal"] = True
    # the same positions on every rank (they are psum'd / gathered)
    for name, i in (("stencil_shard_step", 1), ("element_sharded_step", 2)):
        if not all(np.array_equal(o[i][-1]["x"], out[0][i][-1]["x"])
                   for o in out):
            raise AssertionError(f"{name}: ranks disagree on the positions")
    return figs, launches


def _small_cases(device):
    """Phase 29's cases at the CPU tests' sizes, float64 host arrays:
    {name: (target, args, kwargs)} for ranks.sequence, and the single-rank
    steps of each on `device` for the same size."""
    import dataclasses

    from mixedfem_tpu_torch import convert
    from mixedfem_tpu_torch.config import SimConfig, enu_to_lame
    from mixedfem_tpu_torch.mesh import generators
    from mixedfem_tpu_torch.mesh import mesh as meshmod
    from mixedfem_tpu_torch.ops import stencil as stmod
    from mixedfem_tpu_torch.optimizer import newton
    from mixedfem_tpu_torch.parallel import ranks
    from mixedfem_tpu_torch.parallel import vp_step as vp
    from mixedfem_tpu_torch.solvers import coarse as coarsemod
    from mixedfem_tpu_torch.variables import mixed_collision as mc

    la, mu = enu_to_lame(1e6, 0.45)

    def build(V, T, fixed, ext, E=(la, mu)):
        return meshmod.build_mesh_data(
            V, T, density=np.full(len(T), 1000.0), mu=np.full(len(T), E[1]),
            lam=np.full(len(T), E[0]), model_id=np.zeros(len(T), int),
            models=("Stable-Neohookean",), is_fixed=fixed,
            ext_force=np.tile(ext, (len(V), 1)), device="cpu")

    cases, singles = {}, {}
    # the vertex-partitioned step with the two-level coarse space
    V, T = generators.box_tet_mesh(32, 2, 2, size=(2.0, 0.5, 0.5))
    m = build(V, T, V[:, 0] < 1e-9, [0.0, -9.8, 0.0])
    cfg = SimConfig(h=0.02, outer_steps=3, itr_tol=1e-11,
                    max_iterative_solver_iters=5000,
                    mixed_variables=("mixed-stretch",), dtype="float64")
    cs = coarsemod.build_coarse_space(V, T, V[:, 0] < 1e-9, target_size=24,
                                      dtype=torch.float64, device="cpu")
    plan = vp.build_vp_plan(m, 2, coarse=cs)
    xp = vp.pad_vertex_field(plan, V)
    cases["vp_step"] = (ranks.vp_steps, (plan, cfg, xp, np.zeros_like(xp), 2),
                        {})
    singles["vp_step"] = (m, cfg, V, np.zeros_like(V), None, None, None)
    # mixed contact on the drop mesh (tests/test_vp_contact.py)
    Vb, Tb = generators.box_tet_mesh(24, 2, 2, size=(2.4, 0.2, 0.2))
    Vx, Tx = generators.box_tet_mesh(1, 1, 1, size=(0.12, 0.12, 0.12))
    Vd = np.concatenate([Vb, Vx + np.array([1.14, 0.04, 0.225])])
    Td = np.concatenate([Tb, Tx + len(Vb)])
    fixed = (Vd[:, 0] < 1e-9) | (np.abs(Vd[:, 0] - 2.4) < 1e-9)
    md = build(Vd, Td, fixed, [0.0, 0.0, -9.8], enu_to_lame(1e5, 0.45))
    cfgd = SimConfig(h=0.01, outer_steps=4, itr_tol=1e-11,
                     max_iterative_solver_iters=20000,
                     mixed_variables=("mixed-stretch", "mixed-collision"),
                     dtype="float64", dhat=0.05, kappa=100.0)
    vd = np.zeros_like(Vd)
    vd[len(Vb):, 2] = -1.0
    pland = vp.build_vp_plan(md, 2)
    contact = dict(F_srf=md.F_srf.numpy(), E_srf=md.E_srf.numpy(),
                   margin=0.05, nv=md.nv)
    cases["vp_contact"] = (ranks.vp_steps, (
        pland, cfgd, vp.pad_vertex_field(pland, Vd),
        vp.pad_vertex_field(pland, vd), 2), dict(contact=contact))
    singles["vp_contact"] = (md, cfgd, Vd, vd, None, None, contact)
    # the sharded stencil step, grid coarse space (9 x 4 x 3)
    Vg, Tg = generators.box_tet_mesh(9, 4, 3, size=(2.0, 1.0, 0.7))
    gplan, perm = stmod.build_stencil_plan(Tg, len(Vg), (10, 5, 4),
                                           device="cpu")
    Tg = Tg[perm]
    mg = build(Vg, Tg, Vg[:, 0] < 1e-9, [0.0, -9.8, 0.0])
    cfgg = SimConfig(h=0.01, outer_steps=4, newton_tol=1e-12,
                     max_iterative_solver_iters=300, itr_tol=1e-10,
                     mixed_variables=("mixed-stretch",), dtype="float64",
                     coarse_inverse_method="lu")
    gcs = coarsemod.build_coarse_space_grid(
        Vg, Tg, Vg[:, 0] < 1e-9, (10, 5, 4), block=2, dtype=torch.float64,
        device="cpu")
    cases["stencil_shard_step"] = (ranks.stencil_steps, (
        convert.mesh_to_numpy(mg), convert.stencil_plan_to_numpy(gplan),
        convert.coarse_to_numpy(gcs), cfgg, Vg, np.zeros_like(Vg), 2), {})
    singles["stencil_shard_step"] = (mg, cfgg, Vg, np.zeros_like(Vg), gcs,
                                     gplan, None)
    # the element-sharded step with the geometric coarse space
    Ve, Te = generators.box_tet_mesh(4, 2, 2, size=(2.0, 0.5, 0.5))
    me = build(Ve, Te, Ve[:, 0] < 1e-9, [0.0, -9.8, 0.0])
    cfge = SimConfig(h=0.01, outer_steps=4, itr_tol=1e-10, dtype="float64",
                     mixed_variables=("mixed-stretch",))
    ecs = coarsemod.build_coarse_space(Ve, Te, Ve[:, 0] < 1e-9, target_size=8,
                                       dtype=torch.float64, device="cpu")
    cases["element_sharded_step"] = (ranks.element_sharded_steps, (
        convert.mesh_to_numpy(me), convert.coarse_to_numpy(ecs), cfge, Ve,
        np.zeros_like(Ve), 2), {})
    singles["element_sharded_step"] = (me, cfge, Ve, np.zeros_like(Ve), ecs,
                                       None, None)

    def single(name):
        """2 single-rank newton_step calls of case `name` on `device`."""
        m, cfg, V0, v0, cs0, plan0, contact0 = singles[name]
        m = convert.mesh_from_numpy(convert.mesh_to_numpy(m), torch.float64,
                                    device)
        cs0 = None if cs0 is None else convert.coarse_from_numpy(
            convert.coarse_to_numpy(cs0), torch.float64, device)
        plan0 = None if plan0 is None else convert.stencil_plan_from_numpy(
            convert.stencil_plan_to_numpy(plan0), device)
        if name == "vp_step":
            # the vertex-partitioned step is held to the block-Jacobi step
            # (tests/test_sharding.py)
            cs0 = None
        st = newton.init_state(m, cfg, (), torch.tensor(V0, device=device),
                               torch.tensor(v0, device=device))
        out = []
        for _ in range(2):
            if contact0 is not None:
                f, t, k = ranks.candidates(st.x.cpu().numpy(), contact0)
                st = dataclasses.replace(st, contact=mc.contact_frames(
                    f, t, k, m.nv, torch.float64, device))
            st = newton.newton_step(m, cfg, (), st, cs0, (), plan0)
            out.append(st.x.cpu().numpy())
        return out

    return cases, single


def sharded_card_vs_cpu():
    """Phase 29: each sharded path of phases 26-28 and the vertex-
    partitioned step with contact, float64, at the CPU tests' sizes: 2
    ranks on the card against 2 gloo ranks on the CPU (started together),
    2 steps, to 1e-9 of scale with Newton counts equal and CG within 2%
    (contact 10%); each card run also against the single-rank card step
    of the same size (1e-8 of scale after one step, 1e-7 after two; with
    contact 1e-6, tests/test_vp_contact.py's)."""
    from concurrent.futures import ThreadPoolExecutor

    from mixedfem_tpu_torch.parallel import launch, ranks

    cases, single = _small_cases("cuda")
    names = list(cases)
    calls = [cases[n] for n in names]
    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:
        card = pool.submit(launch.run_ranks, ranks.sequence, 2,
                           devices=["cuda:0"] * 2, args=(calls,), timeout=60,
                           deadline=600)
        cpu = pool.submit(launch.run_ranks, ranks.sequence, 2, args=(calls,),
                          timeout=60, deadline=600)
        card, cpu = card.result(), cpu.result()
    log(f"  2 card ranks and 2 CPU ranks took {time.perf_counter() - t0:.1f} s")

    def full_x(runs, k, name):
        """Step k's positions: the ranks' rows of a vp run end to end."""
        if name.startswith("vp"):
            return np.concatenate([r[k]["x"] for r in runs])
        return runs[0][k]["x"]

    for i, name in enumerate(names):
        band = 0.10 if name == "vp_contact" else 0.02
        g_runs, c_runs = [o[i] for o in card], [o[i] for o in cpu]
        ref = single(name)
        nv = ref[0].shape[0]
        for k in range(2):
            xg, xc = full_x(g_runs, k, name)[:nv], full_x(c_runs, k, name)[:nv]
            scale = np.abs(xc).max()
            err = np.abs(xg - xc).max()
            err1 = np.abs(xg - ref[k]).max()
            cg_g = g_runs[0][k].get("cg", None)
            if cg_g is None:
                cg_g = int(sum(g_runs[0][k]["solver_iters"][:-1]))
                cg_c = int(sum(c_runs[0][k]["solver_iters"][:-1]))
            else:
                cg_c = c_runs[0][k]["cg"]
            it_g, it_c = g_runs[0][k]["iterations"], c_runs[0][k]["iterations"]
            log(f"  {name} step {k}: max |x_card - x_cpu| {err:.3e} (scale "
                f"{scale:.3f}), against the single-rank card step {err1:.3e}; "
                f"Newton card {it_g} cpu {it_c}, CG card {cg_g} cpu {cg_c}")
            if not err <= 1e-9 * scale:
                raise AssertionError(f"{name}: the card's ranks leave the CPU's")
            if it_g != it_c or abs(cg_g - cg_c) > band * max(cg_c, 1):
                raise AssertionError(f"{name}: Newton or CG counts differ")
            tol1 = 1e-6 if name == "vp_contact" else (1e-8, 1e-7)[k]
            if not err1 <= tol1 * scale:
                raise AssertionError(f"{name}: the sharded card run leaves "
                                     "the single-rank card step")


# ---------------------------------------------------------------------------
# phases 30-32: the element-sharded step over Simulation.step

ES_RANKS = 2


def _es_runs(target, args, kwargs, devices, deadline=900):
    """One element-sharded run of `target` (a ranks.py target) on
    ES_RANKS ranks on `devices`: every rank's timed steps."""
    from mixedfem_tpu_torch.parallel import launch

    return launch.run_ranks(target, ES_RANKS, devices=devices, args=args,
                            kwargs=kwargs, timeout=60, deadline=deadline)


def _es_report(label, runs, need):
    """rank_figures of an element-sharded Simulation run, the broadphase's
    ms on each rank, and every rank's frames and positions equal."""
    fig = rank_figures(label, runs, need)
    fig["broadphase_ms_by_rank"] = [sum(s["broadphase_ms"] for s in r)
                                    / len(r) for r in runs]
    fig["frames"] = len(runs[0][-1]["frames"])
    fig["active_frames"] = runs[0][-1]["active"]
    log(f"  broadphase ms per step by rank "
        f"{[round(v, 3) for v in fig['broadphase_ms_by_rank']]}, candidate "
        f"frames {fig['frames']}, most active {fig['active_frames']}")
    for r in runs[1:]:
        for a, b in zip(r, runs[0]):
            if not np.array_equal(a["frames"], b["frames"]):
                raise AssertionError(f"{label}: the ranks' frames differ")
            if not np.array_equal(a["x"], b["x"]):
                raise AssertionError(f"{label}: the ranks' positions differ")
    return fig


def es_contact_main_path():
    """Phase 30: phase 11's contact scene (92,480 tets, load_scene on each
    rank: banded order, banded plan, coarse space), element-sharded over
    ES_RANKS ranks on the card through Simulation.step, float32, one
    warm-up and one timed step. K1 (tet), K2, K3 and K4 must launch on
    every rank, and every rank must hold the same frames."""
    from mixedfem_tpu_torch.parallel import ranks

    with tempfile.TemporaryDirectory() as d:
        path = write_contact_scene(d)
        runs = _es_runs(ranks.scene_steps, (path, 3, "float32", 1),
                        dict(warmup=1), ["cuda:0"] * ES_RANKS)
    return _es_report("es_contact_step", runs, (
        "element_apply", "banded_sum_m3", "banded_sum_m9", "segment_sum_m3",
        "segment_sum_m9", "segment_sum_m6", "segment_sum_m36",
        "contract_G_Gw"))


def es_cloth_main_path():
    """Phase 31: phase 22's cloth (100,352 triangles), element-sharded over
    ES_RANKS ranks on the card through Simulation.step, float32, one
    warm-up and one timed step; K1's and K7's k3d3 instances must launch
    on every rank."""
    from mixedfem_tpu_torch import convert, cuda
    from mixedfem_tpu_torch.parallel import ranks

    mesh, config, _ = cloth(224, 224, torch.float32, "cpu")
    V = mesh.V0.numpy()
    sh = cuda.SHAPES[(3, 3)]
    runs = _es_runs(ranks.simulation_steps, (
        convert.mesh_to_numpy(mesh), config, V, np.zeros_like(V), 1),
        dict(warmup=1), ["cuda:0"] * ES_RANKS)
    return _es_report("es_cloth_step", runs, (sh.k1, sh.k7))


def _es_small_cases(nodal_shift: float = 0.02):
    """Phase 32's cases at the CPU tests' sizes (tests/test_torch_parallel_
    es_*.py's inputs, built here without the JAX package): [(name, (target,
    args, kwargs), Krylov band, position tolerance)] for ranks.sequence.

    The nodal collision case's box is moved `nodal_shift` along x from the
    JAX tests' drop scene. There the box's middle bottom vertex lies
    exactly over a slab vertex, so two point-edge frames have their
    closest-point parameter t exactly at a clamp. The clamped distance's
    Hessian differs on the two sides of a clamp, and which side a t of
    0 or one ulp lands on is rounding's to decide: the card and the CPU
    take different Hessians there (tools/es_floor.py, PERF.md §6)."""
    from mixedfem_tpu_torch import convert
    from mixedfem_tpu_torch.config import SimConfig, enu_to_lame
    from mixedfem_tpu_torch.mesh import generators
    from mixedfem_tpu_torch.mesh import mesh as meshmod
    from mixedfem_tpu_torch.parallel import ranks
    from mixedfem_tpu_torch.solvers.operator import sort_elements_banded

    def build(V, T, fixed, ext, E=1e6, nu=0.45, model="Stable-Neohookean"):
        la, mu = enu_to_lame(E, nu)
        return convert.mesh_to_numpy(meshmod.build_mesh_data(
            V, T, density=np.full(len(T), 1000.0), mu=np.full(len(T), mu),
            lam=np.full(len(T), la), model_id=np.zeros(len(T), int),
            models=(model,), is_fixed=fixed,
            ext_force=np.tile(ext, (len(V), 1)), device="cpu"))

    def drop(dim, shift=0.0):
        """tests/test_collision.py:drop_scene, the box thrown down (and
        moved `shift` along x)."""
        if dim == 3:
            V1, T1 = generators.box_tet_mesh(2, 1, 2, size=(1.0, 0.25, 1.0))
            V2, T2 = generators.box_tet_mesh(2, 1, 2, size=(0.4, 0.2, 0.4))
            V2 = V2 + np.array([0.3, 0.27, 0.3])
        else:
            V1, T1 = generators.grid_tri_mesh(4, 1, size=(1.0, 0.2))
            V2, T2 = generators.grid_tri_mesh(2, 1, size=(0.3, 0.15))
            V2 = V2 + np.array([0.35 + shift, 0.23])
        V = np.concatenate([V1, V2])
        T = np.concatenate([T1, T2 + len(V1)])
        ext = np.zeros(dim)
        ext[1] = -9.8
        v0 = np.zeros_like(V)
        v0[len(V1):, 1] = -0.8 if dim == 3 else -1.5
        return build(V, T, np.arange(len(V)) < len(V1), ext, nu=0.40), V, v0

    def swing(V):
        v0 = np.zeros_like(V)
        v0[:, 1] = -2.0 * V[:, 0] / 4.0
        return v0

    Vb, Tb = generators.box_tet_mesh(4, 2, 2, size=(4.0, 1.0, 1.0))
    Tb = Tb[sort_elements_banded(Tb)]
    beam = build(Vb, Tb, Vb[:, 0] < 1e-9, [0.0, -9.8, 0.0])
    fung = build(Vb, Tb, Vb[:, 0] < 1e-9, [0.0, -9.8, 0.0], model="Fung")
    Vt, Tt = generators.grid_tri_mesh(8, 2, size=(4.0, 1.0))
    tri = build(Vt, Tt, Vt[:, 0] < 1e-9, [0.0, -9.8])
    shell, _, _ = cloth(4, 4, torch.float64, "cpu")
    Vc = shell.V0.numpy()
    Vr = np.zeros((9, 3))
    Vr[:, 0] = np.linspace(0.0, 1.0, 9)
    la, mu = enu_to_lame(1e7, 0.40)
    rod = convert.mesh_to_numpy(meshmod.build_rod_mesh_data(
        Vr, np.stack([np.arange(8), np.arange(1, 9)], axis=1),
        density=np.full(8, 1000.0), mu=np.full(8, mu), lam=np.full(8, la),
        model_id=np.zeros(8, int), models=("ARAP",),
        is_fixed=np.arange(9) == 0,
        ext_force=np.tile([0.0, -9.8, 0.0], (9, 1)), radius=5e-3,
        device="cpu"))
    step = dict(h=0.02, outer_steps=3, newton_tol=0.0, itr_tol=1e-10,
                max_iterative_solver_iters=2000, dtype="float64",
                mixed_variables=("mixed-stretch",))
    # contact solves to 1e-11: a CG stop that rounding moves by an
    # iteration then moves the positions far less than 1e-9 of scale
    contact = dict(h=0.01, outer_steps=3, itr_tol=1e-11,
                   max_iterative_solver_iters=2000, dhat=1e-2, kappa=1e5,
                   enable_ccd=True, dtype="float64",
                   mixed_variables=("mixed-stretch", "mixed-collision"))
    nodal = dict(contact, mixed_variables=("mixed-stretch",))
    membrane = dict(h=0.01, outer_steps=3, itr_tol=1e-10,
                    max_iterative_solver_iters=2000, dtype="float64",
                    mixed_variables=("mixed-stretch",))
    V3, Vd2, Vn2 = drop(3), drop(2), drop(2, nodal_shift)
    forced = (Vb[:, 0] > 3.9).astype(np.float64)
    press = ({"forced": forced, "axis": 1,
              "marker": int(np.nonzero(forced)[0][0]),
              "target_velocity": -0.5, "max_force": 2e4,
              "max_displacement": 0.5},
             {"f": -5e3, "marker_pos": float(Vb[int(np.nonzero(forced)[0][0]),
                                                1]),
              "marker_pos0": float(Vb[int(np.nonzero(forced)[0][0]), 1])})
    power = np.random.default_rng(0).standard_normal(Vb.shape)
    cases = [
        ("mixed-collision 3D", V3[0], contact, V3[1], V3[2], {}, 0.10),
        ("mixed-collision 2D", Vd2[0], contact, Vd2[1], Vd2[2], {}, 0.10),
        ("nodal collision 2D", Vn2[0], dict(nodal, variables=("collision",)),
         Vn2[1], Vn2[2], {}, 0.10),
        ("friction 2D", Vd2[0], dict(nodal, variables=("friction",),
                                     contact_mu=0.3),
         Vd2[1], Vd2[2] + np.array([0.3, 0.0]) * (Vd2[2][:, 1:] != 0), {},
         0.10),
        ("2D solid", tri, step, Vt, swing(Vt), {}, 0.02),
        ("shell", convert.mesh_to_numpy(shell), membrane, Vc,
         np.zeros_like(Vc), {}, 0.02),
        ("rod", rod, membrane, Vr, np.zeros_like(Vr), {}, 0.02),
    ]
    for solver in ("pcg-diag", "pcg-laplacian", "pcg-dualascent",
                   "gauss-seidel", "minres-kkt", "minres-kkt-admm", "dual-cg",
                   "admm"):
        build_kw = {}
        if solver in ("pcg-laplacian", "pcg-dualascent"):
            build_kw["power_v0"] = power
        if solver == "gauss-seidel":
            build_kw["gs"] = True
        # one Newton iteration a step: the script's time (phase 17's cut)
        cfg = dict(step, solver=solver, outer_steps=1)
        if solver == "admm":
            cfg.update(itr_tol=1e-4, max_iterative_solver_iters=500)
        cases.append((solver, fung, cfg, Vb, swing(Vb), build_kw, 0.02))
    cases += [
        ("banded plan", beam, dict(step, solver="pcg-block-jacobi"), Vb,
         swing(Vb), dict(banded=True), 0.02),
        ("warm rotations", beam, dict(step, rotation_warm_start=True), Vb,
         swing(Vb), {}, 0.02),
        ("vanilla stretch", beam, dict(step, variables=("stretch",),
                                       record_vanilla_gradient=True,
                                       solver="pcg-block-jacobi"),
         Vb, swing(Vb), {}, 0.02),
        ("press", beam, step, Vb, np.zeros_like(Vb), dict(press=(press,)),
         0.02),
    ]
    for solver in ("direct", "pcg-ic", "amgcl"):
        cases.append((f"host {solver}", beam, dict(step, solver=solver,
                                                   outer_steps=1), Vb,
                      swing(Vb), {}, 0.02))
    out = [(name, (ranks.simulation_steps,
                   (mesh_np, SimConfig(**cfg), x0, v0, 2), kw), band, 1e-9)
           for name, mesh_np, cfg, x0, v0, kw, band in cases]
    # f64 islands run on a float32 state: card and CPU part at float32
    # rounding there
    out.append(("f64 islands (float32 state)", (ranks.simulation_steps, (
        beam, SimConfig(**dict(step, dtype="float32", itr_tol=1e-6,
                              rhs_precision="float64")),
        Vb.astype(np.float32), swing(Vb).astype(np.float32), 2), {}),
        0.02, 1e-5))
    return out


def es_card_vs_cpu():
    """Phase 32: one case of each path the element-sharded step took on in
    this slice (contact in 3D and 2D, nodal collision, friction, a 2D
    solid, a shell, rods, each on-device solver, the banded plan, warm
    rotations, the vanilla stretch, a press, the host solvers; f64
    islands), at the CPU tests' sizes, 2 steps through Simulation.step on
    ES_RANKS ranks on the card against ES_RANKS gloo ranks on the CPU
    started beside them (the solvers' steps at one Newton iteration, the
    script's time): float64 positions to 1e-9 of scale (the float32
    island state's to 1e-5), Newton counts equal, Krylov counts within 2%
    (contact 10%) outside the last Newton iteration of a longer step,
    every rank's frames equal, and the host solvers' ranks equal bit for
    bit.
    Prints each case's host ms per step on both sides."""
    from concurrent.futures import ThreadPoolExecutor

    from mixedfem_tpu_torch.parallel import launch, ranks

    cases = _es_small_cases()
    calls = [c[1] for c in cases]
    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:
        card = pool.submit(launch.run_ranks, ranks.sequence, ES_RANKS,
                           devices=["cuda:0"] * ES_RANKS, args=(calls,),
                           timeout=60, deadline=900)
        cpu = pool.submit(launch.run_ranks, ranks.sequence, ES_RANKS,
                          args=(calls,), timeout=60, deadline=900)
        card, cpu = card.result(), cpu.result()
    log(f"  {ES_RANKS} card ranks and {ES_RANKS} CPU ranks took "
        f"{time.perf_counter() - t0:.1f} s for {len(cases)} cases")
    bad = []
    for i, (name, _, band, tol) in enumerate(cases):
        g_runs, c_runs = [o[i] for o in card], [o[i] for o in cpu]
        for k in range(2):
            g, c = g_runs[0][k], c_runs[0][k]
            scale = np.abs(c["x"]).max()
            err = np.abs(g["x"].astype(np.float64) - c["x"]).max()
            kry_g, kry_c = g["solver_iters"], c["solver_iters"]
            log(f"  {name} step {k}: max |x_card - x_cpu| {err:.3e} (scale "
                f"{scale:.3f}); Newton card {g['iterations']} cpu "
                f"{c['iterations']}; Krylov card {kry_g.tolist()} cpu "
                f"{kry_c.tolist()}; frames {len(g['frames'])}; host ms "
                f"card {g['ms']:.1f} cpu {c['ms']:.1f}; collectives a rank "
                f"{g['comm_calls']}")
            if not err <= tol * scale:
                bad.append(f"{name} step {k}: the card's ranks leave the CPU's")
            if g["iterations"] != c["iterations"]:
                bad.append(f"{name} step {k}: Newton counts differ")
            # the last Newton iteration's count sits at the rounding floor
            # (parallel_parity.check_steps); a one-iteration step keeps it
            n = max(len(kry_c) - 1, 1)
            lim = np.maximum(np.ceil(band * kry_c[:n]), 1)
            if not (len(kry_g) == len(kry_c) and np.all(
                    np.abs(kry_g[:n] - kry_c[:n]) <= lim)):
                bad.append(f"{name} step {k}: Krylov counts leave the band")
            if not all(np.array_equal(r[k]["frames"], c["frames"])
                       for r in g_runs + c_runs):
                bad.append(f"{name} step {k}: the ranks' frames differ")
            if name.startswith("host") and not all(
                    np.array_equal(r[k]["x"], g["x"]) for r in g_runs[1:]):
                bad.append(f"{name} step {k}: the card's ranks differ in "
                           "their bits")
    if bad:
        raise AssertionError("; ".join(bad))


def profile_step(step, out_dir, name, untraced_ms):
    """Trace one more step (`step()` runs it) with torch.profiler: device
    busy time against the step's wall time, host and device time per span,
    and the per-kernel table in out_dir/profile_<name>.txt."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(out_dir, exist_ok=True)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    avgs = prof.key_averages()
    # device time of the kernels themselves (as the table's footer sums it)
    busy_ms = sum(
        a.self_device_time_total for a in avgs
        if a.device_type == torch.autograd.DeviceType.CUDA
        and not a.is_user_annotation
    ) / 1e3
    spans = [
        f"  span {a.key:22s} {str(a.device_type):16s} calls {a.count:4d} "
        f"host {a.cpu_time_total / 1e3:9.3f} ms device {a.device_time_total / 1e3:9.3f} ms"
        for a in avgs if a.key.startswith(("newton.", "scene."))
    ]
    # the hand kernels' device time, each instantiation on a line of its own
    hand = []
    for a in avgs:
        m = re.search(r"\b(?:element_apply|segment_sum|contract_G_Gw|banded_sum"
                      r"|stencil_apply|stencil_assemble|stencil_zero_planes)"
                      r"_kernel\w*<[^>]*>", a.key)
        if m and a.device_type == torch.autograd.DeviceType.CUDA:
            hand.append(f"  kernel {m.group(0):40s} launches {a.count:4d} device "
                        f"{a.self_device_time_total / 1e3:8.3f} ms")
    for line in spans + hand:
        log(line)
    path = os.path.join(out_dir, f"profile_{name}.txt")
    with open(path, "w") as f:
        f.write(f"traced step: wall {wall_ms:.3f} ms, device busy {busy_ms:.3f} ms\n")
        f.write("\n".join(spans + hand) + "\n")
        f.write(avgs.table(sort_by="self_device_time_total", row_limit=60))
    log(f"  traced step wall {wall_ms:.3f} ms, device busy {busy_ms:.3f} ms "
        f"({100 * busy_ms / wall_ms:.1f}% of the traced step, "
        f"{100 * busy_ms / untraced_ms:.1f}% of an untraced step), table in {path}")


# ---------------------------------------------------------------------------


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", metavar="DIR", default=None)
    args = ap.parse_args()

    log("phase 1: card")
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)",
              file=sys.stderr)
        return 2
    card = card_line()
    log(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from mixedfem_tpu_torch import cuda
    from mixedfem_tpu_torch.io.scene import load_scene
    from mixedfem_tpu_torch.solvers import operator as opmod

    log("phase 2: build")
    t0 = time.perf_counter()
    lib = cuda.build()
    log(f"  built {lib.name} in {time.perf_counter() - t0:.1f} s")

    log("phase 3: kernels at the 100k-tet shapes")
    mesh, config, state, cs = beam(40, 25, 20, torch.float32, "cuda")
    log(f"  E {mesh.nelem} nv {mesh.nv} aggregates {cs.naggr} ncd {cs.ncd}")
    for name, pl in (("vertex plan", mesh.plan), ("aggregate plan", cs.agg_plan),
                     ("pair plan", cs.pair_plan)):
        log("  " + plan_line(name, pl))
    dt = 0.02
    cases32 = kernel_cases(mesh, cs, state, dt)
    errs = check_kernels(cases32, torch.float32, 1e-5)
    mesh64, _, state64, cs64 = beam(40, 25, 20, torch.float64, "cuda")
    cases64 = kernel_cases(mesh64, cs64, state64, dt)
    check_kernels(cases64, torch.float64, 1e-12)
    k3_64 = [c for c in cases64 if c["name"] == "contract_G_Gw"]
    del mesh64, state64, cs64, cases64
    # K4 on the banded beam's plan and on the loaded scene's plan
    tmp = tempfile.TemporaryDirectory()
    t0 = time.perf_counter()
    sim = load_scene(write_scene(tmp.name, 40, 25, 20, newton=5, seed=0),
                     dim=3, dtype="float32", device="cuda")
    log(f"  scene loaded in {time.perf_counter() - t0:.1f} s: E "
        f"{sim.mesh.nelem} nv {sim.mesh.nv} W {sim.matvec_plan.W} chunks "
        f"{sim.matvec_plan.nchunks}, aggregates {sim.coarse.naggr}")
    beam_plan = opmod.build_banded_plan(mesh)
    for name, pl in (("scene K4 plan", sim.matvec_plan.csr),
                     ("beam K4 plan", beam_plan.csr),
                     ("scene aggregate plan", sim.coarse.agg_plan),
                     ("scene pair plan", sim.coarse.pair_plan)):
        log("  " + plan_line(name, pl))
    beam_rows = step_inputs(mesh, state, dt)
    scene_rows = step_inputs(sim.mesh, sim.state, dt)
    k4_beam = k4_cases(beam_plan, mesh.plan, beam_rows["rows_p"],
                       beam_rows["rows_blk"], f"beam, W={beam_plan.W}")
    k4_scene = k4_cases(sim.matvec_plan, sim.mesh.plan, scene_rows["rows_p"],
                        scene_rows["rows_blk"], f"scene, W={sim.matvec_plan.W}")
    del beam_rows, scene_rows
    errs.update(check_kernels(k4_beam + k4_scene, torch.float32, 1e-5))

    def f64(a):
        return a.double() if torch.is_tensor(a) and a.is_floating_point() else a

    check_kernels(k4_beam + k4_scene, torch.float64, 1e-12, cast=f64)
    timings = time_kernels(cases32, torch.float32)
    sweep = piece_sweep(cs, next(c for c in cases32
                                 if c["name"] == "segment_sum_m36")["make"]()[1])
    k3_32 = next(c for c in cases32 if c["name"] == "contract_G_Gw")
    k3_tiles = {"float32": tile_sweep(k3_32), "float64": tile_sweep(k3_64[0])}
    (k3_64_t,) = time_kernels(k3_64, torch.float64)
    del k3_64
    k4_beam_t = time_kernels(k4_beam, torch.float32)
    k4_scene_t = time_kernels(k4_scene, torch.float32)
    del k4_beam, beam_plan
    # K5 and K6 on the bench's box grid (phase 8's mesh)
    t0 = time.perf_counter()
    gmesh, gconfig, gstate, gcs, gplan = grid_beam(40, 25, 20, torch.float32,
                                                   "cuda")
    log(f"  grid built in {time.perf_counter() - t0:.1f} s: E {gmesh.nelem} "
        f"nv {gmesh.nv}, lattice {(gplan.NI, gplan.NJ, gplan.NK)}, npad "
        f"{gplan.npad}, planes used {len(gplan.used)} of 27, terms "
        f"{len(gplan.terms)}, aggregates {gcs.naggr} (block {gcs.grid[1]}) "
        f"ncd {gcs.ncd}")
    st32 = stencil_cases(gmesh, gplan, gstate, dt, torch.float32)
    st64 = stencil_cases(gmesh, gplan, gstate, dt, torch.float64)
    errs.update(check_kernels(st32, torch.float32, 1e-5))
    check_kernels(st64, torch.float64, 1e-12)
    st32_t = time_kernels(st32, torch.float32)
    st64_t = {t["name"]: t for t in time_kernels(st64, torch.float64)}
    del st32, st64
    # K2 at the contact shapes: phase 11's scene and its first candidates
    ctmp = tempfile.TemporaryDirectory()
    t0 = time.perf_counter()
    csim = load_scene(write_contact_scene(ctmp.name), dim=3, dtype="float32",
                      device="cuda")
    t1 = time.perf_counter()
    csim._update_contact_candidates()
    cf = csim.state.contact
    log(f"  contact scene loaded in {t1 - t0:.1f} s: E {csim.mesh.nelem} nv "
        f"{csim.mesh.nv} W {csim.matvec_plan.W}, aggregates "
        f"{csim.coarse.naggr}, variables {csim.config.mixed_variables}; "
        f"candidates {cf.nreal} (capacity {cf.frames.shape[0]}) in "
        f"{(time.perf_counter() - t1) * 1e3:.1f} ms")
    pairs = first_contact_pairs(csim)
    for name, pl in (("contact frame plan", cf.plan),
                     ("contact pair plan", pairs.plan)):
        log("  " + plan_line(name, pl))
    k2c = contact_k2_cases(cf, pairs)
    errs.update(check_kernels(k2c, torch.float32, 1e-5))
    check_kernels(k2c, torch.float64, 1e-12, cast=f64)
    k2c_t = time_kernels(k2c, torch.float32)
    k2c_pieces = {case_key(c): c["npieces"] for c in k2c}
    del k2c, cf, pairs

    log("phase 4: main path, 100k tets, float32")
    final, step_ms, launches, beam_fig = main_path(mesh, config, state, cs)
    missing = [t["name"] for t in timings if launches.get(t["name"], 0) == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the main path: {missing}")
    if args.profile:
        profile_step(lambda: run_steps(mesh, config, final, cs, 1),
                     args.profile, "step", step_ms)
    del mesh, state, cs, final

    log("phase 5: float64 trajectory, card against CPU")
    trajectory()

    log("phase 6: scene path, 100k tets, float32 (load_scene, Simulation.step)")
    scene_ms, scene_launches = scene_main_path(sim)
    need = ("element_apply", "banded_sum_m3", "banded_sum_m9",
            "segment_sum_m6", "segment_sum_m36", "contract_G_Gw")
    missing = [k for k in need if scene_launches.get(k, 0) == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the scene path: {missing}")
    if args.profile:
        profile_step(sim.step, args.profile, "scene_step", scene_ms)
    del sim

    log("phase 7: float64 scene trajectory, card against CPU")
    with tempfile.TemporaryDirectory() as d:
        scene_trajectory(write_scene(d, 20, 5, 4, newton=3, seed=1))
    tmp.cleanup()

    log("phase 8: grid path, 100k tets, float32 (stencil plan, grid coarse "
        "space)")
    gfinal, grid_ms, grid_launches, grid_fig = main_path(
        gmesh, gconfig, gstate, gcs, gplan, "grid")
    need = ("stencil_apply", "stencil_assemble", "contract_G_Gw",
            "segment_sum_m3", "segment_sum_m36")
    missing = [k for k in need if grid_launches.get(k, 0) == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the grid path: {missing}")
    if args.profile:
        profile_step(lambda: run_steps(gmesh, gconfig, gfinal, gcs, 1, gplan),
                     args.profile, "grid_step", grid_ms)
    del gmesh, gstate, gcs, gplan, gfinal

    log("phase 9: float64 grid trajectory, card against CPU")
    grid_trajectory()

    log("phase 10: one float64 grid step, 100k tets")
    grid_float64_step()

    log("phase 11: contact scene, 92k tets, float32 (load_scene without "
        "mixed_variables, Simulation.step)")
    contact_ms, contact_launches, contact_fig = contact_main_path(csim)
    need = ("element_apply", "banded_sum_m3", "banded_sum_m9",
            "segment_sum_m3", "segment_sum_m9", "segment_sum_m6",
            "segment_sum_m36", "contract_G_Gw")
    missing = [k for k in need if contact_launches.get(k, 0) == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the contact path: {missing}")
    if args.profile:
        profile_step(csim.step, args.profile, "contact_step", contact_ms)
    del csim
    ctmp.cleanup()

    log("phase 12: float64 contact trajectory, card against CPU")
    with tempfile.TemporaryDirectory() as d:
        contact_trajectory(write_drop_scene(d))

    log("phase 13: 2D kernels at the 100k-triangle shapes")
    t0 = time.perf_counter()
    tmesh, tconfig, tstate, tcs = tri_beam(400, 125, torch.float32, "cuda")
    log(f"  triangle beam built in {time.perf_counter() - t0:.1f} s: E "
        f"{tmesh.nelem} nv {tmesh.nv} aggregates {tcs.naggr} ncd {tcs.ncd}")
    log("  " + plan_line("vertex plan", tmesh.plan))
    tri32 = kernel_cases(tmesh, None, tstate, dt)
    errs.update(check_kernels(tri32, torch.float32, 1e-5))
    tmesh64, _, tstate64, _ = tri_beam(400, 125, torch.float64, "cuda")
    tri64 = kernel_cases(tmesh64, None, tstate64, dt)
    check_kernels(tri64, torch.float64, 1e-12)
    tri64_t = {t["name"]: t for t in time_kernels(
        [c for c in tri64 if not c["name"].startswith("segment")],
        torch.float64)}
    del tmesh64, tstate64, tri64
    tri32_t = time_kernels(tri32, torch.float32)
    # K4 over phase 15's scene plan
    ttmp = tempfile.TemporaryDirectory()
    t0 = time.perf_counter()
    tsim = load_scene(write_tri_contact_scene(ttmp.name), dim=2,
                      dtype="float32", device="cuda")
    log(f"  2D contact scene loaded in {time.perf_counter() - t0:.1f} s: E "
        f"{tsim.mesh.nelem} nv {tsim.mesh.nv} W {tsim.matvec_plan.W}, "
        f"aggregates {tsim.coarse.naggr}, variables "
        f"{tsim.config.mixed_variables}")
    log("  " + plan_line("2D scene K4 plan", tsim.matvec_plan.csr))
    rows = step_inputs(tsim.mesh, tsim.state, dt)
    k4_tri = k4_cases(tsim.matvec_plan, tsim.mesh.plan, rows["rows_p"],
                      rows["rows_blk"], f"2D scene, W={tsim.matvec_plan.W}")
    del rows
    errs.update(check_kernels(k4_tri, torch.float32, 1e-5))
    check_kernels(k4_tri, torch.float64, 1e-12, cast=f64)
    k4_tri_t = time_kernels(k4_tri, torch.float32)

    log("phase 14: 2D main path, 100k triangles, float32")
    tfinal, tri_ms, tri_launches, _ = main_path(tmesh, tconfig, tstate, tcs,
                                                what="100k-triangle")
    need = ("element_apply_k3d2", "segment_sum_m2", "segment_sum_m4",
            "segment_sum_m6", "segment_sum_m36", "contract_G_Gw_n3")
    missing = [k for k in need if tri_launches.get(k, 0) == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the 2D path: {missing}")
    if args.profile:
        profile_step(lambda: run_steps(tmesh, tconfig, tfinal, tcs, 1),
                     args.profile, "tri_step", tri_ms)
    del tmesh, tstate, tcs, tfinal

    log("phase 15: 2D contact scene, 101k triangles, float32 (load_scene "
        "with dim=2 without mixed_variables, Simulation.step)")
    tcontact_ms, tcontact_launches, _ = contact_main_path(tsim)
    need = ("element_apply_k3d2", "banded_sum_m2", "banded_sum_m4",
            "segment_sum_m2", "segment_sum_m4", "segment_sum_m6",
            "segment_sum_m36", "contract_G_Gw_n3")
    missing = [k for k in need if tcontact_launches.get(k, 0) == 0]
    if missing:
        raise AssertionError(
            f"kernels not launched on the 2D contact path: {missing}")
    if args.profile:
        profile_step(tsim.step, args.profile, "tri_contact_step", tcontact_ms)
    del tsim
    ttmp.cleanup()

    log("phase 16: float64 2D trajectories, card against CPU")
    log("  the 1000-triangle cantilever through newton_step")
    tri_trajectory()
    with tempfile.TemporaryDirectory() as d:
        log("  a 2000-triangle two-object scene with a rotation BC")
        scene_trajectory(write_tri_two_objects(d), dim=2)
    with tempfile.TemporaryDirectory() as d:
        log("  the 2D drop scene with contact")
        contact_trajectory(write_tri_drop_scene(d), dim=2)

    log("phase 17: the solver family, 100k-tet beam and 92k-tet contact "
        "scene, float32")
    t0 = time.perf_counter()
    mesh, config, state, _ = beam(40, 25, 20, torch.float32, "cuda")
    log(f"  beam built in {time.perf_counter() - t0:.1f} s: E {mesh.nelem} "
        f"nv {mesh.nv}, no coarse space")
    solver_results = solver_family_beam(mesh, config, state)
    del mesh, state
    with tempfile.TemporaryDirectory() as d:
        solver_results.update(solver_family_contact(write_contact_scene(d)))

    log("phase 18: float64 solver-family trajectories, card against CPU")
    solver_trajectories()
    with tempfile.TemporaryDirectory() as d:
        solver_contact_trajectories(write_drop_scene(d))

    log("phase 19: host solve paths and the vanilla stretch, float32")
    t19 = time.perf_counter()
    host_results = host_solvers(args.profile)
    log(f"  phase 19 took {time.perf_counter() - t19:.1f} s")

    log("phase 20: float64 host paths and vanilla stretch, card against CPU")
    t20 = time.perf_counter()
    host_trajectories()
    log(f"  phase 20 took {time.perf_counter() - t20:.1f} s")

    log("phase 21: the lattice-resident CG on the 100k-tet grid, float32, "
        "and float64 card against CPU")
    t21 = time.perf_counter()
    lattice_results = lattice_cg_main_path()
    lattice_cg_trajectories()
    log(f"  phase 21 took {time.perf_counter() - t21:.1f} s")

    log("phase 22: shells, the 100,352-triangle cloth, float32")
    t22 = time.perf_counter()
    shell_errs, shell_t, shell64_t = membrane_kernels(
        lambda dtype: cloth(224, 224, dtype, "cuda"), "cloth")
    errs.update(shell_errs)
    mesh, config, state = cloth(224, 224, torch.float32, "cuda")
    shell_result = membrane_main_path("shell_step", mesh, config, state)
    del mesh, state
    log(f"  phase 22 took {time.perf_counter() - t22:.1f} s")

    log("phase 23: rods, the 102,400-segment hair, float32")
    t23 = time.perf_counter()
    rod_errs, rod_t, rod64_t = membrane_kernels(
        lambda dtype: hair(32, 100, dtype, "cuda"), "hair")
    errs.update(rod_errs)
    mesh, config, state = hair(32, 100, torch.float32, "cuda")
    rod_result = membrane_main_path("rod_step", mesh, config, state)
    del mesh, state
    log("  phases 22 and 23, float64 card against CPU")
    membrane_trajectories()
    log(f"  phase 23 took {time.perf_counter() - t23:.1f} s")

    log("phase 24: f64 islands (rhs_precision='float64') on float32 states, "
        "and card against CPU")
    t24 = time.perf_counter()
    diag = solver_results["pcg-diag"]
    twins = {"beam": beam_fig, "grid": grid_fig, "contact": contact_fig,
             "pcg-diag": dict(
                 ms_per_step=diag["ms_per_step"],
                 ms_per_newton=diag["ms_per_newton"],
                 cg_per_newton=diag["solver_iters_per_newton"],
                 last_decrement=diag["last_decrement"],
                 least_decrement=diag["least_decrement"])}
    with tempfile.TemporaryDirectory() as d:
        island_results = islands_main_paths(twins, write_contact_scene(d))
    with tempfile.TemporaryDirectory() as d:
        island_pieces_card_vs_cpu(write_drop_scene(d))
    island_floor = island_floor_card_vs_cpu()
    log(f"  phase 24 took {time.perf_counter() - t24:.1f} s")

    log("phase 25: warm-started rotations (rotation_warm_start), float32, "
        "and float64 card against CPU")
    t25 = time.perf_counter()
    warm_results = warm_main_paths(twins)
    warm_exact = warm_trajectory()
    log(f"  phase 25 took {time.perf_counter() - t25:.1f} s")

    log(f"phases 26-28: the sharded steps, {SHARD_RANKS} ranks on one card "
        "(one process group; each phase's readings below)")
    t26 = time.perf_counter()
    sharded_figs, sharded_launches = sharded_main_paths()
    log(f"  phases 26-28 took {time.perf_counter() - t26:.1f} s")

    log("phase 29: float64 sharded paths, 2 ranks on the card against 2 on "
        "the CPU and against the single-rank card step")
    t29 = time.perf_counter()
    sharded_card_vs_cpu()
    log(f"  phase 29 took {time.perf_counter() - t29:.1f} s")
    log(f"phase 30: the element-sharded contact scene, 92k tets, {ES_RANKS} "
        "ranks on one card, float32 (load_scene, Simulation.step)")
    t30 = time.perf_counter()
    es_figs = {"es_contact_step": es_contact_main_path()}
    log(f"  phase 30 took {time.perf_counter() - t30:.1f} s")
    log(f"phase 31: the element-sharded cloth, 100,352 triangles, {ES_RANKS} "
        "ranks on one card, float32")
    t31 = time.perf_counter()
    es_figs["es_cloth_step"] = es_cloth_main_path()
    log(f"  phase 31 took {time.perf_counter() - t31:.1f} s")
    log(f"phase 32: float64 element-sharded Simulation.step, {ES_RANKS} ranks "
        f"on the card against {ES_RANKS} on the CPU, each path of this slice")
    t32 = time.perf_counter()
    es_card_vs_cpu()
    log(f"  phase 32 took {time.perf_counter() - t32:.1f} s")
    for name, fig in es_figs.items():
        tot = {}
        for r in fig["launches_by_rank"]:
            for k, v in r.items():
                tot[k] = tot.get(k, 0) + v
        sharded_launches[name] = tot
        sharded_figs[name] = fig

    log("phase 33: results")
    replaces = {c["name"]: c["replaces"] for c in cases32 + k4_scene
                + tri32 + k4_tri}
    replaces.update({t["name"]: ("mixedfem_tpu/ops/brick.py:176"
                                 if t["name"].startswith("element_apply")
                                 else "mixedfem_tpu/ops/smallops.py:22")
                     for t in shell_t + rod_t})
    membrane_paths = {t["name"]: "shell_step" for t in shell_t}
    membrane_paths.update({t["name"]: "rod_step" for t in rod_t})
    membrane64 = dict(shell64_t, **rod64_t)
    replaces.update({t["name"]: "mixedfem_tpu/ops/stencil.py:" + (
        "378" if t["name"] == "stencil_apply" else "187") for t in st32_t})
    k4_other = {t["name"]: t for t in k4_beam_t}
    contact_keys = {t["key"] for t in k2c_t}
    kernels = []
    tri_keys = {t["key"] for t in tri32_t + k4_tri_t}
    for t in (timings + k4_scene_t + st32_t + k2c_t + tri32_t + k4_tri_t
              + shell_t + rod_t):
        name = t["name"]
        by_path = {"beam_step": launches.get(name, 0),
                   "scene_step": scene_launches.get(name, 0),
                   "grid_step": grid_launches.get(name, 0),
                   "contact_step": contact_launches.get(name, 0),
                   "tri_step": tri_launches.get(name, 0),
                   "tri_contact_step": tcontact_launches.get(name, 0),
                   "shell_step": shell_result["launches_by_kernel"].get(name, 0),
                   "rod_step": rod_result["launches_by_kernel"].get(name, 0)}
        by_path.update({n: r["launches_by_kernel"].get(name, 0)
                        for n, r in dict(lattice_results, **island_results,
                                         **warm_results).items()})
        by_path.update({f"solver {n}": r["launches_by_kernel"].get(name, 0)
                        for n, r in solver_results.items()})
        by_path.update({f"host {n}": r["launches_by_kernel"].get(name, 0)
                        for n, r in host_results.items()})
        by_path.update({n: tot.get(name, 0)
                        for n, tot in sharded_launches.items()})
        if name in membrane_paths:
            # K1's and K7's shell and rod instances: phases 22 and 23
            path = membrane_paths[name]
        elif t["key"] in tri_keys:
            # the 2D path that carries the instance: K4 the contact
            # scene's, K1-K3 the triangle beam's (phase 14)
            path = ("tri_contact_step" if name.startswith("banded")
                    else "tri_step")
        else:
            # K4 the scene's, K5 and K6 the grid's, K2 at the contact
            # shapes the contact scene's, K1-K3 the bench beam's (phase 4)
            path = ("contact_step" if t["key"] in contact_keys
                    else "scene_step" if name.startswith("banded")
                    else "grid_step" if name.startswith("stencil")
                    else "beam_step")
        entry = dict(
            name=name, route="cuda",
            source="mixedfem_tpu_torch/csrc/kernels.cu",
            replaces=replaces[name],
            launches=by_path[path],
            launches_by_path=by_path, max_abs_err=errs[t["key"]],
            ms=t["ms"], plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
            bound_by=t["bound_by"], library_ms=t["library_ms"],
        )
        if t["hot_ms"] is not None:
            entry["hot_ms"] = t["hot_ms"]
        if name in st64_t:
            entry["f64"] = {k: st64_t[name][k] for k in (
                "ms", "hot_ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms") if st64_t[name][k] is not None}
        if t["key"] == "segment_sum_m36":
            entry["piece_rows_us"] = sweep
        if name == "contract_G_Gw":
            entry["tile_us"] = k3_tiles["float32"]
            entry["tile_us_f64"] = k3_tiles["float64"]
            entry["f64"] = {k: k3_64_t[k] for k in (
                "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}
        if name in tri64_t:
            entry["f64"] = {k: tri64_t[name][k] for k in (
                "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}
        if name in membrane64:
            entry["f64"] = {k: membrane64[name][k] for k in (
                "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}
        if name == "contract_G_Gw":
            entry["laplacian_rows_k3"] = {
                n: r["laplacian_rows_k3"] for n, r in solver_results.items()
                if n in LAPLACIAN_SOLVERS}
        c = next((c for c in cases32 + tri32 if c["name"] == name), {})
        if t["key"] in contact_keys:
            entry["shapes"] = t["key"]
            entry["npieces"] = k2c_pieces[t["key"]]
        elif "npieces" in c:
            entry["npieces"] = c["npieces"]
        if t["key"] in tri_keys and name.startswith("banded"):
            entry["shapes"] = t["key"]
            entry["k2_same_rows_ms"] = t["k2_same_rows_ms"]
        elif name in k4_other:
            o = k4_other[name]
            entry["shapes"] = t["key"]
            entry["k2_same_rows_ms"] = t["k2_same_rows_ms"]
            entry["other_plan"] = {k: o[k] for k in (
                "key", "ms", "plain_ms", "bound_ms", "library_ms",
                "k2_same_rows_ms")}
        kernels.append(entry)
    log(json.dumps({"sharded": sharded_figs}))
    log(f"{card}, ms_per_step {step_ms:.3f}, scene ms_per_step {scene_ms:.3f}, "
        f"grid ms_per_step {grid_ms:.3f}, contact ms_per_step {contact_ms:.3f}, "
        f"2D ms_per_step {tri_ms:.3f}, 2D contact ms_per_step "
        f"{tcontact_ms:.3f}")
    log(json.dumps({"solvers": {
        n: {k: v for k, v in r.items() if k != "launches_by_kernel"}
        for n, r in solver_results.items()}}))
    log(json.dumps({"host_solvers": {
        n: {k: v for k, v in r.items() if k != "launches_by_kernel"}
        for n, r in host_results.items()}}))
    log(json.dumps({"lattice_cg_shell_rod": {
        n: {k: v for k, v in r.items() if k != "launches_by_kernel"}
        for n, r in dict(lattice_results, shell_step=shell_result,
                         rod_step=rod_result).items()}}))
    log(json.dumps({"islands_warm": dict(
        {n: {k: v for k, v in r.items() if k != "launches_by_kernel"}
         for n, r in dict(island_results, **warm_results).items()},
        small_beam_least_decrement=island_floor,
        warm_trajectory_exact=warm_exact)}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
