"""The solver cases of tests/test_torch_parallel_es_solver_*.py
(solver_case) and tests/test_torch_parallel_es_host_*.py (host_case).

solver_case is one 2-step element-sharded run of an on-device solver on
2 gloo ranks
against the JAX package's shard_simulation + Simulation.step on 2 virtual
CPU devices, float64, on the swinging 80-tet Fung beam
(torch_parity.beam_arrays(4, 2, 2), whose KKT system is well conditioned,
solver_parity.kkt_inputs says why), with solver_parity's trajectory
settings (3 Newton iterations) and the Krylov solves to 1e-6 (ADMM, whose
sweeps converge linearly, to solver_parity's 1e-4): positions and stretch
to 1e-8 of scale, Newton counts equal, Krylov counts within 2% (at least
1) outside the last Newton iteration, as tests/test_torch_parallel_es.py
holds the sharded CG. GSPMD sums the JAX package's element parts in
another order than the ranks' psum, and a Krylov stop near its
tolerance moves by one with that rounding (seen: pcg-laplacian 36 against
37, dual-cg 100 against 101, with positions within 5e-10 of scale)."""

import jax.numpy as jnp
import numpy as np

from es_parity import check, power_start, run_both
from mixedfem_tpu.mesh import mesh as jmesh
from mixedfem_tpu.solvers import gauss_seidel as jgs
from solver_parity import MINRES_BAND, swing
from torch_parity import beam_arrays



def solver_case(solver: str, D: int = 2):
    V, T, kw, _ = beam_arrays(4, 2, 2)
    kw = dict(kw, models=("Fung",))
    mesh = jmesh.build_mesh_data(V, T, dtype=jnp.float64, **kw)
    cfg = dict(h=0.02, outer_steps=3, newton_tol=0.0,
               itr_tol=1e-4 if solver == "admm" else 1e-6,
               max_iterative_solver_iters=500, dtype="float64",
               mixed_variables=("mixed-stretch",), solver=solver)
    build = {}
    if solver in ("pcg-laplacian", "pcg-dualascent"):
        build["power_v0"] = power_start(V.shape)
    gs_plan = None
    if solver == "gauss-seidel":
        gs_plan = jgs.build_gs_plan(T, len(V), dtype=jnp.float64)
    got, want = run_both(mesh, cfg, V, swing(V), D, gs_plan=gs_plan, **build)
    check(got, want, 1e-8, MINRES_BAND)
    return got, want


def host_case(solver: str):
    """The host solvers through Simulation.step on 2 gloo ranks against the
    JAX package's shard_simulation + Simulation.step on 2 virtual CPU
    devices, float64: 2 steps of the swinging 80-tet beam, one Newton
    iteration each (the JAX host loop over sharded arrays takes about 8 s
    a Newton iteration on the CPU). Each rank's
    element coefficients are gathered in rank order, rank 0 assembles and
    solves the host system, and its solution reaches every rank through
    psum with zeros (optimizer/newton_direct.py), so every rank holds the
    same bits. Positions and stretch to 1e-8 of scale, Newton counts
    equal, and the ranks' positions and stretch equal bit for bit (with
    one Newton iteration no solver count lies outside the last one, which
    parallel_parity.check_steps leaves to rounding)."""
    V, T, kw, _ = beam_arrays(4, 2, 2)
    mesh = jmesh.build_mesh_data(V, T, dtype=jnp.float64, **kw)
    cfg = dict(h=0.02, outer_steps=1, newton_tol=0.0, itr_tol=1e-8,
               max_iterative_solver_iters=500, dtype="float64",
               mixed_variables=("mixed-stretch",), solver=solver)
    got, want = run_both(mesh, cfg, V, swing(V), 2)
    check(got, want, 1e-8, MINRES_BAND)
    for k in range(2):
        for rank_runs in got[1:]:
            np.testing.assert_array_equal(rank_runs[k]["x"], got[0][k]["x"])
            np.testing.assert_array_equal(rank_runs[k]["s"], got[0][k]["s"])
