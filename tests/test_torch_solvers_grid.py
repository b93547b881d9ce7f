"""The solver family on a structured grid against mixedfem_tpu, in
float64 on the CPU: pcg-diag and minres-kkt step a 120-tet box grid given
its StencilPlan. The JAX step runs its lattice body only for pcg and
pcg-block-jacobi, and so must the port (optimizer/newton.py:
_select_body), which runs the generic body with the stencil matvec for
every other solver. The trajectories (3 steps of 3 Newton iterations of
the swinging grid) are held by solver_parity.compare_steps: positions to
1e-8, equal Newton counts and alphas, CG and MINRES counts within the 2%
band solver_parity explains (the grid's stencil sums run in another order
than the JAX package's)."""

import jax.numpy as jnp
import numpy as np
import pytest

from mixedfem_tpu.config import enu_to_lame
from mixedfem_tpu.mesh import generators
from mixedfem_tpu.mesh import mesh as jmesh
from mixedfem_tpu.ops import stencil as jst
from mixedfem_tpu_torch import convert
from mixedfem_tpu_torch.config import SimConfig as TConfig
from mixedfem_tpu_torch.optimizer import newton as tnewton
from mixedfem_tpu_torch.solvers import factory as tfactory

import solver_parity as sp
from torch_parity import CPU, one_torch_thread, to_numpy  # noqa: F401


@pytest.fixture(scope="module", autouse=True)
def _one_thread(one_torch_thread):
    """Every test of this module runs on one torch intra-op thread."""


@pytest.fixture(scope="module")
def grid():
    """A 4x3x2-cell box grid (120 tets) in the stencil plan's element
    order, the bench's cantilever, with both packages' plans."""
    V, T0 = generators.box_tet_mesh(4, 3, 2, size=(4.0, 1.0, 1.0))
    dims = (5, 4, 3)
    jplan, perm = jst.build_stencil_plan(T0, len(V), dims)
    T = T0[perm]
    la, mu = enu_to_lame(1e6, 0.45)
    jm = jmesh.build_mesh_data(
        V, T, density=np.full(len(T), 1000.0), mu=np.full(len(T), mu),
        lam=np.full(len(T), la), model_id=np.zeros(len(T), int),
        models=("Stable-Neohookean",), is_fixed=V[:, 0] < 1e-9,
        ext_force=np.tile(np.array([0.0, -9.8, 0.0]), (len(V), 1)),
        dtype=jnp.float64)
    tplan = convert.stencil_plan_from_numpy(to_numpy(jplan), CPU)
    return V, jm, jplan, tplan


def test_grid_body_only_for_the_block_jacobi_paths(grid):
    tplan = grid[3]
    for solver in tfactory.INTERNAL_SOLVERS:
        kind = tnewton._select_body(TConfig(solver=solver), solver, None,
                                    tplan, False, 3)
        assert kind == ("grid" if solver in ("pcg", "pcg-block-jacobi")
                        else "stencil"), solver


@pytest.mark.parametrize("solver", ["pcg-diag", "minres-kkt"])
def test_grid_with_stencil_plan(grid, solver):
    V, jm, jplan, tplan = grid
    out, recs, jcfg = sp.mesh_trajectory(V, jm, solver, jplan, tplan)
    sp.compare_steps(out, recs, f"grid {solver}", jm, jcfg,
                     band=sp.MINRES_BAND)
