"""Parity of mixedfem_tpu_torch's lattice-resident CG in the generic
Newton body (optimizer/newton.py, body 'lattice_cg') with mixedfem_tpu's
`use_stencil_cg` branch, in float64 on the CPU.

The JAX step takes that branch with a StencilPlan, 'pcg' or
'pcg-block-jacobi', no contact and no coarse space or a grid one, where
it refuses its row body: an inertia blend other than 1, f64 islands,
warm-started rotations, a recorded vanilla gradient, rods. The port's
_select_body is held to the JAX step's predicates (`use_stencil_rows`,
`use_stencil`, `use_stencil_cg`, transcribed below) on every combination
of those options, and three 3-step trajectories of a 360-tet box grid
(the bench's cantilever in the plan's element order, swinging from the
start so that every Newton iteration lies above the rounding floor) to
the JAX step's: (a) 'pcg' with the grid coarse space and an inertia
blend of 0.5, (b) 'pcg-block-jacobi' alone with the blend of 0.5
(tests/test_torch_lattice_cg_jacobi.py), and (c) 'pcg' with the grid
coarse space recording the vanilla gradient
(tests/test_torch_lattice_cg_recorded.py), one JAX compile a file so
that each stays under a minute.
Positions and stretches to 1e-8, Newton counts, CG counts and alphas
equal, the vanilla gradient norms to 1e-8 relative."""

import itertools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mixedfem_tpu.config import SimConfig as JConfig
from mixedfem_tpu.config import enu_to_lame
from mixedfem_tpu.mesh import generators
from mixedfem_tpu.mesh import mesh as jmesh
from mixedfem_tpu.ops import stencil as jst
from mixedfem_tpu.optimizer import newton as jnewton
from mixedfem_tpu.solvers import coarse as jcoarse
from mixedfem_tpu_torch import convert
from mixedfem_tpu_torch.config import SimConfig as TConfig
from mixedfem_tpu_torch.optimizer import newton as tnewton
from mixedfem_tpu_torch.solvers import factory as tfactory

from solver_parity import near
from torch_parity import (  # noqa: F401 (one_torch_thread is a fixture)
    CPU, close, one_torch_thread, port, to_numpy,
)


@pytest.fixture(scope="module", autouse=True)
def _one_thread(one_torch_thread):
    """Every test of this module runs on one torch intra-op thread."""


def jax_body(solver, coarse, contact, blend, record, rod, hp, warm):
    """The JAX step's choice for a 3D mixed-stretch mesh without the
    vanilla variable, not a shell, given a StencilPlan
    (mixedfem_tpu/optimizer/newton.py:387-405, :773-783, :858-863), after
    its `coarse = None` for every solver but 'pcg' (:334)."""
    if solver != "pcg":
        coarse = None
    block = solver in ("pcg", "pcg-block-jacobi") and not contact and (
        coarse is None or coarse.grid is not None)
    rows = (block and not rod and not hp and not warm and not record
            and blend == 1.0)
    if rows:
        return "grid"
    return "lattice_cg" if block else "stencil"


def test_select_body_follows_the_jax_predicates(grid):
    tplan = grid["tplan"]
    grid_cs = types.SimpleNamespace(grid=((7, 5, 4), (2, 2, 2)))
    geo_cs = types.SimpleNamespace(grid=None)
    n = 0
    for (solver, coarse, contact, blend, record, rod, hp,
         warm) in itertools.product(
            tfactory.INTERNAL_SOLVERS, (None, grid_cs, geo_cs), (False, True),
            (1.0, 0.5), (False, True), (False, True), (False, True),
            (False, True)):
        cfg = TConfig(solver=solver, inertia_blend_factor=blend,
                      record_vanilla_gradient=record,
                      rotation_warm_start=warm)
        got = tnewton._select_body(
            cfg, solver, coarse if solver == "pcg" else None, tplan, contact,
            3, rod=rod, hp=hp)
        assert got == jax_body(solver, coarse, contact, blend, record, rod,
                               hp, warm), (solver, coarse, contact, blend,
                                           record, rod, hp, warm)
        n += 1
    assert n == len(tfactory.INTERNAL_SOLVERS) * 3 * 2 ** 6
    # a shell ignores the plan (the JAX step's `not mesh.shell`)
    assert tnewton._select_body(TConfig(), "pcg", None, tplan, False, 3,
                                shell=True) == "generic"


@pytest.fixture(scope="module")
def grid():
    """A 6x4x3-cell box grid (360 tets) in the stencil plan's element
    order, x=0 face pinned, gravity; SNH (E=1e6, nu=0.45, rho=1000); both
    packages' plans and the JAX grid coarse space."""
    V, T0 = generators.box_tet_mesh(6, 4, 3, size=(4.0, 1.0, 1.0))
    dims = (7, 5, 4)
    jplan, perm = jst.build_stencil_plan(T0, len(V), dims)
    T = T0[perm]
    la, mu = enu_to_lame(1e6, 0.45)
    fixed = V[:, 0] < 1e-9
    jm = jmesh.build_mesh_data(
        V, T, density=np.full(len(T), 1000.0), mu=np.full(len(T), mu),
        lam=np.full(len(T), la), model_id=np.zeros(len(T), int),
        models=("Stable-Neohookean",), is_fixed=fixed,
        ext_force=np.tile(np.array([0.0, -9.8, 0.0]), (len(V), 1)),
        dtype=jnp.float64)
    jc = jcoarse.build_coarse_space_grid(V, T, fixed, dims, dtype=jnp.float64)
    tplan = convert.stencil_plan_from_numpy(to_numpy(jplan), CPU)
    return dict(V=V, jm=jm, jplan=jplan, tplan=tplan, jc=jc)


# the cases; each needs its own JAX compile (about 20 s), so (b) and (c)
# run in tests/test_torch_lattice_cg_jacobi.py and
# tests/test_torch_lattice_cg_recorded.py
CASES = {
    "blend_grid_coarse": dict(solver="pcg", coarse=True,
                              inertia_blend_factor=0.5),
    "blend_block_jacobi": dict(solver="pcg-block-jacobi", coarse=False,
                               inertia_blend_factor=0.5),
    "recorded_gradient": dict(solver="pcg", coarse=True,
                              record_vanilla_gradient=True),
}
STEP = dict(h=0.02, outer_steps=3, newton_tol=0.0, itr_tol=1e-4,
            max_iterative_solver_iters=500, coarse_refresh_every=2,
            dtype="float64", mixed_variables=("mixed-stretch",))


def test_trajectory(grid):
    check_trajectory(grid, CASES["blend_grid_coarse"])


def check_trajectory(grid, case):
    """3 steps of both packages with the options of `case` (its `coarse`
    says whether the grid coarse space is given)."""
    case = dict(case)
    use_coarse = case.pop("coarse")
    cfg = dict(STEP, **case)
    jcfg, tcfg = JConfig(**cfg), TConfig(**cfg)
    jm, jp, V = grid["jm"], grid["jplan"], grid["V"]
    jc = grid["jc"] if use_coarse else None
    v0 = np.zeros_like(V)
    v0[:, 1] = -2.0 * V[:, 0] / 4.0
    st = jnewton.init_state(jm, jcfg, (), jnp.asarray(V), jnp.asarray(v0))
    if jc is not None:
        st = st.replace(precond=jnp.zeros((jc.ncd, jc.ncd)))
    tm, ts, tc = port(mesh=jm, state=st, coarse=jc)
    tp = grid["tplan"]
    assert tnewton._select_body(tcfg, tcfg.solver, tc, tp, False,
                                3) == "lattice_cg"
    jstep = jax.jit(lambda s: jnewton.newton_step(jm, jcfg, (), s, jc, (), jp))
    for _ in range(3):
        st = jstep(st)
        ts = tnewton.newton_step(tm, tcfg, (), ts, tc, (), tp)
        js = to_numpy(st)
        close(ts.x, js["x"], rtol=0, atol=1e-8)
        close(ts.s, js["s"], rtol=0, atol=1e-8)
        assert not ts.la.any()
        jst_ = js["stats"]
        assert ts.stats.iterations == int(jst_["iterations"]) == 3
        np.testing.assert_array_equal(ts.stats.solver_iters.numpy(),
                                      jst_["solver_iters"])
        close(ts.stats.alpha, jst_["alpha"], rtol=0, atol=0)
        close(ts.stats.energy, jst_["energy"], rtol=1e-10)
        # the warm-start rotations, where the case carries them
        assert ts.R.shape == js["R"].shape
        close(ts.R, js["R"], rtol=0, atol=1e-8)
        if tcfg.record_vanilla_gradient:
            # to 1e-8 of the largest: the last norm is a small difference
            # of the inertia and elastic gradients
            assert (ts.stats.vanilla_grad > 0).all()
            near(ts.stats.vanilla_grad, jst_["vanilla_grad"], 1e-8)
        if jc is not None:
            close(ts.precond, js["precond"], rtol=1e-8,
                  atol=1e-10 * np.abs(js["precond"]).max())
