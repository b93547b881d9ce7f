"""Parity of mixedfem_tpu_torch's multicolor Gauss-Seidel
(solvers/gauss_seidel.py), the scalar-diagonal path pcg-diag, and its
solver names and refusals (solvers/factory.py, optimizer/newton.py) with
mixedfem_tpu's, in float64 on the CPU.

The greedy coloring must give JAX's colors exactly; gs_apply and gs_solve
get the JAX functions' inputs on the 360-tet beam and are held to 1e-10
relative (an absolute floor of 1e-10 of the largest value). The
gauss-seidel and pcg-diag paths step a swinging 96-tet beam 3 times with
3 Newton iterations through newton_step: positions to 1e-8, equal Newton,
sweep and CG counts and alphas."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mixedfem_tpu.mesh import mesh as jmesh
from mixedfem_tpu.solvers import factory as jfactory
from mixedfem_tpu.solvers import gauss_seidel as jgs
from mixedfem_tpu.solvers import pcg as jpcg
from mixedfem_tpu.solvers.operator import element_matvec as jelement_matvec
from mixedfem_tpu.variables import mixed_stretch as jms
from mixedfem_tpu_torch.config import SimConfig as TConfig
from mixedfem_tpu_torch.optimizer import newton as tnewton
from mixedfem_tpu_torch.solvers import factory as tfactory
from mixedfem_tpu_torch.solvers import gauss_seidel as tgs
from mixedfem_tpu_torch.solvers import operator as top
from mixedfem_tpu_torch.solvers import pcg as tpcg
from mixedfem_tpu_torch.variables import mixed_stretch as tms

import solver_parity as sp
from torch_parity import (  # noqa: F401 (one_torch_thread is a fixture)
    beam_arrays, one_torch_thread, port, t64, to_numpy,
)


@pytest.fixture(scope="module", autouse=True)
def _one_thread(one_torch_thread):
    """Every test of this module runs on one torch intra-op thread."""


@pytest.fixture(scope="module")
def beam():
    V, T, kw, x = beam_arrays(seed=0)
    jm = jmesh.build_mesh_data(V, T, dtype=jnp.float64, **kw)
    tm, _, _ = port(mesh=jm)
    s = tms.reset(tm, t64(x))[0].numpy()
    jc = jms.update(jm, jnp.asarray(x), jnp.asarray(s), 0.02)
    tc = tms.StretchCoeffs(**{k: t64(v) for k, v in to_numpy(jc).items()})
    return dict(V=V, T=T, jm=jm, tm=tm, jc=jc, tc=tc)


@pytest.fixture(scope="module")
def gs_plans(beam):
    jp = jgs.build_gs_plan(beam["T"], len(beam["V"]), dtype=jnp.float64)
    tp = tgs.build_gs_plan(beam["T"], len(beam["V"]), device="cpu")
    return jp, tp


def test_build_gs_plan(gs_plans):
    jp, tp = gs_plans
    assert tp.ncolors == jp.ncolors
    np.testing.assert_array_equal(tp.masks.numpy(), np.asarray(jp.masks))
    # a shuffled vertex numbering colors differently, the same in both
    from mixedfem_tpu.mesh import generators

    V, T = generators.box_tet_mesh(5, 3, 2)
    perm = np.random.default_rng(4).permutation(len(V))
    T = perm[T]
    jp = jgs.build_gs_plan(T, len(V))
    tp = tgs.build_gs_plan(T, len(V), device="cpu")
    assert tp.ncolors == jp.ncolors
    np.testing.assert_array_equal(tp.masks.numpy(), np.asarray(jp.masks))


def test_gs_apply_and_solve(beam, gs_plans):
    """A symmetric sweep as a preconditioner, and 20 GS sweeps as the
    solver (a zero tolerance), on the condensed operator with block-Jacobi
    blocks."""
    jp, tp = gs_plans
    jm, tm, jc, tc = beam["jm"], beam["tm"], beam["jc"], beam["tc"]
    rng = np.random.default_rng(5)
    blocks = rng.standard_normal((jm.nv, 3, 3))
    blocks = np.einsum("nij,nkj->nik", blocks, blocks) + 3e3 * np.eye(3)
    jbj = jpcg.block_jacobi_inv(jnp.asarray(blocks), jm.free_mask)
    tbj = tpcg.block_jacobi_inv(t64(blocks), tm.free_mask)

    def jA(p):
        return jelement_matvec(jm, p, ms_coeffs=jc)

    def tA(p):
        return top.element_matvec(tm, p, tc)

    r, x0 = rng.standard_normal((2,) + beam["V"].shape)
    sp.near(tgs.gs_apply(tA, tbj, tp, sweeps=2)(t64(r)),
            jax.jit(jgs.gs_apply(jA, jbj, jp, sweeps=2))(jnp.asarray(r)))
    jx, jit_, jerr = jax.jit(lambda b, x: jgs.gs_solve(
        jA, b, x, jbj, jp, 20, 0.0))(jnp.asarray(r), jnp.asarray(x0))
    tx, tit, terr = tgs.gs_solve(tA, t64(r), t64(x0), tbj, tp, 20, 0.0)
    assert tit == int(jit_) == 20
    sp.near(tx, jx)
    sp.near(terr, jerr)


@pytest.mark.parametrize("solver", ["gauss-seidel", "pcg-diag"])
def test_trajectory(solver):
    recs = sp.recorders(solver)
    out, _, _ = sp.beam_trajectory(solver, 4, 2, 2, recs)
    sp.compare_steps(out, recs, solver)


# ---------------------------------------------------------------------------
# the solver names and the refusals
# ---------------------------------------------------------------------------

def test_every_name_resolves_as_in_jax():
    names = sorted(jfactory.REFERENCE_SOLVER_MAP) + list(
        jfactory.INTERNAL_SOLVERS)
    assert sorted(tfactory.REFERENCE_SOLVER_MAP) == sorted(
        jfactory.REFERENCE_SOLVER_MAP)
    for name in names:
        assert tfactory.resolve_solver(name) == jfactory.resolve_solver(name)
    # every path is ported, the host paths (optimizer/newton_direct.py)
    # included
    assert sorted(tfactory.INTERNAL_SOLVERS) == sorted(jfactory.INTERNAL_SOLVERS)
    with pytest.raises(ValueError):
        tfactory.resolve_solver("not-a-solver")


def test_refusals(beam):
    """gauss-seidel without its coloring, any solver without mixed-stretch
    (the JAX step refuses the Laplacian paths without it), and the host
    solvers, which newton_step refuses with the JAX step's ValueError
    (Simulation.step routes them to optimizer/newton_direct.py)."""
    tm = beam["tm"]
    x0 = t64(beam["V"])
    base = dict(h=0.02, outer_steps=1, mixed_variables=("mixed-stretch",))
    st = tnewton.init_state(tm, TConfig(**base), (), x0, torch.zeros_like(x0))
    with pytest.raises(ValueError, match="coloring"):
        tnewton.newton_step(tm, TConfig(**base, solver="gauss-seidel"), (), st)
    for solver in ("pcg-laplacian", "eigen-pcg-dualascent"):
        cfg = TConfig(**dict(base, mixed_variables=()), solver=solver)
        with pytest.raises(NotImplementedError):
            tnewton.newton_step(tm, cfg, (), st)
    for solver in ("direct", "eigen-pcg-IC", "subspace-amgcl"):
        with pytest.raises(ValueError, match="host path"):
            tnewton.newton_step(tm, TConfig(**base, solver=solver), (), st)
