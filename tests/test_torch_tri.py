"""Parity of mixedfem_tpu_torch's 2D triangle path (generators,
discretization, mesh, sym-vectors, the 2x2 polar decomposition and ds/dF,
the six S-space materials on 3-vectors, the PSD fix at N=3, the
mixed-stretch update, K1's and K3's triangle functions, the 2x2
block-Jacobi, the 2D coarse space, the 2D boundary conditions and press,
newton_step and load_scene + Simulation.step with dim=2, the CLI) with
mixedfem_tpu's, in float64 on the CPU, on a 200-triangle cantilever
(grid_tri_mesh(20, 5) over (4, 1), banded element order).

Every port function gets the JAX function's inputs (numpy, from seeds) and
is held to its output. Tolerances: host precompute exactly or to 1e-14;
single device functions to 1e-12 (rotations) and 1e-10 relative
(materials, coefficients), with an absolute floor of that times the
largest value for entries zero in exact arithmetic; the Pallas kernels in
interpret mode to 1e-12 (float64) or 3e-6 (float32, the brick kernel's
bf16 hi/lo split); 3-step trajectories to 1e-8 on positions of order 1,
with equal Newton and CG counts and alphas. The trajectories start from a
swinging cantilever (v_y = -2 x / 4), so that every Newton iteration of
the three lies above the rounding floor (Queue C of ROADMAP.md)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from mixedfem_tpu.bc import boundary_conditions as jbc
from mixedfem_tpu.bc import press as jpress
from mixedfem_tpu.config import SimConfig as JConfig
from mixedfem_tpu.io.scene import load_scene as jload
from mixedfem_tpu.materials import models as jmat
from mixedfem_tpu.mesh import discretization as jdisc
from mixedfem_tpu.mesh import generators as jgen
from mixedfem_tpu.mesh import mesh as jmesh
from mixedfem_tpu.ops import brick
from mixedfem_tpu.ops import pallas_scatter as psc
from mixedfem_tpu.ops import psd as jpsd
from mixedfem_tpu.ops import rotation as jrot
from mixedfem_tpu.ops import smallops as jsmall
from mixedfem_tpu.optimizer import newton as jnewton
from mixedfem_tpu.solvers import coarse as jcoarse
from mixedfem_tpu.solvers import operator as jop
from mixedfem_tpu.solvers import pcg as jpcg
from mixedfem_tpu.variables import mixed_stretch as jms
from mixedfem_tpu_torch import convert
from mixedfem_tpu_torch.apps import sim as tsim
from mixedfem_tpu_torch.bc import boundary_conditions as tbc
from mixedfem_tpu_torch.bc import press as tpress
from mixedfem_tpu_torch.config import SimConfig as TConfig
from mixedfem_tpu_torch.io.scene import load_scene as tload
from mixedfem_tpu_torch.materials import models as tmat
from mixedfem_tpu_torch.mesh import discretization as tdisc
from mixedfem_tpu_torch.mesh import generators as tgen
from mixedfem_tpu_torch.mesh import mesh as tmesh
from mixedfem_tpu_torch.ops import banded_scatter as bs
from mixedfem_tpu_torch.ops import psd as tpsd
from mixedfem_tpu_torch.ops import rotation as trot
from mixedfem_tpu_torch.ops import smallops as tsmall
from mixedfem_tpu_torch.ops import stencil as tstencil
from mixedfem_tpu_torch.optimizer import newton as tnewton
from mixedfem_tpu_torch.solvers import coarse as tcoarse
from mixedfem_tpu_torch.solvers import operator as top
from mixedfem_tpu_torch.solvers import pcg as tpcg
from mixedfem_tpu_torch.variables import mixed_stretch as tms

from torch_parity import (  # noqa: F401 (one_torch_thread is a fixture)
    CPU, close, one_torch_thread, port, t64, to_numpy, tri_arrays,
    write_tri_scene,
)


@pytest.fixture(scope="module", autouse=True)
def _one_thread(one_torch_thread):
    """Every test of this module runs on one torch intra-op thread."""


DT = 0.02
STEP = dict(h=DT, outer_steps=3, newton_tol=0.0, itr_tol=1e-4,
            max_iterative_solver_iters=500, coarse_refresh_every=2)

# the JAX references of the coefficient update and the coarse matrix, run
# jitted: one compile each, where eager dispatch compiles every operation
_JMS_UPDATE = jax.jit(jms.update)
_JCOARSE_MATRIX = jax.jit(jcoarse.coarse_matrix)


def near(actual, expected, rtol):
    """assert_allclose at rtol with an absolute floor of rtol x the largest
    expected value."""
    e = np.asarray(expected)
    close(actual, e, rtol=rtol, atol=rtol * max(float(np.abs(e).max()), 1e-300))


@pytest.fixture(scope="module")
def tri():
    V, T, kw, x = tri_arrays(seed=0)
    T = T[top.sort_elements_banded(T)]
    jm = jmesh.build_mesh_data(V, T, dtype=jnp.float64, **kw)
    tm, _, _ = port(mesh=jm)
    s = tms.reset(tm, t64(x))[0].numpy()
    s = s + 0.01 * np.random.default_rng(1).standard_normal(s.shape)
    return dict(V=V, T=T, kw=kw, x=x, s=s, jm=jm, tm=tm)


@pytest.fixture(scope="module")
def coeffs(tri):
    """StretchCoeffs of both packages at the same (x, s)."""
    j = _JMS_UPDATE(tri["jm"], jnp.asarray(tri["x"]), jnp.asarray(tri["s"]), DT)
    t = tms.update(tri["tm"], t64(tri["x"]), t64(tri["s"]), DT)
    return j, t


def _jax_coeffs_in_torch(j):
    return tms.StretchCoeffs(**{k: t64(v) for k, v in to_numpy(j).items()})


# ---------------------------------------------------------------------------
# host precompute: generators, discretization, MeshData
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cells", [(1, 1), (20, 5), (7, 3)])
def test_grid_tri_mesh(cells):
    Vt, Tt = tgen.grid_tri_mesh(*cells, size=(2.0, 0.5), origin=(0.1, -0.2))
    Vj, Tj = jgen.grid_tri_mesh(*cells, size=(2.0, 0.5), origin=(0.1, -0.2))
    np.testing.assert_array_equal(Vt, Vj)
    np.testing.assert_array_equal(Tt, Tj)
    assert Tt.dtype == Tj.dtype and Tt.shape == (2 * cells[0] * cells[1], 3)


def test_discretization(tri):
    V, T = tri["V"], tri["T"]
    rho = np.random.default_rng(2).uniform(500, 1500, len(T))
    np.testing.assert_allclose(tdisc.tri_double_areas(V, T),
                               jdisc.tri_double_areas(V, T), rtol=1e-14)
    np.testing.assert_allclose(tdisc.tri2d_dphidX(V, T),
                               jdisc.tri2d_dphidX(V, T), rtol=1e-14, atol=1e-14)
    vols = jdisc.tri_double_areas(V, T)
    np.testing.assert_allclose(tdisc.consistent_mass_coeff(vols, rho, 3),
                               jdisc.consistent_mass_coeff(vols, rho, 3),
                               rtol=1e-14)
    np.testing.assert_array_equal(tdisc.boundary_facets(T),
                                  jdisc.boundary_facets(T))


def test_build_mesh_data(tri):
    """The port's own host precompute of a triangle mesh gives the JAX
    package's arrays: double areas, 2D surface = boundary edges."""
    V, T, kw, jm = tri["V"], tri["T"], tri["kw"], tri["jm"]
    tm = tmesh.build_mesh_data(V, T, dtype=torch.float64, device="cpu", **kw)
    assert tm.dim == jm.dim == 2 and tm.nv == jm.nv
    for f in ("V0", "dphidX", "vols", "mass_coeff", "mass_lumped",
              "mass_diag", "free_mask", "mu", "lam", "ext_force"):
        close(getattr(tm, f), getattr(jm, f), rtol=1e-14, atol=1e-14)
    for f in ("T", "model_id", "F_srf", "E_srf"):
        np.testing.assert_array_equal(getattr(tm, f).numpy(),
                                      np.asarray(getattr(jm, f)))
    assert torch.equal(tm.E_srf, tm.F_srf) and tm.F_srf.shape[1] == 2
    # the carried-across mesh has the same incidence plan
    assert torch.equal(tri["tm"].plan.slots, tm.plan.slots)


def test_def_grad_and_mass_matvec(tri):
    x = tri["x"]
    close(tmesh.def_grad(tri["tm"], t64(x)),
          jmesh.def_grad(tri["jm"], jnp.asarray(x)), rtol=1e-14, atol=1e-14)
    near(tmesh.mass_matvec(tri["tm"], t64(x)),
         jmesh.mass_matvec(tri["jm"], jnp.asarray(x)), 1e-14)


# ---------------------------------------------------------------------------
# rotations, materials, PSD fix
# ---------------------------------------------------------------------------

def _test_F(n=64, seed=3):
    """Random 2x2 F: near-identity, reflected (det < 0), near-singular, and
    rotations of a symmetric S with tr S within the guard of 0."""
    rng = np.random.default_rng(seed)
    F = np.eye(2) + 0.3 * rng.standard_normal((n, 2, 2))
    F[8:16] = F[8:16] * np.array([[-1.0], [1.0]])             # det < 0
    a = rng.standard_normal((8, 2))
    F[16:24] = a[:, :, None] * rng.standard_normal((8, 1, 2))  # rank 1
    F[16:20] += 1e-9 * rng.standard_normal((4, 2, 2))
    c, s = np.cos(0.7), np.sin(0.7)
    R = np.array([[c, -s], [s, c]])
    for i, t in enumerate((0.0, 1e-12, -1e-7, 3e-11)):
        F[24 + i] = R @ np.array([[0.4 + t, 0.1], [0.1, -0.4]])
    F[28] = 0.0
    return F


@pytest.mark.parametrize("fn", ["polar22", "svd22", "dsdF22"])
def test_rotations_2d(fn):
    F = _test_F()
    if fn == "dsdF22":
        R, S = jrot.polar22(jnp.asarray(F))
        got = trot.dsdF22(t64(R), t64(S))
        want = jrot.dsdF22(R, S)
        near(got, want, 1e-12)
        near(trot.dsdF(t64(R), t64(S), 2), want, 1e-12)
        return
    got = getattr(trot, fn)(t64(F))
    want = getattr(jrot, fn)(jnp.asarray(F))
    for a, b in zip(got, want):
        near(a, b, 1e-12)
    if fn == "polar22":
        for a, b in zip(trot.polar(t64(F), 2), want):
            near(a, b, 1e-12)
        R = got[0].numpy()
        np.testing.assert_allclose(np.linalg.det(R), 1.0, atol=1e-12)


def test_rotations_2d_float32():
    """dsdF22's tr S guard at its float32 eps (1e-6) and polar22 in float32,
    to float32 rounding."""
    F = _test_F().astype(np.float32)
    Rj, Sj = jrot.polar22(jnp.asarray(F))
    Rt, St = trot.polar22(torch.from_numpy(F))
    for a, b in ((Rt, Rj), (St, Sj)):
        near(a, b, 1e-5)
    near(trot.dsdF22(torch.from_numpy(np.array(Rj)),
                     torch.from_numpy(np.array(Sj))),
         jrot.dsdF22(Rj, Sj), 1e-5)


@pytest.mark.parametrize("model", tmat.MATERIAL_NAMES)
def test_material_s_space_2d(model):
    """psi, gradient and Hessian of each model on 2D sym-vectors, with
    mixed models (model_id) as the loader builds them."""
    rng = np.random.default_rng(4)
    E = 40
    s = np.array([1.0, 1.0, 0.0]) + 0.1 * rng.standard_normal((E, 3))
    mu = rng.uniform(1e4, 1e5, E)
    la = rng.uniform(1e4, 1e5, E)
    models = tuple(sorted({model, "ARAP"}, key=tmat.model_index))
    mid = rng.integers(0, len(models), E)
    args_t = (t64(s), t64(mu), t64(la), torch.from_numpy(mid), models)
    args_j = (jnp.asarray(s), jnp.asarray(mu), jnp.asarray(la),
              jnp.asarray(mid), models)
    for name in ("psi_s_all", "grad_s_all", "hess_s_all"):
        near(getattr(tmat, name)(*args_t), getattr(jmat, name)(*args_j), 1e-10)


def test_psd_fix_sqrt_n3():
    """The Jacobi PSD fix at N=3 (the 2D stretch Hessians), indefinite and
    definite blocks, in both packages' default sweeps for float64."""
    rng = np.random.default_rng(5)
    A = rng.standard_normal((50, 3, 3))
    H = A + A.transpose(0, 2, 1)
    H[:25] += 6.0 * np.eye(3)
    got = tpsd.psd_fix_sqrt(t64(H), tol=1e-8)
    want = jpsd.psd_fix_sqrt(jnp.asarray(H), tol=1e-8)
    assert tpsd._default_sweeps(torch.float64) == jpsd._default_sweeps(jnp.float64)
    for a, b in zip(got, want):
        near(a, b, 1e-12)


# ---------------------------------------------------------------------------
# the mixed-stretch variable, K1's and K3's functions, block-Jacobi
# ---------------------------------------------------------------------------

@pytest.mark.parametrize(
    "field", ["G", "Gw", "H", "Hinv", "g", "Sv", "R", "max_evals"])
def test_mixed_stretch_update(coeffs, field):
    j, t = coeffs
    assert getattr(t, "G").shape == (len(t.G), 3, 3, 2)
    near(getattr(t, field), getattr(j, field), 1e-10)


@pytest.mark.parametrize("E", [1, 31, 33, 103])
def test_contract_G_Gw_2d(E):
    """K3's function at the triangle shapes (N=3, k=3, d=2), at element
    counts around its 32-element tiles, against JAX's contract_D_dphi and
    sqrt(vol) contract_sym_G."""
    rng = np.random.default_rng(E)
    D = rng.standard_normal((E, 3, 2, 2))
    dphi = rng.standard_normal((E, 3, 2))
    Hs = rng.standard_normal((E, 3, 3))
    vols = rng.uniform(0.1, 1.0, E)
    G_ref = jsmall.contract_D_dphi(jnp.asarray(D), jnp.asarray(dphi))
    Gw_ref = np.sqrt(vols)[:, None, None, None] * np.asarray(
        jsmall.contract_sym_G(jnp.asarray(Hs), G_ref))
    G, Gw = tsmall.contract_G_Gw(t64(D), t64(dphi), t64(Hs), t64(vols))
    near(G, G_ref, 1e-12)
    near(Gw, Gw_ref, 1e-12)


def test_rhs_diag_blocks_local_solve(tri, coeffs):
    jm, tm, s = tri["jm"], tri["tm"], tri["s"]
    j, _ = coeffs
    c = _jax_coeffs_in_torch(j)
    near(tms.rhs_contrib(tm, c, t64(s)), jms.rhs_contrib(jm, j, jnp.asarray(s)),
         1e-12)
    near(tms.diag_blocks_contrib(tm, c), jms.diag_blocks_contrib(jm, j), 1e-12)
    dx = 1e-3 * np.random.default_rng(6).standard_normal(tri["x"].shape)
    for a, b in zip(tms.local_solve(tm, c, t64(s), t64(dx)),
                    jms.local_solve(jm, j, jnp.asarray(s), jnp.asarray(dx))):
        near(a, b, 1e-11)
    la = np.random.default_rng(7).standard_normal(s.shape)
    near(tms.energy(tm, t64(s)), jms.energy(jm, jnp.asarray(s)), 1e-12)
    near(tms.constraint_value(tm, t64(tri["x"]), t64(s), t64(la)),
         jms.constraint_value(jm, jnp.asarray(tri["x"]), jnp.asarray(s),
                              jnp.asarray(la)), 1e-10)


def test_element_matvec(tri, coeffs):
    """K1 + K2's function (the CG matvec) against JAX's element_matvec."""
    jm, tm = tri["jm"], tri["tm"]
    j, _ = coeffs
    p = np.random.default_rng(8).standard_normal((jm.nv, 2))
    near(top.element_matvec(tm, t64(p), _jax_coeffs_in_torch(j)),
         jop.element_matvec(jm, jnp.asarray(p), ms_coeffs=j), 1e-12)


def test_block_jacobi_2x2(tri):
    rng = np.random.default_rng(9)
    nv = tri["jm"].nv
    A = rng.standard_normal((nv, 2, 2))
    blocks = np.einsum("nij,nkj->nik", A, A) + np.eye(2)
    r = rng.standard_normal((nv, 2))
    near(tpcg._small_inv(t64(blocks)), jpcg._small_inv(jnp.asarray(blocks)),
         1e-12)
    near(tpcg.block_jacobi_inv(t64(blocks), tri["tm"].free_mask)(t64(r)),
         jpcg.block_jacobi_inv(jnp.asarray(blocks), tri["jm"].free_mask)(
             jnp.asarray(r)), 1e-12)


# ---------------------------------------------------------------------------
# the Pallas kernels at d = 2, in interpret mode
# ---------------------------------------------------------------------------

def test_brick_matvec_d2_vs_element_matvec():
    """ops/brick.py:_matvec_kernel at (k=3, d=2), in interpret mode, against
    the port's plain K1 + K2 on the same Gw and p (float32)."""
    V, T, kw, _ = tri_arrays()
    T = T[top.sort_elements_banded(T)]
    jm = jmesh.build_mesh_data(V, T, dtype=jnp.float32, **kw)
    tm, _, _ = port(mesh=jm, dtype=torch.float32)
    E = len(T)
    Gw = np.random.default_rng(10).standard_normal((E, 3, 3, 2)).astype(np.float32)
    p = np.random.default_rng(11).standard_normal((jm.nv, 2)).astype(np.float32)
    plan = brick.build_brick_plan(T, jm.nv, ce=128)
    assert plan is not None and plan.k == 3
    Gw_rows = brick.pad_rows(plan, jnp.asarray(Gw).reshape(E, -1))
    m_rows = brick.pad_rows(plan, jm.mass_coeff.reshape(E, 9))
    pm = jnp.asarray(p) * jm.free_mask[:, None]
    out = brick.brick_matvec(plan, Gw_rows, m_rows,
                             brick.to_brick(pm, plan.Hpad), 2, interpret=True)
    ref = np.asarray(brick.from_brick(out, jm.nv, 2) * jm.free_mask[:, None])
    c = tms.StretchCoeffs(G=None, Gw=torch.from_numpy(Gw), H=None, Hinv=None,
                          g=None, Sv=None, R=None, max_evals=None)
    got = top.element_matvec(tm, torch.from_numpy(p), c)
    close(got, ref, rtol=0, atol=3e-6 * np.abs(ref).max())


@pytest.mark.parametrize("m", [2, 4])
@pytest.mark.parametrize("dtype,tol", [(np.float64, 1e-13), (np.float32, 3e-6)])
def test_scatter_add_sorted_2d_vs_pallas(m, dtype, tol):
    """ops/pallas_scatter.py:_make_kernel at the 2D row widths (m=2 rhs
    and matvec, m=4 the 2x2 diagonal blocks), in interpret mode, against
    the port's plain banded_sum over the triangle mesh's corner rows."""
    V, T = tgen.grid_tri_mesh(20, 5, size=(4.0, 1.0))
    T = T[top.sort_elements_banded(T)]
    R = T.size
    ref_plan = psc.build_banded_scatter_plan(T.reshape(-1), len(V), chunk=128)
    plan = bs.build_banded_scatter_plan(T.reshape(-1), len(V), chunk=128,
                                        device="cpu")
    rows = np.zeros((plan.lidx.shape[0], m), dtype)
    rows[:R] = np.random.default_rng(m).standard_normal((R, m))
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(psc.scatter_add_sorted(ref_plan, jnp.asarray(rows)))
    got = bs.scatter_add_sorted(plan, torch.from_numpy(rows))
    assert got.shape == (len(V), m)
    close(got, ref, rtol=0, atol=tol * np.abs(ref).max())


# ---------------------------------------------------------------------------
# coarse space, boundary conditions, press
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def coarse_pair(tri):
    V, T, fixed = tri["V"], tri["T"], tri["kw"]["is_fixed"]
    jc = jcoarse.build_coarse_space(V, T, fixed, target_size=8,
                                    dtype=jnp.float64)
    tc = tcoarse.build_coarse_space(V, T, fixed, target_size=8,
                                    dtype=torch.float64, device="cpu")
    return jc, tc


def test_coarse_space_2d(tri, coeffs, coarse_pair):
    """The six rigid modes with a zero z in 2D: the same aggregates, offsets
    (nv, 3), Galerkin matrix (three of each aggregate's modes vanish on the
    plane; the ridge keeps A_c invertible) and two-level apply."""
    jc, tc = coarse_pair
    assert tc.naggr == jc.naggr and tuple(tc.r.shape) == (tri["jm"].nv, 3)
    for f in ("agg_id", "pair_id", "pair_rows", "pair_cols"):
        np.testing.assert_array_equal(getattr(tc, f).numpy(),
                                      np.asarray(getattr(jc, f)))
    close(tc.r, jc.r, rtol=0, atol=1e-15)
    j, _ = coeffs
    Ac_j = np.asarray(_JCOARSE_MATRIX(tri["jm"], jc, j))
    Ac_t = tcoarse.coarse_matrix(tri["tm"], tc, _jax_coeffs_in_torch(j))
    near(Ac_t, Ac_j, 1e-12)
    rng = np.random.default_rng(12)
    nv = tri["jm"].nv
    A = rng.standard_normal((nv, 2, 2))
    blocks = np.einsum("nij,nkj->nik", A, A) + np.eye(2)
    r = rng.standard_normal((nv, 2))
    Ac_inv = np.linalg.inv(Ac_j)
    want = jcoarse.two_level_preconditioner(
        jc, tri["jm"].free_mask,
        jpcg.block_jacobi_inv(jnp.asarray(blocks), tri["jm"].free_mask), 2,
    )(jnp.asarray(r), jnp.asarray(Ac_inv))
    got = tcoarse.two_level_preconditioner(
        tc, tri["tm"].free_mask,
        tpcg.block_jacobi_inv(t64(blocks), tri["tm"].free_mask), 2,
    )(t64(r), t64(Ac_inv))
    near(got, want, 1e-11)


@pytest.mark.parametrize("bc", ["twist", "bend", "stretch", "translate",
                                "twist-and-stretch", "hang", "scale"])
def test_boundary_conditions_2d(bc):
    """Set-up and 4 steps of each scripted BC on a triangle object inside a
    larger vertex range (translate with flip reverses and stops)."""
    V, _ = tgen.grid_tri_mesh(6, 3, size=(1.0, 0.5), origin=(0.2, 0.1))
    cfg = dict(type=bc, ratio=0.2, axis=0, velocity=0.5, duration=0.03,
               flip=True)
    nv, off = len(V) + 5, 3
    jspec, jst, jfix, jV = jbc.build_bc(V, jbc.BCConfig(**cfg), nv, off,
                                       dtype=jnp.float64)
    tspec, tst, tfix, tV = tbc.build_bc(V, tbc.BCConfig(**cfg), nv, off,
                                        device="cpu")
    np.testing.assert_array_equal(tfix, jfix)
    np.testing.assert_allclose(tV, jV, rtol=0, atol=1e-15)
    X = np.random.default_rng(13).standard_normal((nv, 2))
    xj, xt = jnp.asarray(X), t64(X)
    for _ in range(4):
        xj, jst = jbc.bc_step(jspec, jst, xj, 0.01)
        xt, tst = tbc.bc_step(tspec, tst, xt, 0.01)
        close(xt, xj, rtol=0, atol=1e-14)
        assert (tst.elapsed, tst.reversed, tst.done) == pytest.approx(
            (float(jst.elapsed), bool(jst.reversed), bool(jst.done)))


def test_press_2d():
    nv = 12
    forced = (np.arange(nv) % 3 == 0).astype(np.float64)
    X = np.random.default_rng(14).standard_normal((nv, 2))
    kw = dict(axis=1, marker=3, target_velocity=0.05, max_force=50.0,
              max_displacement=0.3)
    jspec = jpress.PressSpec(forced=jnp.asarray(forced), **kw)
    tspec = tpress.PressSpec(forced=t64(forced), **kw)
    jst = jpress.press_init(jspec, jnp.asarray(X), -5.0)
    tst = tpress.press_init(tspec, t64(X), -5.0)
    for k in range(3):
        close(tpress.press_force(tspec, tst, nv, 2),
              jpress.press_force(jspec, jst, nv, 2), rtol=0, atol=0)
        X = X + 0.001 * (k + 1)
        jst = jpress.press_step(jspec, jst, jnp.asarray(X), 0.01)
        tst = tpress.press_step(tspec, tst, t64(X), 0.01)
        assert tst.f == pytest.approx(float(jst.f), rel=1e-14)


# ---------------------------------------------------------------------------
# newton_step and the scene path, 3 steps against JAX
# ---------------------------------------------------------------------------

def _swing(V):
    v0 = np.zeros_like(V)
    v0[:, 1] = -2.0 * V[:, 0] / 4.0
    return v0


@pytest.fixture(scope="module", params=["block_jacobi", "banded", "coarse"])
def trajectory(request, tri):
    """3 BDF1 steps of both packages from the same swinging state: with
    block-Jacobi alone, with the banded plan (the JAX one in interpret
    mode) and the two-level coarse space, and with the coarse space
    refreshed every 2nd step (a zero cache first: the safeguard rejects it,
    then the cached inverse, then a warm-started refresh)."""
    V, T, kw, jm = tri["V"], tri["T"], tri["kw"], tri["jm"]
    kind = request.param
    jcfg, tcfg = JConfig(**STEP), TConfig(**STEP)
    x0 = jnp.asarray(V)
    st = jnewton.init_state(jm, jcfg, (), x0, jnp.asarray(_swing(V)))
    jc = jplan = tplan = None
    if kind != "block_jacobi":
        jc = jcoarse.build_coarse_space(V, T, kw["is_fixed"], target_size=8,
                                        dtype=jnp.float64)
        st = st.replace(precond=jnp.zeros((jc.ncd, jc.ncd)))
    if kind == "banded":
        jplan = jop.build_banded_plan(jm, chunk=512)
        tplan = convert.banded_plan_from_numpy(to_numpy(jplan), "cpu")
        assert tplan.nchunks > 1  # 600 corner rows in chunks of 512
    tm, ts, tc = port(mesh=jm, state=st, coarse=jc)
    out = []
    for _ in range(3):
        with pltpu.force_tpu_interpret_mode():
            st = jnewton.newton_step(jm, jcfg, (), st, jc, (), jplan)
        ts = tnewton.newton_step(tm, tcfg, (), ts, tc, (), tplan)
        out.append((to_numpy(st), ts))
    return out


def test_trajectory_positions(trajectory):
    for js, ts in trajectory:
        close(ts.x, js["x"], rtol=0, atol=1e-8)
        close(ts.s, js["s"], rtol=0, atol=1e-8)
        close(ts.bdf.v_hist, js["bdf"]["v_hist"], rtol=0, atol=1e-6)
        assert ts.step_count == int(js["step_count"]) and not ts.la.any()


def test_trajectory_counts(trajectory):
    for js, ts in trajectory:
        st = js["stats"]
        assert ts.stats.iterations == int(st["iterations"]) == 3
        np.testing.assert_array_equal(ts.stats.solver_iters.numpy(),
                                      st["solver_iters"])
        close(ts.stats.alpha, st["alpha"], rtol=0, atol=0)
        close(ts.stats.energy, st["energy"], rtol=1e-10)


def test_stencil_plan_of_a_2d_mesh_is_refused(tri):
    """Stencil plans are 3D (the JAX package's lattice bodies run only for
    dim == 3): newton_step refuses one with a 2D mesh."""
    from mixedfem_tpu_torch.mesh import generators

    Vg, Tg = generators.box_tet_mesh(1, 1, 1)
    plan, _ = tstencil.build_stencil_plan(Tg, len(Vg), (2, 2, 2), device="cpu")
    tm = tri["tm"]
    x0 = t64(tri["V"])
    st = tnewton.init_state(tm, TConfig(**STEP), (), x0, torch.zeros_like(x0))
    with pytest.raises(ValueError, match="2D"):
        tnewton.newton_step(tm, TConfig(**STEP), (), st, None, (), plan)


def _write_scene(d, **extra):
    """Two triangle objects, two materials: a twisted SNH beam and an
    ARAP/SNH block (per-triangle material ids) hanging from one end with a
    press on its top strip; BDF2, mixed-stretch only, 3 Newton
    iterations."""
    from mixedfem_tpu_torch.io import mesh_io

    Vb, Tb = tgen.grid_tri_mesh(6, 4, size=(0.6, 0.4))
    mesh_io.write_dmat(str(d / "b_mat.dmat"), (np.arange(len(Tb)) % 2)[:, None])
    return write_tri_scene(
        d,
        [("a", tgen.grid_tri_mesh(12, 3, size=(2.0, 0.5)),
          {"material_index": 0, "normalize": False, "boundary_condition":
           {"type": "twist", "ratio": 0.1, "axis": 0, "velocity": 0.5}}),
         ("b", (Vb, Tb),
          {"offset": [0.2, -1.0, 0.0], "material_ids": "b_mat.dmat",
           "boundary_condition": {"type": "hangends", "axis": 0},
           "external_force": {
               "type": "press", "is_body_force": False, "axis": 1,
               "ratio": 0.2, "force": [0.0, -5.0, 0.0], "max_force": 50.0,
               "target_velocity": 0.05, "max_displacement": 0.3}})],
        dt=0.02, time_integrator="BDF2", max_newton_iterations=3,
        iterative_solver_tolerance=1e-6, mixed_variables=["mixed-stretch"],
        material_models=[
            {"energy": "Stable-Neohookean", "youngs_modulus": 1e5,
             "poissons_ratio": 0.4, "density": 1000.0},
            {"energy": "ARAP", "youngs_modulus": 5e4, "poissons_ratio": 0.3,
             "density": 800.0}],
        **extra)


@pytest.fixture(scope="module")
def scene_traj(tmp_path_factory):
    """load_scene(dim=2) in both packages (the port on the CPU), the coarse
    space enabled on both, and 3 steps of each."""
    path = _write_scene(tmp_path_factory.mktemp("scene2d"))
    js, ts = jload(path, dim=2), tload(path, dim=2, device="cpu")
    js.enable_coarse_preconditioner(16)
    ts.enable_coarse_preconditioner(16)
    out = [(js.mesh, ts.mesh, js.config, ts.config, ts.coarse)]
    for _ in range(3):
        js.step()
        ts.step()
        out.append((to_numpy(js.state), ts.state))
    return out


def test_load_scene_2d(scene_traj):
    jm, tm, jcfg, tcfg, coarse = scene_traj[0]
    assert tm.dim == 2 and coarse is not None
    for f in ("V0", "dphidX", "vols", "mass_coeff", "mass_diag", "free_mask",
              "mu", "lam", "ext_force"):
        close(getattr(tm, f), getattr(jm, f), rtol=1e-14, atol=1e-14)
    for f in ("T", "model_id", "obj_id", "F_srf", "E_srf"):
        np.testing.assert_array_equal(getattr(tm, f).numpy(),
                                      np.asarray(getattr(jm, f)))
    assert tm.models == jm.models == ("ARAP", "Stable-Neohookean")
    assert tcfg == type(tcfg)(**{
        k: v for k, v in jcfg.__dict__.items() if k != "matvec_scheme"})


def test_scene_trajectory_2d(scene_traj):
    """Positions, counts, alphas, the twist BC's motion and the press's
    force, step by step."""
    x_prev = None
    for js, ts in scene_traj[1:]:
        close(ts.x, js["x"], rtol=0, atol=1e-8)
        st = js["stats"]
        assert ts.stats.iterations == int(st["iterations"])
        np.testing.assert_array_equal(ts.stats.solver_iters.numpy(),
                                      st["solver_iters"])
        close(ts.stats.alpha, st["alpha"], rtol=0, atol=0)
        for tp, jp in zip(ts.press_states, js["press_states"]):
            assert tp.f == pytest.approx(float(jp["f"]), rel=1e-12)
        if x_prev is not None:
            assert float((ts.x - x_prev).abs().max()) > 1e-6
        x_prev = ts.x


def test_cli_steps_2d_scene(tmp_path, capsys):
    path = _write_scene(tmp_path)
    sim = tsim.main([path, "--dim", "2", "-n", "1", "--device", "cpu",
                     "--out", str(tmp_path / "out"), "--dtype", "float64"])
    assert sim.state.step_count == 1 and sim.state.x.shape[1] == 2
    assert torch.isfinite(sim.state.x).all()
    assert "Energy" in capsys.readouterr().out


def test_float32_2d_step_runs():
    """A float32 step of the cantilever through newton_step on the CPU,
    with the coarse space: finite, and the energies fall."""
    V, T, kw, _ = tri_arrays()
    tm = tmesh.build_mesh_data(V, T, dtype=torch.float32, device="cpu", **kw)
    tc = tcoarse.build_coarse_space(V, T, kw["is_fixed"], target_size=8,
                                    dtype=torch.float32, device="cpu")
    cfg = TConfig(**dict(STEP, dtype="float32"))
    x0 = torch.tensor(V, dtype=torch.float32)
    st = tnewton.init_state(tm, cfg, (), x0, torch.tensor(_swing(V)).float())
    st = dataclasses.replace(st, precond=torch.zeros((tc.ncd, tc.ncd)))
    st = tnewton.newton_step(tm, cfg, (), st, tc)
    it = st.stats.iterations
    assert torch.isfinite(st.x).all() and it == 3
    e = st.stats.energy[:it]
    assert e[-1] <= e[0]
