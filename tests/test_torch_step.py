"""Parity of mixedfem_tpu_torch's mesh, variables, coarse space and Newton
step with mixedfem_tpu's, in float64 on the CPU, on the bench's cantilever
beam at 360 tets (6x4x3 cells, banded element order).

Every port function gets the JAX function's inputs (carried across with
mixedfem_tpu_torch.convert) and is held to its output. Tolerances: the two
packages run the same algorithms in f64 with different summation orders,
so single functions agree to ~1e-12 relative; the 3-step trajectory is held
to 1e-8 (absolute, on positions of order 1), with equal CG counts and
Newton iterations."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mixedfem_tpu.config import SimConfig as JConfig
from mixedfem_tpu.mesh import mesh as jmesh
from mixedfem_tpu.ops import smallops as jsmall
from mixedfem_tpu.optimizer import newton as jnewton
from mixedfem_tpu.solvers import coarse as jcoarse
from mixedfem_tpu.variables import displacement as jdisp
from mixedfem_tpu.variables import mixed_stretch as jms
from mixedfem_tpu_torch.config import SimConfig as TConfig
from mixedfem_tpu_torch.integrators import bdf as tbdf
from mixedfem_tpu_torch.mesh import mesh as tmesh
from mixedfem_tpu_torch.ops import smallops as tsmall
from mixedfem_tpu_torch.optimizer import newton as tnewton
from mixedfem_tpu_torch.solvers import coarse as tcoarse
from mixedfem_tpu_torch.variables import displacement as tdisp
from mixedfem_tpu_torch.variables import mixed_stretch as tms

from torch_parity import (  # noqa: F401 (one_torch_thread is a fixture)
    CPU, beam_arrays, close, one_torch_thread, port, t64, to_numpy,
)


@pytest.fixture(scope="module", autouse=True)
def _one_thread(one_torch_thread):
    """Every test of this module runs on one torch intra-op thread."""


DT = 0.02
STEP = dict(
    h=DT, outer_steps=3, newton_tol=0.0, itr_tol=1e-4,
    max_iterative_solver_iters=500, coarse_refresh_every=2,
)


@pytest.fixture(scope="module")
def beam():
    V, T, kw, x = beam_arrays(seed=0)
    jm = jmesh.build_mesh_data(V, T, dtype=jnp.float64, **kw)
    tm, _, _ = port(mesh=jm)
    s = tms.reset(tm, t64(x))[0].numpy()
    s = s + 0.01 * np.random.default_rng(1).standard_normal(s.shape)
    return dict(V=V, T=T, kw=kw, x=x, s=s, jm=jm, tm=tm)


@pytest.fixture(scope="module")
def coeffs(beam):
    """StretchCoeffs of both packages at the same (x, s)."""
    j = jms.update(beam["jm"], jnp.asarray(beam["x"]), jnp.asarray(beam["s"]), DT)
    t = tms.update(beam["tm"], t64(beam["x"]), t64(beam["s"]), DT)
    return j, t


def _jax_coeffs_in_torch(j):
    return tms.StretchCoeffs(**{k: t64(v) for k, v in to_numpy(j).items()})


def test_build_mesh_data(beam):
    """The port's own host precompute gives the JAX package's arrays."""
    V, T, kw, jm = beam["V"], beam["T"], beam["kw"], beam["jm"]
    tm = tmesh.build_mesh_data(V, T, dtype=torch.float64, device="cpu", **kw)
    for f in ("V0", "dphidX", "vols", "mass_coeff", "mass_lumped",
              "mass_diag", "free_mask", "mu", "lam", "ext_force"):
        close(getattr(tm, f), getattr(jm, f), rtol=1e-14, atol=1e-14)
    np.testing.assert_array_equal(tm.T.numpy(), np.asarray(jm.T))
    np.testing.assert_array_equal(tm.model_id.numpy(), np.asarray(jm.model_id))
    assert tm.models == jm.models and tm.nv == jm.nv


def test_def_grad_and_mass_matvec(beam):
    x = beam["x"]
    close(tmesh.def_grad(beam["tm"], t64(x)),
          jmesh.def_grad(beam["jm"], jnp.asarray(x)), rtol=1e-13, atol=1e-13)
    ref = jmesh.mass_matvec(beam["jm"], jnp.asarray(x))
    close(tmesh.mass_matvec(beam["tm"], t64(x)), ref, rtol=1e-12,
          atol=1e-13 * float(jnp.max(jnp.abs(ref))))


def test_contractions(beam):
    rng = np.random.default_rng(2)
    E = beam["T"].shape[0]
    D = rng.standard_normal((E, 6, 3, 3))
    dphi = np.asarray(beam["jm"].dphidX)
    Hs = rng.standard_normal((E, 6, 6))
    vols = np.asarray(beam["jm"].vols)
    G_ref = jsmall.contract_D_dphi(jnp.asarray(D), jnp.asarray(dphi))
    Y_ref = jsmall.contract_sym_G(jnp.asarray(Hs), G_ref)
    close(tsmall.contract_D_dphi(t64(D), t64(dphi)), G_ref, rtol=1e-12, atol=1e-12)
    close(tsmall.contract_sym_G(t64(Hs), t64(G_ref)), Y_ref, rtol=1e-12, atol=1e-12)
    # K3's function on the CPU: (G, sqrt(vol) Hs G) in one call
    G, Gw = tsmall.contract_G_Gw(t64(D), t64(dphi), t64(Hs), t64(vols))
    close(G, G_ref, rtol=1e-12, atol=1e-12)
    Gw_ref = np.sqrt(vols)[:, None, None, None] * np.asarray(Y_ref)
    close(Gw, Gw_ref, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("E", [1, 31, 33, 103])
def test_contract_G_Gw_tile_edges(E):
    """K3's function on the CPU at element counts around its 32-element
    tiles (one element, a tile less one, a tile and one, a partial last
    tile) against JAX's contract_D_dphi and sqrt(vol) contract_sym_G."""
    rng = np.random.default_rng(E)
    D = rng.standard_normal((E, 6, 3, 3))
    dphi = rng.standard_normal((E, 4, 3))
    Hs = rng.standard_normal((E, 6, 6))
    vols = rng.uniform(0.1, 1.0, E)
    G_ref = jsmall.contract_D_dphi(jnp.asarray(D), jnp.asarray(dphi))
    Gw_ref = np.sqrt(vols)[:, None, None, None] * np.asarray(
        jsmall.contract_sym_G(jnp.asarray(Hs), G_ref))
    G, Gw = tsmall.contract_G_Gw(t64(D), t64(dphi), t64(Hs), t64(vols))
    close(G, G_ref, rtol=1e-12, atol=1e-12 * float(jnp.max(jnp.abs(G_ref))))
    close(Gw, Gw_ref, rtol=1e-12, atol=1e-12 * float(np.abs(Gw_ref).max()))


@pytest.mark.parametrize(
    "field", ["G", "Gw", "H", "Hinv", "g", "Sv", "R", "max_evals"]
)
def test_mixed_stretch_update(coeffs, field):
    j, t = coeffs
    ref = getattr(j, field)
    close(getattr(t, field), ref, rtol=1e-10,
          atol=1e-11 * float(jnp.max(jnp.abs(ref))))


def test_coeffs_from_FG(beam, coeffs):
    """The coefficient build from a given G (the JAX package's entry for
    its vertex-partitioned path)."""
    jm, s = beam["jm"], beam["s"]
    j, _ = coeffs
    args = (jm.vols, jm.mu, jm.lam, jm.model_id, jm.models, DT)
    ref = jms.coeffs_from_FG(None, j.G, j.R, j.Sv, jnp.asarray(s), *args)
    got = tms.coeffs_from_FG(
        None, t64(j.G), t64(j.R), t64(j.Sv), t64(s),
        *(t64(a) for a in args[:3]), torch.tensor(np.asarray(args[3])),
        jm.models, DT,
    )
    for f in ("Gw", "H", "g"):
        r = getattr(ref, f)
        close(getattr(got, f), r, rtol=1e-10,
              atol=1e-11 * float(jnp.max(jnp.abs(r))))


def test_rhs_diag_blocks_local_solve(beam, coeffs):
    jm, tm, s = beam["jm"], beam["tm"], beam["s"]
    j, _ = coeffs
    c = _jax_coeffs_in_torch(j)
    ref = jms.rhs_contrib(jm, j, jnp.asarray(s))
    close(tms.rhs_contrib(tm, c, t64(s)), ref, rtol=1e-12,
          atol=1e-13 * float(jnp.max(jnp.abs(ref))))
    ref = jms.diag_blocks_contrib(jm, j)
    close(tms.diag_blocks_contrib(tm, c), ref, rtol=1e-12,
          atol=1e-13 * float(jnp.max(jnp.abs(ref))))
    dx = 1e-3 * np.random.default_rng(3).standard_normal(beam["x"].shape)
    ds_j, la_j = jms.local_solve(jm, j, jnp.asarray(s), jnp.asarray(dx))
    ds_t, la_t = tms.local_solve(tm, c, t64(s), t64(dx))
    close(ds_t, ds_j, rtol=1e-12, atol=1e-14)
    close(la_t, la_j, rtol=1e-11, atol=1e-12 * float(jnp.max(jnp.abs(la_j))))


def test_energies(beam):
    jm, tm, x, s = beam["jm"], beam["tm"], beam["x"], beam["s"]
    la = np.random.default_rng(4).standard_normal(s.shape)
    close(tms.energy(tm, t64(s)), jms.energy(jm, jnp.asarray(s)), rtol=1e-12)
    close(tms.constraint_value(tm, t64(x), t64(s), t64(la)),
          jms.constraint_value(jm, jnp.asarray(x), jnp.asarray(s),
                               jnp.asarray(la)), rtol=1e-10)
    # inertia energy and per-corner gradient contributions under BDF1
    v0 = np.zeros_like(x)
    from mixedfem_tpu.integrators import bdf as jbdf

    jb = jbdf.bdf_init("BDF1", jnp.asarray(beam["V"]), jnp.asarray(v0), DT)
    tb = tbdf.bdf_init("BDF1", t64(beam["V"]), t64(v0), DT)
    close(tdisp.energy(tm, tb, t64(x)), jdisp.energy(jm, jb, jnp.asarray(x)),
          rtol=1e-12)
    ref = jdisp.gradient_contrib(jm, jb, jnp.asarray(x))
    close(tdisp.gradient_contrib(tm, tb, t64(x)), ref, rtol=1e-12,
          atol=1e-13 * float(jnp.max(jnp.abs(ref))))


@pytest.mark.parametrize("order", ["BDF1", "BDF2", "BDF3"])
def test_bdf_ring_buffer(order):
    from mixedfem_tpu.integrators import bdf as jbdf

    rng = np.random.default_rng(5)
    x0, v0 = rng.standard_normal((7, 3)), rng.standard_normal((7, 3))
    jb = jbdf.bdf_init(order, jnp.asarray(x0), jnp.asarray(v0), 0.01)
    tb = tbdf.bdf_init(order, t64(x0), t64(v0), 0.01)
    for _ in range(3):
        x = rng.standard_normal((7, 3))
        jb = jbdf.bdf_update(jb, jnp.asarray(x))
        tb = tbdf.bdf_update(tb, t64(x))
    close(tb.x_hist, jb.x_hist, rtol=1e-14)
    close(tb.v_hist, jb.v_hist, rtol=1e-12)
    close(tbdf.bdf_x_tilde(tb), jbdf.bdf_x_tilde(jb), rtol=1e-12)
    assert tbdf.bdf_dt(tb) == jbdf.bdf_dt(jb)


@pytest.fixture(scope="module")
def coarse_pair(beam):
    """The same coarse space in both packages: the JAX package's, carried
    across, and the port's own host build."""
    V, T, fixed = beam["V"], beam["T"], beam["kw"]["is_fixed"]
    jc = jcoarse.build_coarse_space(V, T, fixed, target_size=8,
                                    dtype=jnp.float64)
    tc = tcoarse.build_coarse_space(V, T, fixed, target_size=8,
                                    dtype=torch.float64, device="cpu")
    return jc, tc


def test_build_coarse_space(coarse_pair):
    jc, tc = coarse_pair
    assert tc.naggr == jc.naggr and tc.ncd == jc.ncd
    for f in ("agg_id", "pair_id", "pair_rows", "pair_cols"):
        np.testing.assert_array_equal(getattr(tc, f).numpy(),
                                      np.asarray(getattr(jc, f)))
    close(tc.r, jc.r, rtol=0, atol=1e-15)


@pytest.fixture(scope="module")
def coarse_mats(beam, coeffs, coarse_pair):
    jc, tc = coarse_pair
    j, _ = coeffs
    Ac_j = jcoarse.coarse_matrix(beam["jm"], jc, j)
    Ac_t = tcoarse.coarse_matrix(beam["tm"], tc, _jax_coeffs_in_torch(j))
    return np.asarray(Ac_j), Ac_t


def test_coarse_matrix(coarse_mats):
    Ac_j, Ac_t = coarse_mats
    close(Ac_t, Ac_j, rtol=1e-12, atol=1e-13 * np.abs(Ac_j).max())


@pytest.mark.parametrize("start", ["cold", "warm", "rejected"])
def test_coarse_inverse_ns(coarse_mats, start):
    """Cold start, a usable warm start, and a warm start that the spectral
    safeguard rejects (a zero cache)."""
    Ac_j, _ = coarse_mats
    X0 = {
        "cold": None,
        "warm": np.linalg.inv(Ac_j) * (1.0 + 1e-3),
        "rejected": np.zeros_like(Ac_j),
    }[start]
    ref = jcoarse.coarse_inverse_ns(
        jnp.asarray(Ac_j), None if X0 is None else jnp.asarray(X0)
    )
    got = tcoarse.coarse_inverse_ns(t64(Ac_j), None if X0 is None else t64(X0))
    close(got, ref, rtol=1e-9, atol=1e-12 * float(jnp.max(jnp.abs(ref))))


def test_two_level_preconditioner(beam, coarse_pair, coarse_mats):
    from mixedfem_tpu.solvers import pcg as jpcg
    from mixedfem_tpu_torch.solvers import pcg as tpcg

    jc, tc = coarse_pair
    jm, tm = beam["jm"], beam["tm"]
    rng = np.random.default_rng(6)
    A = rng.standard_normal((jm.nv, 3, 3))
    blocks = np.einsum("nij,nkj->nik", A, A) + np.eye(3)
    r = rng.standard_normal((jm.nv, 3))
    Ac_inv = np.linalg.inv(coarse_mats[0])
    ref = jcoarse.two_level_preconditioner(
        jc, jm.free_mask, jpcg.block_jacobi_inv(jnp.asarray(blocks), jm.free_mask), 3
    )(jnp.asarray(r), jnp.asarray(Ac_inv))
    got = tcoarse.two_level_preconditioner(
        tc, tm.free_mask, tpcg.block_jacobi_inv(t64(blocks), tm.free_mask)
    )(t64(r), t64(Ac_inv))
    close(got, ref, rtol=1e-11, atol=1e-12 * float(jnp.max(jnp.abs(ref))))


@pytest.fixture(scope="module")
def trajectory(beam, coarse_pair):
    """3 BDF1 steps of both packages from the same state, with the
    two-level preconditioner refreshed every 2nd step. The state starts with
    a zero coarse cache, so step 0 exercises the safeguard's rejection,
    step 1 the cached inverse and step 2 a warm-started refresh."""
    V, jm = beam["V"], beam["jm"]
    jc, _ = coarse_pair
    jcfg, tcfg = JConfig(**STEP), TConfig(**STEP)
    st = jnewton.init_state(jm, jcfg, (), jnp.asarray(V), jnp.zeros_like(jnp.asarray(V)))
    st = st.replace(precond=jnp.zeros((jc.ncd, jc.ncd)))
    tm, ts, tc = port(mesh=jm, state=st, coarse=jc)
    out = []
    for _ in range(3):
        st = jnewton.newton_step(jm, jcfg, (), st, jc)
        ts = tnewton.newton_step(tm, tcfg, (), ts, tc)
        out.append((to_numpy(st), ts))
    return out


def test_trajectory_positions(trajectory):
    for js, ts in trajectory:
        close(ts.x, js["x"], rtol=0, atol=1e-8)
        close(ts.s, js["s"], rtol=0, atol=1e-8)
        close(ts.bdf.v_hist, js["bdf"]["v_hist"], rtol=0, atol=1e-6)
        assert ts.step_count == int(js["step_count"])
        assert not ts.la.any()


def test_trajectory_counts(trajectory):
    for js, ts in trajectory:
        assert ts.stats.iterations == int(js["stats"]["iterations"])
        np.testing.assert_array_equal(
            ts.stats.solver_iters.numpy(), js["stats"]["solver_iters"]
        )


def test_trajectory_stats(trajectory):
    for js, ts in trajectory:
        st = js["stats"]
        close(ts.stats.energy, st["energy"], rtol=1e-10)
        close(ts.stats.alpha, st["alpha"], rtol=0, atol=0)
        close(ts.stats.decrement, st["decrement"], rtol=1e-6, atol=1e-12)
        close(ts.stats.solver_error, st["solver_error"], rtol=1e-5, atol=1e-10)
        close(ts.precond, js["precond"], rtol=1e-8,
              atol=1e-10 * np.abs(js["precond"]).max())


def test_step_rejects_uncovered_paths(beam):
    """newton_step refuses a host solver with the JAX step's ValueError
    (Simulation.step routes those to newton_direct), and the float64 rhs
    islands of a float32 state where the JAX step refuses them (a
    full-system solver) with NotImplementedError; rotation_warm_start and
    the islands of the condensed pcg family run."""
    tm = beam["tm"]
    x0 = t64(beam["V"])
    st = tnewton.init_state(tm, TConfig(**STEP), (), x0, torch.zeros_like(x0))
    with pytest.raises(ValueError):
        tnewton.newton_step(tm, TConfig(**STEP, solver="direct"), (), st)
    warm = TConfig(**STEP, rotation_warm_start=True)
    stw = tnewton.init_state(tm, warm, (), x0, torch.zeros_like(x0))
    assert torch.isfinite(tnewton.newton_step(tm, warm, (), stw).R).all()
    tm32 = tmesh.build_mesh_data(beam["V"], beam["T"], dtype=torch.float32,
                                 device="cpu", **beam["kw"])
    x32 = x0.float()
    st32 = tnewton.init_state(tm32, TConfig(**STEP, dtype="float32"), (),
                              x32, torch.zeros_like(x32))
    with pytest.raises(NotImplementedError):
        tnewton.newton_step(
            tm32, TConfig(**STEP, dtype="float32", rhs_precision="float64",
                          solver="minres-kkt"), (), st32)
    out = tnewton.newton_step(
        tm32, TConfig(**STEP, dtype="float32", rhs_precision="float64"), (),
        st32)
    assert out.x.dtype == torch.float32 and torch.isfinite(out.x).all()
    assert st.x.device == CPU
