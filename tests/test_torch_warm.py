"""Parity of mixedfem_tpu_torch's warm-started rotations
(config.rotation_warm_start: rotation.polar_warm seeded with the previous
Newton iterate's rotations, SimState.R carried from step to step) with
mixedfem_tpu's, in float64 on the CPU.

polar_warm and _rodrigues on tests/test_rotation_warm.py's inputs to
1e-12, the branch tracked through an inversion, init_state's R0, convert
carrying R, warm start against the stateless polar off inversion, and a
4-step trajectory of tests/test_rotation_warm.py's squashed beam
(small_beam(6, 3, 3), its free part squashed to 10% along x, which
inverts the elements there) against the JAX step's. That trajectory is
rounding-chaotic: the JAX step moves its own positions, rotations and CG
counts as far when x0 moves by one ulp, so the test runs that perturbed
JAX trajectory beside it and holds the port to it (positions to 1e-8 and
within twice JAX's own parting, R within twice JAX's own parting, Newton
counts and alphas equal, CG counts within 2%), printing the margins.
The grid-plan and rod trajectories with warm start are
tests/test_torch_warm_grid.py's and tests/test_torch_warm_rod.py's."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mixedfem_tpu.config import SimConfig as JConfig
from mixedfem_tpu.integrators import bdf as jbdf
from mixedfem_tpu.ops import rotation as jrot
from mixedfem_tpu.optimizer import newton as jnewton
from mixedfem_tpu.variables import mixed_stretch as jms
from mixedfem_tpu_torch.config import SimConfig as TConfig
from mixedfem_tpu_torch.integrators import bdf as tbdf
from mixedfem_tpu_torch.mesh import mesh as tmesh
from mixedfem_tpu_torch.ops import rotation as trot
from mixedfem_tpu_torch.optimizer import newton as tnewton
from mixedfem_tpu_torch.variables import mixed_stretch as tms

from solver_parity import MINRES_BAND, rounding_band
from test_newton import small_beam
from torch_parity import (  # noqa: F401 (one_torch_thread is a fixture)
    close, one_torch_thread, port, t64, to_numpy,
)


@pytest.fixture(scope="module", autouse=True)
def _one_thread(one_torch_thread):
    """Every test of this module runs on one torch intra-op thread."""


# the JAX references, jitted once (eager, each call compiles op by op)
_JWARM = jax.jit(jrot.polar_warm, static_argnames=("iters",))
_JUPDATE = jax.jit(jms.update)
_JMERIT = jax.jit(jnewton._total_energy, static_argnums=(6, 7))


def _polar_inputs():
    """tests/test_rotation_warm.py's first case: 64 F near I and seeds
    R0 = R(F) exp(w^) off the optimum."""
    rng = np.random.default_rng(0)
    F = rng.standard_normal((64, 3, 3)) * 0.3 + np.eye(3)
    R_ref, _ = jax.jit(jrot.polar33, static_argnames=("sweeps",))(
        jnp.asarray(F), sweeps=10)
    w = rng.standard_normal((64, 3)) * 0.3
    R0 = jnp.einsum("eik,ekj->eij", R_ref, jrot._rodrigues(jnp.asarray(w)))
    return F, w, np.asarray(R0), np.asarray(R_ref)


@pytest.mark.parametrize("iters", [5, 6])
def test_polar_warm(iters):
    """polar_warm and _rodrigues against JAX to 1e-12, converging to the
    stateless polar at 6 iterations (as the JAX test asserts)."""
    F, w, R0, R_ref = _polar_inputs()
    close(trot._rodrigues(t64(w)), jrot._rodrigues(jnp.asarray(w)),
          rtol=0, atol=1e-12)
    # the small-angle branch
    tiny = 1e-13 * w
    close(trot._rodrigues(t64(tiny)), jrot._rodrigues(jnp.asarray(tiny)),
          rtol=0, atol=1e-15)
    R, S = trot.polar_warm(t64(F), t64(R0), iters=iters)
    Rj, Sj = _JWARM(jnp.asarray(F), jnp.asarray(R0), iters=iters)
    close(R, Rj, rtol=0, atol=1e-12)
    close(S, Sj, rtol=0, atol=1e-12)
    if iters == 6:
        close(R, R_ref, rtol=0, atol=1e-10)


def test_polar_warm_expanded_seed():
    """A broadcast identity seed (a strided view) and far-off F: the same
    result as JAX's, and orthonormal R (tests/test_rotation_warm.py's
    second case)."""
    F = np.random.default_rng(1).standard_normal((32, 3, 3))
    R0 = torch.eye(3, dtype=torch.float64).expand(32, 3, 3)
    R, _ = trot.polar_warm(t64(F), R0, iters=8)
    Rj, _ = _JWARM(jnp.asarray(F), jnp.broadcast_to(jnp.eye(3), (32, 3, 3)),
                   iters=8)
    close(R, Rj, rtol=0, atol=1e-12)
    close(R.transpose(1, 2) @ R, np.tile(np.eye(3), (32, 1, 1)), rtol=0,
          atol=1e-10)


def test_tracks_branch_through_inversion():
    """F from I to diag(-0.5, 1, 1) through zero volume: R stays I and S
    carries the negative stretch, step for step as in JAX."""
    Rt = torch.eye(3, dtype=torch.float64)[None]
    Rj = jnp.eye(3)[None]
    for t in np.linspace(0.0, 1.0, 21):
        F = np.diag([1 - 1.5 * t, 1.0, 1.0])[None]
        Rt, St = trot.polar_warm(t64(F), Rt, iters=6)
        Rj, Sj = _JWARM(jnp.asarray(F), Rj, iters=6)
        close(Rt, Rj, rtol=0, atol=1e-12)
        close(St, Sj, rtol=0, atol=1e-12)
    close(Rt[0], np.eye(3), rtol=0, atol=1e-8)
    assert float(St[0, 0, 0]) < 0


# tests/test_rotation_warm.py:TestWarmStartStep's configuration
WARM = dict(h=0.02, outer_steps=6, newton_tol=0.0, itr_tol=1e-10,
            max_iterative_solver_iters=5000,
            mixed_variables=("mixed-stretch",), dtype="float64",
            rotation_warm_start=True)


def _squashed(mesh, V):
    """The free part squashed to 10% along x about the pinned face."""
    V2 = np.asarray(V).copy()
    fixed = np.asarray(mesh.free_mask) == 0
    x_pin = V2[fixed, 0].max()
    V2[:, 0] = np.where(fixed, V2[:, 0], x_pin - 0.1 * (V2[:, 0] - x_pin))
    return V2


@pytest.fixture(scope="module")
def squashed():
    mesh, V = small_beam(6, 3, 3)
    V2 = _squashed(mesh, V)
    jcfg = JConfig(**WARM)
    st = jnewton.init_state(mesh, jcfg, (), jnp.asarray(V2),
                            jnp.zeros(V2.shape))
    return dict(mesh=mesh, V2=V2, jcfg=jcfg, st=st,
                jstep=jax.jit(lambda s: jnewton.newton_step(mesh, jcfg, (),
                                                            s)))


def test_init_state_rotations(squashed):
    """R0 is the stateless polar's R of x0 under the JAX predicate, and
    (0, 3, 3) without warm start, in 2D or without mixed-stretch; convert
    carries R both ways of that."""
    mesh, V2, st = squashed["mesh"], squashed["V2"], squashed["st"]
    tm, ts, _ = port(mesh=mesh, state=st)
    assert ts.R.shape == (mesh.T.shape[0], 3, 3)
    close(ts.R, st.R, rtol=0, atol=0)
    x0 = t64(V2)
    R0 = tnewton.init_state(tm, TConfig(**WARM), (), x0, torch.zeros_like(x0)).R
    close(R0, st.R, rtol=0, atol=1e-12)
    det = torch.linalg.det(tmesh.def_grad(tm, x0))
    assert int((det < 0).sum()) > 0
    for over in (dict(rotation_warm_start=False),
                 dict(mixed_variables=("mixed-collision",))):
        cfg = dict(WARM, **over)
        got = tnewton.init_state(tm, TConfig(**cfg), (), x0,
                                 torch.zeros_like(x0)).R
        want = jnewton.init_state(mesh, JConfig(**cfg), (), jnp.asarray(V2),
                                  jnp.zeros(V2.shape)).R
        assert got.shape == want.shape == (0, 3, 3)
    # a JAX state without R converts to (0, 3, 3)
    assert port(mesh=mesh, state=st.replace(R=jnp.zeros((0, 3, 3))))[1].R.shape \
        == (0, 3, 3)


def test_squashed_trajectory(squashed):
    """4 steps of 6 Newton iterations from the squashed start, port against
    JAX, beside JAX against itself from x0 moved by one ulp."""
    mesh, st, jstep = squashed["mesh"], squashed["st"], squashed["jstep"]
    free = np.asarray(mesh.free_mask) > 0
    V1 = squashed["V2"].copy()
    V1[free] = np.nextafter(V1[free], np.inf)
    su = jnewton.init_state(mesh, squashed["jcfg"], (), jnp.asarray(V1),
                            jnp.zeros(V1.shape))
    tm, ts, _ = port(mesh=mesh, state=st)
    tcfg = TConfig(**WARM)
    for k in range(4):
        st, su = jstep(st), jstep(su)
        ts = tnewton.newton_step(tm, tcfg, (), ts)
        js, ju = to_numpy(st), to_numpy(su)
        dx = np.abs(ts.x.numpy() - js["x"]).max()
        dR = np.abs(ts.R.numpy() - js["R"]).max()
        ux = np.abs(ju["x"] - js["x"]).max()
        uR = np.abs(ju["R"] - js["R"]).max()
        cg_t = ts.stats.solver_iters.tolist()
        cg_j = js["stats"]["solver_iters"].tolist()
        F = tmesh.def_grad(tm, ts.x)
        off = int(((trot.polar_warm(F, ts.R)[1] - trot.polar33(F)[1])
                   .abs().amax(dim=(1, 2)) > 1e-6).sum())
        print(f"step {k}: |x - x_jax| {dx:.2e} (JAX one ulp away {ux:.2e}), "
              f"|R - R_jax| {dR:.2e} ({uR:.2e}); CG {cg_t}, JAX {cg_j}, "
              f"JAX one ulp away {ju['stats']['solver_iters'].tolist()}; "
              f"elements off the stateless branch {off}")
        assert dx <= 1e-8 and dx <= 2 * ux
        assert dR <= 2 * uR
        assert ts.stats.iterations == int(js["stats"]["iterations"]) == 6
        close(ts.stats.alpha, js["stats"]["alpha"], rtol=0, atol=0)
        # the band solver_parity.py gives rounding-decided Krylov counts
        for a, b in zip(cg_t, cg_j):
            assert abs(a - b) <= rounding_band(b, MINRES_BAND), (cg_t, cg_j)
    # every element back to positive volume, as the JAX test asserts
    assert float(torch.linalg.det(tmesh.def_grad(tm, ts.x)).min()) > 0


def test_base_merit_and_trial_merit_branches():
    """Kept on purpose, as in the JAX step: the base-point merit reuses the
    update's (warm) stretch Sv, a trial point's merit, alpha = 0 included,
    the stateless polar's. A beam mirrored through its pinned face (F =
    diag(-2, 1, 1) in every element) seeded at R = I stays on the branch
    S = diag(-2, 1, 1), while the stateless signed SVD gives the sign to a
    smallest singular value; there the two merits differ, in both packages
    alike. (The squashed beam of test_squashed_trajectory never leaves the
    stateless branch, so its trajectory does not exercise this.)"""
    mesh, V = small_beam(2, 1, 1)
    tm, _, _ = port(mesh=mesh)
    x = V * np.array([-2.0, 1.0, 1.0])
    close(tmesh.def_grad(tm, t64(x)),
          np.tile(np.diag([-2.0, 1.0, 1.0]), (tm.nelem, 1, 1)), rtol=0,
          atol=1e-12)
    jbdf_ = jbdf.bdf_init("BDF1", jnp.asarray(V), jnp.zeros(V.shape), 0.02)
    tbdf_ = tbdf.bdf_init("BDF1", t64(V), torch.zeros(V.shape,
                                                       dtype=torch.float64), 0.02)
    rng = np.random.default_rng(3)
    s = rng.uniform(0.9, 1.1, (tm.nelem, 6))
    la = rng.standard_normal((tm.nelem, 6))
    eye = np.tile(np.eye(3), (tm.nelem, 1, 1))
    cw = tms.update(tm, t64(x), t64(s), 0.02, R_prev=t64(eye))
    cj = _JUPDATE(mesh, jnp.asarray(x), jnp.asarray(s), 0.02,
                  R_prev=jnp.asarray(eye))
    close(cw.R, eye, rtol=0, atol=1e-12)
    close(cw.Sv, cj.Sv, rtol=0, atol=1e-12)
    merits = {}
    for name, (Svt, Svj) in (("warm", (cw.Sv, cj.Sv)),
                             ("stateless", (None, None))):
        got = tnewton._total_energy(tm, tbdf_, 4e-4, t64(x), t64(s),
                                    t64(la), Sv=Svt)
        want = _JMERIT(mesh, jbdf_, 4e-4, jnp.asarray(x), jnp.asarray(s),
                       jnp.asarray(la), True, False, Svj)
        close(got, want, rtol=1e-12)
        merits[name] = float(got)
    print(f"merit at alpha = 0: warm {merits['warm']:.9e}, stateless "
          f"{merits['stateless']:.9e}")
    assert abs(merits["warm"] - merits["stateless"]) > 1e-6 * abs(
        merits["warm"])


def test_warm_equals_cold_off_inversion():
    """Away from inversion the warm start is an exact reformulation
    (tests/test_rotation_warm.py's last case): 3 steps of small_beam(5, 2,
    2) warm and stateless agree to 1e-9 of scale."""
    mesh, V = small_beam(5, 2, 2)
    tm, _, _ = port(mesh=mesh)
    xs = {}
    for warm in (False, True):
        cfg = TConfig(h=0.02, outer_steps=4, itr_tol=1e-11,
                      max_iterative_solver_iters=5000,
                      mixed_variables=("mixed-stretch",), dtype="float64",
                      rotation_warm_start=warm)
        x0 = t64(V)
        ts = tnewton.init_state(tm, cfg, (), x0, torch.zeros_like(x0))
        assert ts.R.shape[0] == (tm.nelem if warm else 0)
        for _ in range(3):
            ts = tnewton.newton_step(tm, cfg, (), ts)
        xs[warm] = ts.x
        if warm:
            assert ts.R.shape == (tm.nelem, 3, 3)
    scale = float(xs[False].abs().max())
    close(xs[True], xs[False].numpy(), rtol=0, atol=1e-9 * scale)


def test_host_loop_and_2d_leave_rotations_behind():
    """The JAX host loop's SimState takes the default R, and a 2D mesh
    never warm-starts (its polar is the closed-form 2x2)."""
    from mixedfem_tpu_torch.optimizer import newton_direct as tdirect
    from torch_parity import tri_arrays

    mesh, V = small_beam(3, 1, 1)
    tm, _, _ = port(mesh=mesh)
    cfg = TConfig(**dict(WARM, solver="eigen-llt", outer_steps=2))
    x0 = t64(V)
    ts = tnewton.init_state(tm, cfg, (), x0, torch.zeros_like(x0))
    assert ts.R.shape[0] == tm.nelem
    assert tdirect.newton_step_direct(tm, cfg, (), ts).R.shape == (0, 3, 3)
    V2, T2, kw, _ = tri_arrays(4, 2)
    t2 = tmesh.build_mesh_data(V2, T2, dtype=torch.float64, device="cpu", **kw)
    cfg2 = dataclasses.replace(cfg, solver="pcg")
    s2 = tnewton.init_state(t2, cfg2, (), t64(V2), torch.zeros(V2.shape,
                                                               dtype=torch.float64))
    assert s2.R.shape == (0, 3, 3)
    assert tnewton.newton_step(t2, cfg2, (), s2).R.shape == (0, 3, 3)
