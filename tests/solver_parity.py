"""Shared pieces of the solver-family parity tests
(tests/test_torch_solvers_*.py): tolerances, 3-step trajectories of both
packages with the port's top-level solves recorded, and the check of
MINRES counts.

MINRES on the mixed KKT system of a Stable-Neo-Hookean solid (whose
stretch Hessians need the PSD clamp at 1e-8, a condition number near
1e11) stops where rounding puts it. On one and the same system the JAX
package stops at 374 iterations and the port at 372; the port with exact
dot products (math.fsum) stops at 372 too and with jnp.vdot's rounding at
373 or 374 (two measurements), while no 1-ulp change of the system's
inputs moves either count. The two packages' MINRES iterates agree to 1e-12 over 60
iterations on a well-conditioned system (test_torch_solvers_kkt.py), so
they run the same recurrence; on these systems the counts agree to within
2% (seen: 4 of 244 on the grid). check_minres_counts holds the
trajectories' MINRES counts to that: equal, or, where one differs, within
2% (at least 1) of JAX's count both in the trajectory and on the port's
own system of that Newton iteration solved by the JAX package's MINRES
(the margins print under -s). CG counts are held equal, except on the
grid, whose stencil sums run in another order than the JAX package's
(ops/stencil.py), where one count of 61 came out 60: there they are held
to the same 2% band.

With contact the coupled systems carry the barrier Hessians and every
Krylov count there is decided by rounding: at itr_tol 1e-4 the first
solve of the first step, whose input is the same in both packages, takes
26 dual-Schur CG iterations in the JAX package and 38 in the port. The
contact scenes' counts are held to a band of 10% (compare_steps' `band`),
and their positions, alphas, Newton counts and frames inside dhat
exactly.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from mixedfem_tpu.integrators import bdf as jbdf
from mixedfem_tpu.solvers import admm as jadmm
from mixedfem_tpu.solvers import minres as jmr
from mixedfem_tpu.variables import mixed_collision as jmc
from mixedfem_tpu.variables import mixed_stretch as jms
from mixedfem_tpu_torch.solvers import admm as tadmm
from mixedfem_tpu_torch.solvers import dual as tdual
from mixedfem_tpu_torch.solvers import gauss_seidel as tgs
from mixedfem_tpu_torch.solvers import minres as tmr
from mixedfem_tpu_torch.solvers import pcg as tpcg

from torch_parity import SolveRecorder, close, to_numpy


def near(actual, expected, rtol=1e-10):
    """assert_allclose at rtol with an absolute floor of rtol x the largest
    expected value (entries zero in exact arithmetic)."""
    e = np.asarray(expected)
    close(actual, e, rtol=rtol,
          atol=rtol * max(float(np.abs(e).max()) if e.size else 0.0, 1e-300))


def near_tuple(actual, expected, rtol=1e-10):
    assert len(actual) == len(expected)
    for a, e in zip(actual, expected):
        near(a, e, rtol)


def swing(V):
    """A swinging cantilever's initial velocity, v_y = -2 x / 4: every
    Newton iteration of a step then stays above the merit's rounding
    floor."""
    v0 = np.zeros_like(V)
    v0[:, 1] = -2.0 * V[:, 0] / 4.0
    return v0


# the port's top-level solve of each path: (module, function, index of the
# iteration count in its result)
SOLVES = {
    "pcg-diag": (tpcg, "pcg", 1),
    "pcg-laplacian": (tpcg, "pcg", 1),
    "pcg-dualascent": (tpcg, "pcg", 1),
    "gauss-seidel": (tgs, "gs_solve", 1),
    "minres-kkt": (tmr, "minres", 1),
    "minres-kkt-admm": (tmr, "minres", 1),
    "dual-cg": (tdual, "solve_dual", -2),
    "admm": (tadmm, "solve_admm", 1),
}


def recorders(solver):
    """The recorders of a trajectory: the solve, and for the MINRES paths
    the KKT right-hand side of each Newton iteration (its arguments are
    the system's inputs)."""
    out = [SolveRecorder(*SOLVES[solver])]
    if solver in ("minres-kkt", "minres-kkt-admm"):
        out.append(SolveRecorder(tmr, "kkt_rhs", iters_at=None))
    return out


def jax_coeffs(c):
    """The port's StretchCoeffs as the JAX package's."""
    return jms.StretchCoeffs(**{f.name: jnp.asarray(getattr(c, f.name).numpy())
                                for f in dataclasses.fields(c)})


def jax_contact(cf, cc):
    """The port's ContactFrames and CollisionCoeffs (n real frames) as the
    JAX package's (C frames, the padded ones inactive)."""
    C, n = cf.frames.shape[0], cf.nreal
    jcf = jmc.ContactFrames(frames=jnp.asarray(cf.frames.numpy()),
                            ftype=jnp.asarray(cf.ftype.numpy()),
                            fmask=jnp.asarray(cf.fmask.numpy()))

    def pad(t):
        a = np.zeros((C,) + tuple(t.shape[1:]))
        a[:n] = t.numpy()
        return jnp.asarray(a)

    jcc = jmc.CollisionCoeffs(**{
        f: pad(getattr(cc, f)) for f in ("D", "Gx", "g", "H", "active", "d", "la")
    })
    return jcf, jcc


def jax_minres_count(jm, rhs_call, mr_call, config) -> int:
    """The JAX package's MINRES count on the port's system of one Newton
    iteration: its kkt_rhs inputs (mesh, bdf, coefficients, x, s, la and,
    with contact, the frames and their coefficients) carried across, with
    the preconditioner of config.solver."""
    (_, bdf, c, x, s, la), kw = rhs_call[0], rhs_call[1]
    jb = jbdf.BDFState(x_hist=jnp.asarray(bdf.x_hist.numpy()),
                       v_hist=jnp.asarray(bdf.v_hist.numpy()),
                       order=bdf.order, h=bdf.h)
    jc = jax_coeffs(c)
    jcf = jcc = None
    if kw.get("cf") is not None:
        jcf, jcc = jax_contact(kw["cf"], kw["cc"])
    if kw.get("extra_grad_x") is not None:
        raise NotImplementedError("nodal contact terms")
    rhs = jmr.kkt_rhs(jm, jb, jc, *(jnp.asarray(a.numpy()) for a in (x, s, la)),
                      blend=kw.get("blend", 1.0), cf=jcf, cc=jcc)
    A = jmr.kkt_operator(jm, jc, cf=jcf, cc=jcc)
    if config.solver == "minres-kkt-admm":
        M = jadmm.admm_preconditioner(
            jm, jc, rho_scale=config.admm_rho_scale,
            sweeps=config.admm_precond_sweeps,
            inner_iters=config.admm_inner_iters, cf=jcf, cc=jcc)
    else:
        M = jmr.kkt_block_diag_preconditioner(jm, jc, cf=jcf, cc=jcc)
    kw = mr_call[1]
    run = jax.jit(lambda b: jmr.minres(
        A, b, tuple(jnp.zeros_like(a) for a in b), kw["max_iters"], kw["tol"],
        M)[1])
    return int(run(rhs))


def rounding_band(n: int, frac: float) -> int:
    """A count band of frac n, at least 1."""
    return max(1, int(np.ceil(frac * n)))


MINRES_BAND = 0.02


def check_minres_counts(want, recs, first, label, jm, config, band):
    """The port's MINRES counts recs[0].calls[first:first + len(want)]
    equal JAX's `want`, or lie within a band (the larger of MINRES_BAND
    and `band`) of it and of the JAX package's count on the port's own
    system of that Newton iteration (jax_minres_count); such a count's
    margins are printed."""
    mr_rec, rhs_rec = recs
    calls = mr_rec.calls[first:first + len(want)]
    assert len(calls) == len(want)
    frac = max(MINRES_BAND, band)
    for i, (w, call) in enumerate(zip(want, calls)):
        got = call[2]
        if got == w:
            continue
        n_jax = jax_minres_count(jm, rhs_rec.calls[first + i], call, config)
        print(f"{label}, Newton iteration {i}: JAX {w}, port {got}; on the "
              f"port's system JAX {n_jax}; band {rounding_band(w, frac)}")
        assert abs(got - w) <= rounding_band(w, frac), label
        assert abs(got - n_jax) <= rounding_band(n_jax, frac), label


def check_counts(want, rec, first, label, band):
    """Equal counts, or with `band` > 0 within that fraction (printed)."""
    calls = rec.calls[first:first + len(want)]
    assert len(calls) == len(want)
    for i, (w, call) in enumerate(zip(want, calls)):
        got = call[2]
        if got == w:
            continue
        print(f"{label}, Newton iteration {i}: JAX {w}, port {got}; band "
              f"{rounding_band(w, band) if band else 0}")
        assert band and abs(got - w) <= rounding_band(w, band), label


def compare_steps(out, recs, label, jm=None, config=None, band=0.0):
    """Each (JAX state as numpy dicts, port state) of a trajectory:
    positions and stretches to 1e-8, equal Newton counts and alphas, and
    the solver counts: check_minres_counts for the MINRES paths, else
    equal, or within `band` where the caller gives one (the contact
    scenes, whose counts are decided by rounding); the multipliers
    cleared."""
    first = 0
    for k, (js, ts) in enumerate(out):
        close(ts.x, js["x"], rtol=0, atol=1e-8)
        close(ts.s, js["s"], rtol=0, atol=1e-8)
        it = ts.stats.iterations
        assert it == int(js["stats"]["iterations"])
        close(ts.stats.alpha, js["stats"]["alpha"], rtol=0, atol=0)
        want = js["stats"]["solver_iters"][:it].tolist()
        assert ts.stats.solver_iters[:it].tolist() == [
            c[2] for c in recs[0].calls[first:first + it]]
        if len(recs) > 1:
            check_minres_counts(want, recs, first, f"{label} step {k}", jm,
                                config, band)
        else:
            check_counts(want, recs[0], first, f"{label} step {k}", band)
        first += it
        assert not ts.la.any()


def step_both(jstep, tstep, jstate, tstate, recs, n=3):
    """n steps of both packages (jstep and tstep map a state to the next),
    the port's under the recorders `recs`: [(JAX state as numpy, port
    state)]."""
    out = []
    for r in recs:
        r.__enter__()
    try:
        for _ in range(n):
            jstate = jstep(jstate)
            tstate = tstep(tstate)
            out.append((to_numpy(jstate), tstate))
    finally:
        for r in recs:
            r.__exit__(None, None, None)
    return out


def kkt_inputs(DT=0.02):
    """The 360-tet beam at seeded positions and its stretches there,
    seeded multipliers, a seeded BDF1 history, and both packages'
    coefficients of one ms.update (the port's are JAX's, carried across):
    the inputs of the full-system functions. The material is Fung, whose
    stretch Hessians are positive definite here: Stable-Neo-Hookean's need
    the PSD clamp (eigenvalues of 1e-8 in 111 of 2160), which makes the KKT
    system's condition number about 1e11, so that the two packages'
    Krylov iterates part at 1e-6 after one iteration."""
    from mixedfem_tpu.mesh import mesh as jmesh
    from mixedfem_tpu_torch.integrators import bdf as tbdf
    from mixedfem_tpu_torch.variables import mixed_stretch as tms
    from torch_parity import beam_arrays, port, t64

    V, T, kw, x = beam_arrays(seed=0)
    kw = dict(kw, models=("Fung",))
    jm = jmesh.build_mesh_data(V, T, dtype=jnp.float64, **kw)
    tm, _, _ = port(mesh=jm)
    rng = np.random.default_rng(1)
    s = tms.reset(tm, t64(x))[0].numpy()
    la = 1e3 * rng.standard_normal(s.shape)
    jc = jms.update(jm, jnp.asarray(x), jnp.asarray(s), DT)
    tc = tms.StretchCoeffs(**{k: t64(v) for k, v in to_numpy(jc).items()})
    v0 = rng.standard_normal(V.shape)
    jb = jbdf.bdf_init("BDF1", jnp.asarray(V), jnp.asarray(v0), DT)
    tb = tbdf.bdf_init("BDF1", t64(V), t64(v0), DT)
    jr = jmr.kkt_rhs(jm, jb, jc, jnp.asarray(x), jnp.asarray(s), jnp.asarray(la))
    tr = tmr.kkt_rhs(tm, tb, tc, t64(x), t64(s), t64(la))
    return dict(V=V, x=x, s=s, la=la, jm=jm, tm=tm, jc=jc, tc=tc, jb=jb,
                tb=tb, jr=jr, tr=tr)


def random_tuple(shapes, seed):
    """Seeded standard normal arrays of the given shapes: (numpy, JAX,
    torch) tuples."""
    from torch_parity import t64

    rng = np.random.default_rng(seed)
    u = tuple(rng.standard_normal(sh) for sh in shapes)
    return u, tuple(map(jnp.asarray, u)), tuple(map(t64, u))


def beam_trajectory(solver, nx, ny, nz, recs, **cfg):
    """3 BDF1 steps of the swinging beam (beam_arrays(nx, ny, nz)) through
    both packages' newton_step with `solver` (itr_tol 1e-4, 3 Newton
    iterations): (trajectory, JAX mesh, JAX config)."""
    from mixedfem_tpu.config import SimConfig as JConfig
    from mixedfem_tpu.mesh import mesh as jmesh
    from mixedfem_tpu.optimizer import newton as jnewton
    from mixedfem_tpu.solvers import gauss_seidel as jgs
    from mixedfem_tpu_torch import convert
    from mixedfem_tpu_torch.config import SimConfig as TConfig
    from mixedfem_tpu_torch.optimizer import newton as tnewton
    from torch_parity import CPU, beam_arrays, port

    V, T, kw, _ = beam_arrays(nx, ny, nz)
    jm = jmesh.build_mesh_data(V, T, dtype=jnp.float64, **kw)
    step = dict(h=0.02, outer_steps=3, newton_tol=0.0, itr_tol=1e-4,
                max_iterative_solver_iters=500, dtype="float64",
                mixed_variables=("mixed-stretch",), solver=solver, **cfg)
    jcfg, tcfg = JConfig(**step), TConfig(**step)
    st = jnewton.init_state(jm, jcfg, (), jnp.asarray(V), jnp.asarray(swing(V)))
    tm, ts, _ = port(mesh=jm, state=st)
    jgp = tgp = None
    if solver == "gauss-seidel":
        jgp = jgs.build_gs_plan(T, len(V), dtype=jnp.float64)
        tgp = convert.gs_plan_from_numpy(to_numpy(jgp), torch.float64, CPU)
    if solver in ("pcg-laplacian", "pcg-dualascent"):
        # the JAX step's power-iteration start vector (laplacian.py:88)
        v = jax.random.normal(jax.random.PRNGKey(0), V.shape, jnp.float64)
        ts.power_v0 = convert.power_start_from_numpy(np.asarray(v),
                                                     torch.float64, CPU)
    out = step_both(
        lambda s: jnewton.newton_step(jm, jcfg, (), s, gs_plan=jgp),
        lambda s: tnewton.newton_step(tm, tcfg, (), s, gs_plan=tgp),
        st, ts, recs)
    return out, jm, jcfg


# the contact scenes' Krylov counts are decided by rounding (see above)
CONTACT_BAND = 0.1


def drop_scene_trajectory(tmp_path, name, **overrides):
    """The drop scene of tests/test_collision.py (torch_parity.
    write_drop_scene) with linear_solver `name` (and `overrides`), loaded
    by both packages and stepped 3 times through Simulation.step, held by
    compare_steps with CONTACT_BAND and with equal counts of frames inside
    dhat after each step; every step has active frames at a positive least
    mixed distance and no retry. Returns both packages'
    Simulations (JAX's, the port's)."""
    from mixedfem_tpu.io.scene import load_scene as jload
    from mixedfem_tpu_torch import convert
    from mixedfem_tpu_torch.io.scene import load_scene as tload
    from torch_parity import CPU, write_drop_scene

    path = write_drop_scene(tmp_path)
    over = dict(overrides, linear_solver=name)
    js = jload(path, dim=3, dtype="float64", overrides=over)
    ts = tload(path, dim=3, dtype="float64", overrides=over, device="cpu")
    solver = ts.config.solver
    if solver in ("pcg-laplacian", "pcg-dualascent"):
        v = jax.random.normal(jax.random.PRNGKey(0), ts.state.x.shape,
                              jnp.float64)
        ts.state.power_v0 = convert.power_start_from_numpy(
            np.asarray(v), torch.float64, CPU)
    recs = recorders(solver)
    from mixedfem_tpu.collision import distances as jdist
    from mixedfem_tpu_torch.collision import distances as tdist

    def inside(cf, x, dist, conv):
        """Real candidates with distance < dhat at positions x (conv makes
        the package's arrays)."""
        n = int((np.asarray(cf.fmask) > 0).sum())
        f = np.asarray(cf.frames)[:n].astype(np.int64)
        t = np.asarray(cf.ftype)[:n]
        D = np.asarray(dist.frame_distance(conv(np.asarray(x)[f]), conv(t)))
        return int((D < ts.config.dhat).sum())

    out = []
    for r in recs:
        r.__enter__()
    try:
        for _ in range(3):
            js.step()
            ts.step()
            n_j = inside(js.state.contact, js.state.x, jdist, jnp.asarray)
            n_t = inside(ts.state.contact, ts.state.x, tdist,
                         torch.as_tensor)
            assert n_t == n_j
            out.append((to_numpy(js.state), ts.state))
    finally:
        for r in recs:
            r.__exit__(None, None, None)
    assert ts.retries == 0
    compare_steps(out, recs, name, js.mesh, js.config, band=CONTACT_BAND)
    for (_, tst) in out:
        it = tst.stats.iterations
        assert int(tst.stats.active_frames[:it].max()) > 0
        assert float(tst.stats.min_distance[:it].min()) > 0
    return js, ts


def mesh_trajectory(V, jm, solver, jplan=None, tplan=None):
    """3 steps of both packages from the swinging state of JAX mesh jm (V
    its rest positions) with `solver` (itr_tol 1e-4, 3 Newton iterations)
    and the given matvec plans: (trajectory, recorders, JAX config)."""
    from mixedfem_tpu.config import SimConfig as JConfig
    from mixedfem_tpu.optimizer import newton as jnewton
    from mixedfem_tpu_torch import convert
    from mixedfem_tpu_torch.config import SimConfig as TConfig
    from mixedfem_tpu_torch.optimizer import newton as tnewton
    from torch_parity import CPU, port

    step = dict(h=0.02, outer_steps=3, newton_tol=0.0, itr_tol=1e-4,
                max_iterative_solver_iters=500, dtype="float64",
                mixed_variables=("mixed-stretch",), solver=solver)
    jcfg, tcfg = JConfig(**step), TConfig(**step)
    st = jnewton.init_state(jm, jcfg, (), jnp.asarray(V),
                            jnp.asarray(swing(V)))
    tm, ts, _ = port(mesh=jm, state=st)
    if solver == "pcg-laplacian":
        v = jax.random.normal(jax.random.PRNGKey(0), V.shape, jnp.float64)
        ts.power_v0 = convert.power_start_from_numpy(np.asarray(v),
                                                     torch.float64, CPU)
    recs = recorders(solver)
    out = step_both(
        lambda s: jnewton.newton_step(jm, jcfg, (), s, None, (), jplan),
        lambda s: tnewton.newton_step(tm, tcfg, (), s, None, (), tplan),
        st, ts, recs)
    return out, recs, jcfg
