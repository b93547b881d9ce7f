"""Parity of mixedfem_tpu_torch's solvers with contact frames (the
mixed-collision unknowns of the KKT system, the coupled dual Schur
complement, ADMM's contact rows, the dual-ascent preconditioner) with
mixedfem_tpu's, in float64 on the CPU.

The functions run on the drop scene's slab and box 0.02 apart (inside
dhat 0.03, seeded positions), over the candidates of a margin of 1.1 dhat:
the JAX package's padded frames (C of them) and the port's real ones
(n), with the JAX coefficients carried across, held to 1e-10 relative
(with an absolute floor of 1e-10 of the largest value) on the real
frames. The drop scene (tests/test_collision.py) steps 3 times with 3
Newton iterations through load_scene and Simulation.step with
admm-solver (the other contact solvers in test_torch_solvers_scene*.py;
solver_parity.drop_scene_trajectory):
positions to 1e-8, equal Newton counts and alphas, active frames, and
solver counts within the band that solver_parity explains. The JAX step's refusals of nodal contact
variables on the dual-Schur and ADMM paths hold in the port."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mixedfem_tpu.collision import broadphase as jbp
from mixedfem_tpu.config import enu_to_lame
from mixedfem_tpu.mesh import generators
from mixedfem_tpu.mesh import mesh as jmesh
from mixedfem_tpu.solvers import admm as jadmm
from mixedfem_tpu.solvers import dual as jdual
from mixedfem_tpu.solvers import laplacian as jlap
from mixedfem_tpu.solvers import minres as jmr
from mixedfem_tpu.variables import mixed_collision as jmc
from mixedfem_tpu.variables import mixed_stretch as jms
from mixedfem_tpu_torch.collision import broadphase as tbp
from mixedfem_tpu_torch.config import SimConfig as TConfig
from mixedfem_tpu_torch.optimizer import newton as tnewton
from mixedfem_tpu_torch.solvers import admm as tadmm
from mixedfem_tpu_torch.solvers import dual as tdual
from mixedfem_tpu_torch.solvers import laplacian as tlap
from mixedfem_tpu_torch.solvers import minres as tmr
from mixedfem_tpu_torch.variables import mixed_collision as tmc
from mixedfem_tpu_torch.variables import mixed_stretch as tms

import solver_parity as sp
from torch_parity import (  # noqa: F401 (one_torch_thread is a fixture)
    CPU, one_torch_thread, port, t64, to_numpy,
)

DHAT, KAPPA = 3e-2, 1e5


@pytest.fixture(scope="module", autouse=True)
def _one_thread(one_torch_thread):
    """Every test of this module runs on one torch intra-op thread."""


@pytest.fixture(scope="module")
def boxes():
    """The slab (pinned along x=0) and the box, seeded positions, JAX and
    port frames, the stretch and contact coefficients at a previous state
    with half the real frames active, and a KKT rhs."""
    V1, T1 = generators.box_tet_mesh(2, 1, 2, size=(1.0, 0.25, 1.0))
    V2, T2 = generators.box_tet_mesh(2, 1, 2, size=(0.4, 0.2, 0.4))
    V = np.concatenate([V1, V2 + np.array([0.3, 0.27, 0.3])])
    T = np.concatenate([T1, T2 + len(V1)])
    la_, mu = enu_to_lame(1e6, 0.40)
    is_fixed = np.zeros(len(V), bool)
    is_fixed[: len(V1)] = V1[:, 0] < 1e-9
    jm = jmesh.build_mesh_data(
        V, T, density=np.full(len(T), 1000.0), mu=np.full(len(T), mu),
        lam=np.full(len(T), la_), model_id=np.zeros(len(T), int),
        models=("Stable-Neohookean",), is_fixed=is_fixed,
        ext_force=np.tile([0.0, -9.8, 0.0], (len(V), 1)))
    tm, _, _ = port(mesh=jm)
    rng = np.random.default_rng(8)
    x = V + 2e-3 * rng.standard_normal(V.shape)
    F, E = np.asarray(jm.F_srf), np.asarray(jm.E_srf)
    f, t = jbp.candidates_3d(x, F, E, np.unique(F), 1.1 * DHAT)
    f, t, m = jbp.pad_candidates(f, t, tbp.capacity(len(f)))
    jcf = jmc.ContactFrames(frames=jnp.asarray(f), ftype=jnp.asarray(t),
                            fmask=jnp.asarray(m))
    tcf = tmc.contact_frames(f, t, m, len(V), torch.float64, CPU)
    C, n = len(f), tcf.nreal
    act = (rng.random(C) < 0.5).astype(np.float64)
    act[n:] = 0.0
    d, lac = rng.uniform(0.2, 1.2, C) * DHAT, rng.standard_normal(C)
    jcc = jmc.update(jm, jcf, jnp.asarray(x), *map(jnp.asarray, (d, lac, act)),
                     DHAT, KAPPA)
    tcc = tmc.CollisionCoeffs(**{
        k: t64(np.asarray(getattr(jcc, k))[:n])
        for k in ("D", "Gx", "g", "H", "active", "d", "la")})
    assert int(tcc.active.sum()) > 10
    s = tms.reset(tm, t64(x))[0].numpy()
    la = 1e3 * rng.standard_normal(s.shape)
    jc = jms.update(jm, jnp.asarray(x), jnp.asarray(s), 0.01)
    tc = tms.StretchCoeffs(**{k: t64(v) for k, v in to_numpy(jc).items()})
    from mixedfem_tpu.integrators import bdf as jbdf
    from mixedfem_tpu_torch.integrators import bdf as tbdf

    jb = jbdf.bdf_init("BDF1", jnp.asarray(V), jnp.zeros_like(jnp.asarray(V)), 0.01)
    tb = tbdf.bdf_init("BDF1", t64(V), torch.zeros(V.shape, dtype=torch.float64), 0.01)
    jr = jmr.kkt_rhs(jm, jb, jc, jnp.asarray(x), jnp.asarray(s), jnp.asarray(la),
                     cf=jcf, cc=jcc)
    tr = tmr.kkt_rhs(tm, tb, tc, t64(x), t64(s), t64(la), cf=tcf, cc=tcc)
    return dict(V=V, x=x, s=s, n=n, C=C, jm=jm, tm=tm, jcf=jcf, tcf=tcf,
                jcc=jcc, tcc=tcc, jc=jc, tc=tc, jr=jr, tr=tr)


def near_frames(t, j, n):
    """A tuple of (x, s, l[, d, lc]) blocks: the frame blocks on the real
    frames."""
    assert len(t) == len(j)
    for i, (a, b) in enumerate(zip(t, j)):
        sp.near(a, np.asarray(b)[:n] if i >= 3 else b)


def _tuple(b, seed):
    """Seeded (x, s, l, d, lc) tuples: JAX's over C frames, the port's
    over the n real ones."""
    rng = np.random.default_rng(seed)
    u = (rng.standard_normal(b["V"].shape), rng.standard_normal(b["s"].shape),
         rng.standard_normal(b["s"].shape), rng.standard_normal(b["C"]),
         rng.standard_normal(b["C"]))
    n = b["n"]
    return (tuple(map(jnp.asarray, u)),
            tuple(t64(a[:n] if i >= 3 else a) for i, a in enumerate(u)))


def test_kkt_with_contact(boxes):
    b, n = boxes, boxes["n"]
    near_frames(b["tr"], b["jr"], n)
    ju, tu = _tuple(b, 2)
    kw_j, kw_t = dict(cf=b["jcf"], cc=b["jcc"]), dict(cf=b["tcf"], cc=b["tcc"])
    near_frames(tmr.kkt_operator(b["tm"], b["tc"], **kw_t)(tu),
                jmr.kkt_operator(b["jm"], b["jc"], **kw_j)(ju), n)
    near_frames(tmr.kkt_block_diag_preconditioner(b["tm"], b["tc"], **kw_t)(tu),
                jmr.kkt_block_diag_preconditioner(b["jm"], b["jc"], **kw_j)(ju),
                n)


def test_solve_dual_with_contact(boxes):
    """The coupled Schur complement by pcg_tree, 5 iterations (dd is a
    cancellation, hc_inv (r_d + dlc), and parts at 1e-10 of its scale
    within 10 iterations)."""
    b, n = boxes, boxes["n"]
    j = jax.jit(lambda r: jdual.solve_dual(
        b["jm"], b["jc"], r, max_iters=5, tol=0.0, cf=b["jcf"], cc=b["jcc"])
    )(b["jr"])
    t = tdual.solve_dual(b["tm"], b["tc"], b["tr"], max_iters=5, tol=0.0,
                         cf=b["tcf"], cc=b["tcc"])
    assert t[5] == int(j[5]) == 5
    near_frames(t[:5], j[:5], n)
    sp.near(t[6], j[6])


def test_admm_with_contact(boxes):
    """10 ADMM sweeps, and the 2-sweep preconditioner, with contact rows."""
    b, n = boxes, boxes["n"]
    kw_j, kw_t = dict(cf=b["jcf"], cc=b["jcc"]), dict(cf=b["tcf"], cc=b["tcc"])
    ju, jit_, jerr = jax.jit(lambda r: jadmm.solve_admm(
        b["jm"], b["jc"], r, max_iters=10, tol=0.0, **kw_j))(b["jr"])
    tu, tit, terr = tadmm.solve_admm(b["tm"], b["tc"], b["tr"], max_iters=10,
                                     tol=0.0, **kw_t)
    assert tit == int(jit_) == 10
    near_frames(tu, ju, n)
    sp.near(terr, jerr)
    ju, tu = _tuple(b, 3)
    jM = jadmm.admm_preconditioner(b["jm"], b["jc"], inner_iters=10, **kw_j)
    tM = tadmm.admm_preconditioner(b["tm"], b["tc"], inner_iters=10, **kw_t)
    near_frames(tM(tu), jax.jit(jM)(ju), n)


def test_da_apply(boxes):
    """The dual-ascent loop (10 iterations) around the (M + kL)^{-1}
    Chebyshev apply."""
    b = boxes
    jm, tm = b["jm"], b["tm"]
    GwL_j, GwL_t = jlap.laplacian_rows(jm), tlap.laplacian_rows(tm)
    k = float(jnp.max(b["jc"].max_evals))
    ml_j = jlap.build_ml_preconditioner(jm, GwL_j, k, 40.0, 4.0)
    ml_t = tlap.build_ml_preconditioner(tm, GwL_t, k, t64(40.0), t64(4.0))
    r = np.random.default_rng(4).standard_normal(b["V"].shape)
    sp.near(tlap.da_apply(ml_t, tm, b["tcf"], b["tcc"])(t64(r)),
            jax.jit(jlap.da_apply(ml_j, jm, b["jcf"], b["jcc"]))(
                jnp.asarray(r)))


def test_nodal_contact_refusals(boxes):
    """dual-cg and the ADMM paths refuse the nodal collision and friction
    variables where the state has frames, as the JAX step does."""
    tm, tcf = boxes["tm"], boxes["tcf"]
    x0 = t64(boxes["x"])
    for solver in ("dual-cg", "admm", "minres-kkt-admm"):
        for var in ("collision", "friction"):
            cfg = TConfig(h=0.01, outer_steps=1, solver=solver,
                          variables=(var,), dhat=DHAT, kappa=KAPPA)
            st = tnewton.init_state(tm, cfg, (), x0, torch.zeros_like(x0))
            st.contact = tcf
            with pytest.raises(NotImplementedError):
                tnewton.newton_step(tm, cfg, (), st)
