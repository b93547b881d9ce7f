"""Parity of mixedfem_tpu_torch's 2D contact path (candidates_2d, the
point-edge and point-point distances, weights, normals and tangent bases,
ACCD, the mixed-collision, collision and friction variables over (C, 4, 2)
frames, the coarse space's contact blocks, the contact merit, and
Simulation.step on the 2D drop scene) with mixedfem_tpu's, in float64 on
the CPU.

Inputs are made with np.random.default_rng(seed) and handed to both
packages as numpy arrays. Tolerances: per-frame and per-vertex values to
1e-12 relative (with an absolute floor of 1e-12 of the largest value, for
entries that are zero in exact arithmetic); the candidate sets exactly, in
the same order; 3-step trajectories of the 2D drop scene of
tests/test_collision.py (3 Newton iterations a step) to 1e-8 on positions
of order 1, with equal Newton and CG counts, alphas and active frames."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_collision as jtc
from mixedfem_tpu.collision import accd as jaccd
from mixedfem_tpu.collision import broadphase as jbp
from mixedfem_tpu.collision import distances as jdist
from mixedfem_tpu.config import enu_to_lame
from mixedfem_tpu.io.scene import Simulation as JSim
from mixedfem_tpu.io.scene import load_scene as jload
from mixedfem_tpu.mesh import generators
from mixedfem_tpu.mesh import mesh as jmesh
from mixedfem_tpu.ops import psd as jpsd
from mixedfem_tpu.optimizer import newton as jnewton
from mixedfem_tpu.solvers import coarse as jcoarse
from mixedfem_tpu.variables import collision as jvcol
from mixedfem_tpu.variables import friction as jfric
from mixedfem_tpu.variables import mixed_collision as jmc
from mixedfem_tpu.variables import mixed_stretch as jms
from mixedfem_tpu_torch.collision import accd as taccd
from mixedfem_tpu_torch.collision import broadphase as tbp
from mixedfem_tpu_torch.collision import distances as tdist
from mixedfem_tpu_torch.config import SimConfig as TConfig
from mixedfem_tpu_torch.io.scene import Simulation as TSim
from mixedfem_tpu_torch.io.scene import load_scene as tload
from mixedfem_tpu_torch.optimizer import newton as tnewton
from mixedfem_tpu_torch.solvers import coarse as tcoarse
from mixedfem_tpu_torch.variables import collision as tvcol
from mixedfem_tpu_torch.variables import friction as tfric
from mixedfem_tpu_torch.variables import mixed_collision as tmc
from mixedfem_tpu_torch.variables import mixed_stretch as tms

from torch_parity import (  # noqa: F401 (one_torch_thread is a fixture)
    CPU, one_torch_thread, port, t64, to_numpy, write_tri_drop_scene,
)


@pytest.fixture(scope="module", autouse=True)
def _one_thread(one_torch_thread):
    """Every test of this module runs on one torch intra-op thread."""


DHAT, KAPPA = 3e-2, 1e5
STEPS = 3

# Called eagerly, the JAX package's PSD projection of the 8x8 nodal
# Hessians compiles its Jacobi sweep anew each time; the nodal collision
# and friction tests share this one jitted copy, which compiles once. The
# reference updates of the mixed-collision variable and the mixed stretch,
# and the coarse matrix, run jitted: one compile each, where eager
# dispatch compiles every operation on its own.
_JPSD = jax.jit(jpsd.psd_fix, static_argnames=("tol", "sweeps"))
_JMC_UPDATE = jax.jit(jmc.update, static_argnames=("dhat", "kappa",
                                                   "ee_mollifier"))
_JMS_UPDATE = jax.jit(jms.update)
_JCOARSE_MATRIX = jax.jit(jcoarse.coarse_matrix)


@pytest.fixture
def jax_psd_compiled_once(monkeypatch):
    monkeypatch.setattr(jpsd, "psd_fix", _JPSD)


def near(actual, expected, rtol=1e-12):
    """assert_allclose at rtol with an absolute floor of rtol x the largest
    expected magnitude."""
    a = actual.detach().numpy() if torch.is_tensor(actual) else np.asarray(actual)
    e = np.asarray(expected)
    scale = float(np.abs(e).max()) if e.size else 0.0
    np.testing.assert_allclose(a, e, rtol=rtol, atol=rtol * scale)


# ---------------------------------------------------------------------------
# per-frame functions
# ---------------------------------------------------------------------------

def _frames(seed, n=64):
    """(C, 4, 2) frame vertices and (C,) types: n random point-edge and n
    point-point frames, n point-edge frames whose point projects outside
    its edge, and n padded frames (four coincident vertices, PP)."""
    rng = np.random.default_rng(seed)
    V = rng.standard_normal((2 * n, 4, 2))
    T = np.repeat(np.array([jdist.PE, jdist.PP]), n)
    out = rng.standard_normal((n, 4, 2))
    out[:, 0] = out[:, 2] + 1.5 * (out[:, 2] - out[:, 1])
    pad = np.repeat(rng.standard_normal((n, 1, 2)), 4, axis=1)
    V = np.concatenate([V, out, pad])
    T = np.concatenate([T, np.full(n, jdist.PE), np.full(n, jdist.PP)])
    return V, T.astype(np.int32)


@pytest.mark.parametrize("seed", [0, 1])
def test_frame_distances_2d(seed):
    V, T = _frames(seed)
    jV, jT = jnp.asarray(V), jnp.asarray(T)
    tV, tT = t64(V), torch.tensor(T)
    near(tdist.frame_distance(tV, tT), jdist.frame_distance(jV, jT))
    g = tdist.frame_distance_grad(tV, tT)
    assert torch.isfinite(g).all() and g.shape == V.shape
    near(g, jdist.frame_distance_grad(jV, jT))
    near(tdist.frame_contact_weights(tV, tT), jdist.frame_contact_weights(jV, jT))
    n = tdist.frame_normal(tV, tT)
    near(n, jdist.frame_normal(jV, jT))
    near(tfric._tangent_basis(n), jfric._tangent_basis(jnp.asarray(n.numpy())))
    assert tfric._tangent_basis(n).shape == (len(T), 2, 1)


def test_accd_per_frame_2d():
    """Each frame's CCD time: points moving down through an edge, random
    frames with random motion, and frames that move too little to
    matter."""
    rng = np.random.default_rng(5)
    n = 48
    e = np.stack([rng.uniform(-1, 0, n), rng.uniform(0, 1, n)], 1)
    edge = np.stack([np.stack([e[:, 0], np.zeros(n)], 1),
                     np.stack([e[:, 1], np.zeros(n)], 1)], 1)
    p = np.stack([e.mean(axis=1), np.full(n, 0.05)], 1)  # above the middle
    hit_v = np.concatenate([p[:, None], edge, edge[:, :1]], axis=1)
    hit_p = np.zeros_like(hit_v)
    hit_p[:, 0, 1] = -rng.uniform(0.06, 0.5, n)
    rnd_v, rnd_t = _frames(6, n=n // 4)
    rnd_p = 0.3 * rng.standard_normal(rnd_v.shape)
    tiny_v = rng.standard_normal((n, 4, 2))
    tiny_p = 1e-14 * rng.standard_normal((n, 4, 2))
    V = np.concatenate([hit_v, rnd_v, tiny_v])
    P = np.concatenate([hit_p, rnd_p, tiny_p])
    T = np.concatenate([np.full(n, jdist.PE), rnd_t, np.full(n, jdist.PE)])
    T = T.astype(np.int32)
    want = jax.vmap(lambda v, q, ft: jaccd._accd_one(v, q, ft, jnp.float64))(
        jnp.asarray(V), jnp.asarray(P), jnp.asarray(T))
    got = taccd.accd_t(t64(V), t64(P), torch.tensor(T))
    near(got, want)
    assert (got[:n] < 1).all() and (got[-n:] == 1).all()


# ---------------------------------------------------------------------------
# broadphase
# ---------------------------------------------------------------------------

def _two_slabs(pin_slab, seed=8):
    """A slab grid_tri_mesh(8, 2) over (1, 0.2) and a box grid_tri_mesh(4,
    2) over (0.3, 0.15) 0.02 above it (inside DHAT), both free unless
    `pin_slab`, as JAX MeshData, with positions perturbed by 2e-3 (seeded)
    and JAX and port ContactFrames over candidates at margin 1.1 DHAT."""
    V1, T1 = generators.grid_tri_mesh(8, 2, size=(1.0, 0.2))
    V2, T2 = generators.grid_tri_mesh(4, 2, size=(0.3, 0.15))
    V = np.concatenate([V1, V2 + np.array([0.35, 0.22])])
    T = np.concatenate([T1, T2 + len(V1)])
    la, mu = enu_to_lame(1e6, 0.40)
    is_fixed = np.zeros(len(V), bool)
    is_fixed[: len(V1)] = True if pin_slab else V1[:, 0] < 1e-9
    mesh = jmesh.build_mesh_data(
        V, T, density=np.full(len(T), 1000.0), mu=np.full(len(T), mu),
        lam=np.full(len(T), la), model_id=np.zeros(len(T), int),
        models=("Stable-Neohookean",), is_fixed=is_fixed,
        ext_force=np.tile([0.0, -9.8], (len(V), 1)))
    x = V + 2e-3 * np.random.default_rng(seed).standard_normal(V.shape)
    E = np.asarray(mesh.E_srf)
    f, t = jbp.candidates_2d(x, E, np.unique(E), 1.1 * DHAT)
    f, t, m = jbp.pad_candidates(f, t, tbp.capacity(len(f)))
    jcf = jmc.ContactFrames(frames=jnp.asarray(f), ftype=jnp.asarray(t),
                            fmask=jnp.asarray(m))
    tcf = tmc.contact_frames(f, t, m, len(V), torch.float64, CPU)
    return mesh, x, jcf, tcf


@pytest.mark.parametrize("margin", [0.033, 0.08, 0.3])
def test_candidates_2d(margin):
    """The same point-edge frames in the same order as the JAX package's
    native grid hash, on the perturbed slab and box and on the unperturbed
    drop scene (vertices on cell boundaries)."""
    mesh, x, _, _ = _two_slabs(False)
    drop, _, _ = jtc.drop_scene(dim=2)
    for V, E in ((x, np.asarray(mesh.E_srf)),
                 (np.asarray(drop.V0), np.asarray(drop.E_srf))):
        sv = np.unique(E)
        jf, jt = jbp.candidates_2d(V, E, sv, margin)
        tf, tt = tbp.candidates_2d(V, E, sv, margin)
        assert len(tf) > 0 and set(np.unique(tt)) == {jdist.PE}
        np.testing.assert_array_equal(tf, jf)
        np.testing.assert_array_equal(tt, jt)
        cap = tbp.capacity(len(tf))
        for a, b in zip(tbp.pad_candidates(tf, tt, cap),
                        jbp.pad_candidates(jf, jt, cap)):
            np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# the contact variables, the coarse blocks and the merit
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def slabs():
    return _two_slabs(pin_slab=False)


def _prev(C, n, seed):
    """Previous (d, la, active) of C frames: a random half of the n real
    ones active, the padded ones inactive (as a step leaves them)."""
    rng = np.random.default_rng(seed)
    act = (rng.random(C) < 0.5).astype(np.float64)
    act[n:] = 0.0
    return rng.uniform(0.2, 1.2, C) * DHAT, rng.standard_normal(C), act


@pytest.mark.parametrize("mollify", [False, True])
def test_mixed_collision_2d(slabs, mollify):
    """(C, 4, 2) frames; the edge-edge mollifier is 3D only, so asking for
    it changes nothing in 2D, in either package."""
    mesh, x, jcf, tcf = slabs
    tm = port(mesh)[0]
    C, n = tcf.frames.shape[0], tcf.nreal
    assert 0 < n < C
    d, la, act = _prev(C, n, 9)
    jc = jmc.update(mesh, jcf, jnp.asarray(x), *map(jnp.asarray, (d, la, act)),
                    DHAT, KAPPA, ee_mollifier=mollify)
    tc = tmc.update(tm, tcf, t64(x), *(t64(a[:n]) for a in (d, la, act)),
                    DHAT, KAPPA, ee_mollifier=mollify)
    assert int(tc.active.sum()) > 5 and tc.gmf is None
    assert tc.Gx.shape == (n, 4, 2)
    for f in ("D", "Gx", "g", "H", "active", "d", "la"):
        near(getattr(tc, f), np.asarray(getattr(jc, f))[:n])
    rng = np.random.default_rng(10)
    p, dx = rng.standard_normal((2,) + x.shape)
    near(tmc.rhs(tm, tcf, tc), jmc.rhs(mesh, jcf, jc))
    near(tmc.matvec(tm, tcf, tc, t64(p)), jmc.matvec(mesh, jcf, jc, jnp.asarray(p)))
    near(tmc.diag_blocks(tm, tcf, tc), jmc.diag_blocks(mesh, jcf, jc))
    for a, b in zip(tmc.local_solve(tm, tcf, tc, t64(dx)),
                    jmc.local_solve(mesh, jcf, jc, jnp.asarray(dx))):
        near(a, np.asarray(b)[:n])
    near(tmc.energy(tc.d, tc.active, DHAT, KAPPA),
         jmc.energy(jc.d, jc.active, DHAT, KAPPA, jnp.float64))
    x2 = x + 1e-3 * rng.standard_normal(x.shape)
    near(tmc.constraint_value(tm, tcf, tc, t64(x2), tc.d, tc.la, DHAT),
         jmc.constraint_value(mesh, jcf, jc, jnp.asarray(x2), jc.d, jc.la, DHAT))


def _nodal_ops(tm, mesh, tff, jff, tc, jc, mod_t, mod_j, seed):
    p = np.random.default_rng(seed).standard_normal((mesh.nv, 2))
    n = tc.g.shape[0]
    assert tc.H.shape == (n, 8, 8)
    near(tc.g, np.asarray(jc.g)[:n])
    near(tc.H, np.asarray(jc.H)[:n])
    near(mod_t.gradient(tm, tff, tc), mod_j.gradient(mesh, jff, jc))
    near(mod_t.matvec(tm, tff, tc, t64(p)), mod_j.matvec(mesh, jff, jc, jnp.asarray(p)))
    near(mod_t.diag_blocks(tm, tff, tc), mod_j.diag_blocks(mesh, jff, jc))


def test_nodal_collision_2d(slabs, jax_psd_compiled_once):
    mesh, x, jcf, tcf = slabs
    tm = port(mesh)[0]
    tc = tvcol.update(tcf, t64(x), DHAT, KAPPA)
    jc = jvcol.update(jcf, jnp.asarray(x), DHAT, KAPPA)
    assert float(tc.H.abs().amax()) > 0
    _nodal_ops(tm, mesh, tcf, jcf, tc, jc, tvcol, jvcol, 11)
    near(tvcol.energy(tcf, t64(x), DHAT, KAPPA, 0.01),
         jvcol.energy(jcf, jnp.asarray(x), DHAT, KAPPA, 0.01))


def test_friction_2d(slabs, jax_psd_compiled_once):
    mesh, x, jcf, tcf = slabs
    tm = port(mesh)[0]
    tff = tfric.build(tm, tcf, t64(x), DHAT, KAPPA)
    jff = jfric.build(mesh, jcf, jnp.asarray(x), DHAT, KAPPA)
    assert tff.basis.shape == (tcf.nreal, 2, 1)
    for f in ("w", "basis", "N", "active", "V0"):
        near(getattr(tff, f), np.asarray(getattr(jff, f))[:tcf.nreal])
    # slips below eps, inside f0's quadratic zone: in 2D the tangent is a
    # line, and past eps the potential mu N |u_t| has no curvature left
    x1 = x + 1e-6 * np.random.default_rng(12).standard_normal(x.shape)
    mu, eps = 0.5, 1e-3 * 0.01
    tc = tfric.update(tff, t64(x1), mu, eps)
    jc = jfric.update(jff, jnp.asarray(x1), mu, eps)
    assert float(tc.H.abs().amax()) > 1e-3 * mu * float(tff.N.max()) / eps
    _nodal_ops(tm, mesh, tff, jff, tc, jc, tfric, jfric, 13)
    near(tfric.energy(tff, t64(x1), mu, eps, 0.01),
         jfric.energy(jff, jnp.asarray(x1), mu, eps, 0.01))


def test_coarse_matrix_contact_2d(slabs):
    """Aggregates of 4 vertices on two free objects: the 2D contact blocks
    join aggregate pairs that no element holds."""
    mesh, x, jcf, tcf = slabs
    jcs = jcoarse.build_coarse_space(
        np.asarray(mesh.V0), np.asarray(mesh.T),
        ~np.asarray(mesh.free_mask, bool), target_size=4)
    tm, _, tcs = port(mesh, coarse=jcs)
    z = np.zeros(tcf.frames.shape[0])
    jc = _JMC_UPDATE(mesh, jcf, jnp.asarray(x), *(jnp.asarray(z),) * 3,
                     dhat=DHAT, kappa=KAPPA)
    tc = tmc.update(tm, tcf, t64(x), *(t64(z[:tcf.nreal]),) * 3, DHAT, KAPPA)
    act = torch.nonzero(tc.active).squeeze(1)
    frames = tcf.frames[act].long()
    pairs = tcoarse.contact_pairs(tcs, frames.numpy(), CPU)
    elem = set(zip(tcs.pair_rows.tolist(), tcs.pair_cols.tolist()))
    assert set(zip(pairs.rows.tolist(), pairs.cols.tolist())) - elem
    s = np.asarray(jms.reset(mesh, jnp.asarray(x))[0])
    jco = _JMS_UPDATE(mesh, jnp.asarray(x), jnp.asarray(s), 0.01)
    tco = tms.update(tm, t64(x), t64(s), 0.01)
    near(tcoarse.coarse_matrix(tm, tcs, tco,
                               (pairs, frames, tc.Gx[act], tc.H[act])),
         _JCOARSE_MATRIX(mesh, jcs, jco,
                         (jcf.frames, jc.Gx, jc.H, jc.active)))


def test_mixed_contact_merit_2d(slabs):
    mesh, x, jcf, tcf = slabs
    tm = port(mesh)[0]
    C, n = tcf.frames.shape[0], tcf.nreal
    d, la, act = _prev(C, n, 14)
    xt = x + 1e-3 * np.random.default_rng(15).standard_normal(x.shape)
    for cd in (d, np.where(np.arange(C) == int(np.argmax(act)), -1e-3, d)):
        got = tnewton.mixed_contact_merit(
            tcf, t64(xt), *(t64(a[:n]) for a in (cd, act, la)), DHAT, KAPPA,
            mesh=tm, ee_mollifier=True)
        want = jnewton.mixed_contact_merit(
            jcf, jnp.asarray(xt), jnp.asarray(cd), jnp.asarray(act),
            jnp.asarray(la), DHAT, KAPPA, jnp.float64, mesh=mesh,
            ee_mollifier=True)
        near(got, want)


# ---------------------------------------------------------------------------
# Simulation.step on the 2D drop scene
# ---------------------------------------------------------------------------

def _compare_steps(js, ts):
    for _ in range(STEPS):
        js.step()
        ts.step()
        jst = to_numpy(js.state)
        np.testing.assert_allclose(ts.state.x.numpy(), jst["x"], rtol=0,
                                   atol=1e-8)
        it = ts.state.stats.iterations
        assert it == int(jst["stats"]["iterations"])
        np.testing.assert_array_equal(ts.state.stats.solver_iters.numpy(),
                                      jst["stats"]["solver_iters"])
        np.testing.assert_allclose(ts.state.stats.alpha.numpy(),
                                   jst["stats"]["alpha"], rtol=0, atol=0)
        cf, jcf = ts.state.contact, js.state.contact
        np.testing.assert_array_equal(cf.frames.numpy(), np.asarray(jcf.frames))
        D = tdist.frame_distance(ts.state.x[cf.frames.long()], cf.ftype)
        jD = np.asarray(jdist.frame_distance(js.state.x[jcf.frames], jcf.ftype))
        act = (D.numpy() < DHAT) & (cf.fmask.numpy() > 0)
        assert act.sum() == ((jD < DHAT) & (np.asarray(jcf.fmask) > 0)).sum()
        assert int(ts.state.stats.active_frames[it - 1]) > 0
        assert float(ts.state.stats.min_distance[:it].min()) > 0


@pytest.mark.parametrize("variables", [(), ("friction",)])
def test_drop_trajectory_2d(variables):
    """The 2D drop scene with CCD on, mixed-collision (and lagged
    friction), 3 steps of 3 Newton iterations."""
    mesh, config, _ = jtc.drop_scene(dim=2, dhat=DHAT, kappa=KAPPA)
    config = dataclasses.replace(config, outer_steps=3, variables=variables)
    x0 = jnp.asarray(mesh.V0)
    jst = jnewton.init_state(mesh, config, (), x0, jnp.zeros_like(x0))
    js = JSim(mesh=mesh, config=config, bc_specs=(), state=jst, dim=2,
              obj_slices=[])
    tm, tst, _ = port(mesh, jst)
    tcfg = TConfig(**{k: v for k, v in config.__dict__.items()
                      if k != "matvec_scheme"})
    ts = TSim(mesh=tm, config=tcfg, bc_specs=(), state=tst, dim=2,
              obj_slices=[])
    _compare_steps(js, ts)


def test_drop_scene_2d_without_mixed_variables(tmp_path):
    """The 2D drop scene written as .obj files and a JSON without
    mixed_variables: load_scene(dim=2) adds mixed-collision in both
    packages, and the steps agree."""
    path = write_tri_drop_scene(tmp_path)
    js = jload(path, dim=2, dtype="float64")
    ts = tload(path, dim=2, dtype="float64", device="cpu")
    assert ts.config.mixed_variables == ("mixed-stretch", "mixed-collision")
    assert ts.mesh.dim == 2 and bool((ts.mesh.free_mask[:10] == 0).all())
    np.testing.assert_array_equal(ts.mesh.V0.numpy(), np.asarray(js.mesh.V0))
    _compare_steps(js, ts)
