"""Parity of mixedfem_tpu_torch's contact path (collision/, the
mixed-collision, collision and friction variables, the coarse space's
contact blocks, the contact merit, and Simulation.step with candidates and
the retry) with mixedfem_tpu's, in float64 on the CPU.

Inputs are made with np.random.default_rng(seed) and handed to both
packages as numpy arrays. Tolerances: per-frame and per-vertex values to
1e-12 relative (with an absolute floor of 1e-12 of the largest value, for
entries that are zero in exact arithmetic), ACCD times included; the
candidate sets exactly; 3-step trajectories of the drop scene of
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
from mixedfem_tpu.collision import barrier as jbar
from mixedfem_tpu.collision import broadphase as jbp
from mixedfem_tpu.collision import distances as jdist
from mixedfem_tpu.collision import mollifier as jmol
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
from mixedfem_tpu_torch.apps import sim as tsim
from mixedfem_tpu_torch.collision import accd as taccd
from mixedfem_tpu_torch.collision import barrier as tbar
from mixedfem_tpu_torch.collision import broadphase as tbp
from mixedfem_tpu_torch.collision import distances as tdist
from mixedfem_tpu_torch.collision import mollifier as tmol
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
    CPU, one_torch_thread, port, t64, to_numpy, write_drop_scene,
)

DHAT, KAPPA = 3e-2, 1e5
STEPS = 3

# Called eagerly, the JAX package's 12x12 PSD projection compiles its Jacobi
# sweep anew each time (about 23 s on the CPU); the nodal collision and
# friction tests share this one jitted copy, which compiles once per shape.
_JPSD = jax.jit(jpsd.psd_fix, static_argnames=("tol", "sweeps"))


@pytest.fixture
def jax_psd_compiled_once(monkeypatch):
    monkeypatch.setattr(jpsd, "psd_fix", _JPSD)


@pytest.fixture(scope="module", autouse=True)
def _one_thread(one_torch_thread):
    """Every test of this module runs on one torch intra-op thread."""


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
    """(C, 4, 3) frame vertices and (C,) types: n random frames of each
    type, n near-parallel edge pairs (EE), and n padded frames (four
    coincident vertices, PP)."""
    rng = np.random.default_rng(seed)
    V = rng.standard_normal((4 * n, 4, 3))
    T = np.repeat(np.array([jdist.PT, jdist.EE, jdist.PE, jdist.PP]), n)
    e0 = rng.standard_normal((n, 2, 3))
    par = np.concatenate(
        [e0, e0 + 0.05 * rng.standard_normal((n, 1, 3))
         + 1e-9 * rng.standard_normal((n, 2, 3))], axis=1)
    pad = np.repeat(rng.standard_normal((n, 1, 3)), 4, axis=1)
    V = np.concatenate([V, par, pad])
    T = np.concatenate([T, np.full(n, jdist.EE), np.full(n, jdist.PP)])
    return V, T.astype(np.int32)


@pytest.mark.parametrize("seed", [0, 1])
def test_frame_distances(seed):
    V, T = _frames(seed)
    jV, jT = jnp.asarray(V), jnp.asarray(T)
    tV, tT = t64(V), torch.tensor(T)
    near(tdist.frame_distance(tV, tT), jdist.frame_distance(jV, jT))
    g = tdist.frame_distance_grad(tV, tT)
    assert torch.isfinite(g).all()
    near(g, jdist.frame_distance_grad(jV, jT))
    near(tdist.frame_contact_weights(tV, tT), jdist.frame_contact_weights(jV, jT))
    near(tdist.frame_normal(tV, tT), jdist.frame_normal(jV, jT))


def test_barrier():
    rng = np.random.default_rng(2)
    th = DHAT * DHAT
    t = np.concatenate([rng.uniform(0, 1.2 * th, 200), [0.0, 1e-14 * th, th]])
    for tf, jf in ((tbar.barrier, jbar.barrier),
                   (tbar.barrier_gradient, jbar.barrier_gradient),
                   (tbar.barrier_hessian, jbar.barrier_hessian)):
        near(tf(t64(t), th), jf(jnp.asarray(t), th))
    d = np.sqrt(t)
    for a, b in zip(tbar.mixed_barrier_grad_hess(t64(d), DHAT, KAPPA),
                    jbar.mixed_barrier_grad_hess(jnp.asarray(d), DHAT, KAPPA)):
        near(a, b)


def test_mollifier():
    V, T = _frames(3)
    rest = V + 0.01 * np.random.default_rng(4).standard_normal(V.shape)
    near(tmol.eps_x(t64(rest)), jmol.eps_x(jnp.asarray(rest)))
    ex = jmol.eps_x(jnp.asarray(rest))
    tex = t64(np.asarray(ex))
    near(tmol.mollifier(t64(V), torch.tensor(T), tex),
         jmol.mollifier(jnp.asarray(V), jnp.asarray(T), ex))
    for a, b in zip(tmol.mollifier_grad(t64(V), torch.tensor(T), tex),
                    jmol.mollifier_grad(jnp.asarray(V), jnp.asarray(T), ex)):
        near(a, b)


def test_accd_per_frame():
    """Each frame's CCD time, for frames that hit, frames that move too
    little to matter, padded frames and random ones."""
    rng = np.random.default_rng(5)
    n = 48
    # a point above a triangle in z = 0, moving down through it
    tri = np.concatenate([rng.uniform(-1, 1, (n, 3, 2)), np.zeros((n, 3, 1))], 2)
    p = tri.mean(axis=1, keepdims=True) + np.array([0.0, 0.0, 0.05])
    hit_v = np.concatenate([p, tri], axis=1)
    hit_p = np.zeros_like(hit_v)
    hit_p[:, 0, 2] = -rng.uniform(0.06, 0.5, n)
    rnd_v, rnd_t = _frames(6, n=n // 4)
    rnd_p = 0.3 * rng.standard_normal(rnd_v.shape)
    rnd_p[-n // 4:] = 0.0                                   # the padded frames
    tiny_v = rng.standard_normal((n, 4, 3))
    tiny_p = 1e-14 * rng.standard_normal((n, 4, 3))
    V = np.concatenate([hit_v, rnd_v, tiny_v])
    P = np.concatenate([hit_p, rnd_p, tiny_p])
    T = np.concatenate([np.full(n, jdist.PT), rnd_t, np.full(n, jdist.EE)])
    T = T.astype(np.int32)
    want = jax.vmap(lambda v, q, ft: jaccd._accd_one(v, q, ft, jnp.float64))(
        jnp.asarray(V), jnp.asarray(P), jnp.asarray(T))
    got = taccd.accd_t(t64(V), t64(P), torch.tensor(T))
    near(got, want)
    assert (got[:n] < 1).all() and (got[-n:] == 1).all()
    mask = np.ones(len(T))
    mask[::3] = 0.0
    idx = np.arange(len(T) * 4).reshape(-1, 4)
    x, pf = V.reshape(-1, 3), P.reshape(-1, 3)
    near(taccd.accd_alpha(
        torch.tensor(idx, dtype=torch.int32), torch.tensor(T), t64(mask),
        t64(x), t64(pf)), jaccd.accd_alpha(
            jnp.asarray(idx, jnp.int32), jnp.asarray(T), jnp.asarray(mask),
            jnp.asarray(x), jnp.asarray(pf)))


# ---------------------------------------------------------------------------
# broadphase
# ---------------------------------------------------------------------------

def _canonical(frames, types):
    """Rows (type, frame) with PT triangles and EE edges in sorted vertex
    order, the rows sorted."""
    f = np.asarray(frames, np.int64).copy()
    t = np.asarray(types)
    pt, ee = t == jdist.PT, t == jdist.EE
    f[pt, 1:] = np.sort(f[pt, 1:], axis=1)
    a, b = np.sort(f[ee, 0:2], axis=1), np.sort(f[ee, 2:4], axis=1)
    swap = (a[:, 0] > b[:, 0]) | ((a[:, 0] == b[:, 0]) & (a[:, 1] > b[:, 1]))
    f[ee] = np.where(swap[:, None], np.concatenate([b, a], 1),
                     np.concatenate([a, b], 1))
    rows = np.concatenate([t[:, None], f], axis=1)
    return rows[np.lexsort(rows.T[::-1])]


def test_candidates_two_boxes():
    from mixedfem_tpu.mesh import discretization as jdisc

    V1, T1 = generators.box_tet_mesh(6, 2, 6, size=(1.0, 0.25, 1.0))
    V2, T2 = generators.box_tet_mesh(3, 3, 3, size=(0.4, 0.4, 0.4))
    V2 = V2 + np.array([0.3, 0.26, 0.3])
    V = np.concatenate([V1, V2])
    V = V + 1e-3 * np.random.default_rng(7).standard_normal(V.shape)
    T = np.concatenate([T1, T2 + len(V1)])
    F = jdisc.boundary_facets(T)
    E = jdisc.edges(F)
    sv = np.unique(F)
    for margin in (0.033, 0.08):
        jf, jt = jbp.candidates_3d(V, F, E, sv, margin)
        tf, tt = tbp.candidates_3d(V, F, E, sv, margin)
        assert len(tf) > 100 and set(np.unique(tt)) == {jdist.PT, jdist.EE}
        np.testing.assert_array_equal(_canonical(tf, tt), _canonical(jf, jt))
        cap = max(256, 1 << int(np.ceil(np.log2(len(jf)))))
        assert tbp.capacity(len(tf)) == cap
        jp = jbp.pad_candidates(jf, jt, cap)
        tp = tbp.pad_candidates(tf, tt, cap)
        np.testing.assert_array_equal(_canonical(tp[0], tp[1]),
                                      _canonical(jp[0], jp[1]))
        np.testing.assert_array_equal(tp[2], jp[2])


# ---------------------------------------------------------------------------
# the contact variables, the coarse blocks and the merit
# ---------------------------------------------------------------------------

def _two_boxes(pin_slab):
    """The drop scene's slab and box 0.02 apart (inside DHAT), both free
    unless `pin_slab` (then as tests/test_collision.py pins it), as JAX
    MeshData, with JAX and port ContactFrames over candidates at margin
    1.1 DHAT and a seeded perturbation of the rest positions."""
    V1, T1 = generators.box_tet_mesh(2, 1, 2, size=(1.0, 0.25, 1.0))
    V2, T2 = generators.box_tet_mesh(2, 1, 2, size=(0.4, 0.2, 0.4))
    V = np.concatenate([V1, V2 + np.array([0.3, 0.27, 0.3])])
    T = np.concatenate([T1, T2 + len(V1)])
    la, mu = enu_to_lame(1e6, 0.40)
    is_fixed = np.zeros(len(V), bool)
    is_fixed[: len(V1)] = True if pin_slab else V1[:, 0] < 1e-9
    mesh = jmesh.build_mesh_data(
        V, T, density=np.full(len(T), 1000.0), mu=np.full(len(T), mu),
        lam=np.full(len(T), la), model_id=np.zeros(len(T), int),
        models=("Stable-Neohookean",), is_fixed=is_fixed,
        ext_force=np.tile([0.0, -9.8, 0.0], (len(V), 1)))
    x = V + 2e-3 * np.random.default_rng(8).standard_normal(V.shape)
    F, E = np.asarray(mesh.F_srf), np.asarray(mesh.E_srf)
    f, t = jbp.candidates_3d(x, F, E, np.unique(F), 1.1 * DHAT)
    f, t, m = jbp.pad_candidates(f, t, tbp.capacity(len(f)))
    jcf = jmc.ContactFrames(frames=jnp.asarray(f), ftype=jnp.asarray(t),
                            fmask=jnp.asarray(m))
    tcf = tmc.contact_frames(f, t, m, len(V), torch.float64, CPU)
    return mesh, x, jcf, tcf


@pytest.fixture(scope="module")
def boxes():
    return _two_boxes(pin_slab=False)


def _prev(C, n, seed):
    """Previous (d, la, active) of C frames: a random half of the n real
    ones active, the padded ones inactive (as a step leaves them)."""
    rng = np.random.default_rng(seed)
    act = (rng.random(C) < 0.5).astype(np.float64)
    act[n:] = 0.0
    return rng.uniform(0.2, 1.2, C) * DHAT, rng.standard_normal(C), act


@pytest.mark.parametrize("mollify", [False, True])
def test_mixed_collision(boxes, mollify):
    """The port holds the n real frames, the JAX package all C."""
    mesh, x, jcf, tcf = boxes
    tm = port(mesh)[0]
    C, n = tcf.frames.shape[0], tcf.nreal
    assert 0 < n < C
    d, la, act = _prev(C, n, 9)
    jc = jmc.update(mesh, jcf, jnp.asarray(x), *map(jnp.asarray, (d, la, act)),
                    DHAT, KAPPA, ee_mollifier=mollify)
    tc = tmc.update(tm, tcf, t64(x), *(t64(a[:n]) for a in (d, la, act)),
                    DHAT, KAPPA, ee_mollifier=mollify)
    assert int(tc.active.sum()) > 10
    assert not np.asarray(jc.active)[n:].any()
    for f in ("D", "Gx", "g", "H", "active", "d", "la"):
        near(getattr(tc, f), np.asarray(getattr(jc, f))[:n])
    if mollify:
        near(tc.gmf, np.asarray(jc.gmf)[:n])
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
    bad = tc.d.clone()
    bad[int(torch.nonzero(tc.active)[0])] = -1e-3
    assert float(tmc.energy(bad, tc.active, DHAT, KAPPA)) == 1e30
    x2 = x + 1e-3 * rng.standard_normal(x.shape)
    near(tmc.constraint_value(tm, tcf, tc, t64(x2), tc.d, tc.la, DHAT),
         jmc.constraint_value(mesh, jcf, jc, jnp.asarray(x2), jc.d, jc.la, DHAT))


def _nodal_ops(tm, mesh, tff, jff, tc, jc, mod_t, mod_j, seed):
    p = np.random.default_rng(seed).standard_normal((mesh.nv, 3))
    n = tc.g.shape[0]
    near(tc.g, np.asarray(jc.g)[:n])
    near(tc.H, np.asarray(jc.H)[:n])
    near(mod_t.gradient(tm, tff, tc), mod_j.gradient(mesh, jff, jc))
    near(mod_t.matvec(tm, tff, tc, t64(p)), mod_j.matvec(mesh, jff, jc, jnp.asarray(p)))
    near(mod_t.diag_blocks(tm, tff, tc), mod_j.diag_blocks(mesh, jff, jc))


def test_nodal_collision(boxes, jax_psd_compiled_once):
    mesh, x, jcf, tcf = boxes
    tm = port(mesh)[0]
    tc = tvcol.update(tcf, t64(x), DHAT, KAPPA)
    jc = jvcol.update(jcf, jnp.asarray(x), DHAT, KAPPA)
    assert float(tc.H.abs().amax()) > 0
    _nodal_ops(tm, mesh, tcf, jcf, tc, jc, tvcol, jvcol, 11)
    near(tvcol.energy(tcf, t64(x), DHAT, KAPPA, 0.01),
         jvcol.energy(jcf, jnp.asarray(x), DHAT, KAPPA, 0.01))


def test_friction(boxes, jax_psd_compiled_once):
    mesh, x, jcf, tcf = boxes
    tm = port(mesh)[0]
    tff = tfric.build(tm, tcf, t64(x), DHAT, KAPPA)
    jff = jfric.build(mesh, jcf, jnp.asarray(x), DHAT, KAPPA)
    for f in ("w", "basis", "N", "active", "V0"):
        near(getattr(tff, f), np.asarray(getattr(jff, f))[:tcf.nreal])
    x1 = x + 1e-3 * np.random.default_rng(12).standard_normal(x.shape)
    mu, eps = 0.5, 1e-3 * 0.01
    tc = tfric.update(tff, t64(x1), mu, eps)
    jc = jfric.update(jff, jnp.asarray(x1), mu, eps)
    assert float(tc.H.abs().amax()) > 0
    _nodal_ops(tm, mesh, tff, jff, tc, jc, tfric, jfric, 13)
    near(tfric.energy(tff, t64(x1), mu, eps, 0.01),
         jfric.energy(jff, jnp.asarray(x1), mu, eps, 0.01))


def test_coarse_matrix_contact(boxes):
    """Aggregates of 4 vertices on two free objects: the contact blocks
    join aggregate pairs that no element holds."""
    mesh, x, jcf, tcf = boxes
    jcs = jcoarse.build_coarse_space(
        np.asarray(mesh.V0), np.asarray(mesh.T),
        ~np.asarray(mesh.free_mask, bool), target_size=4)
    tm, _, tcs = port(mesh, coarse=jcs)
    z = np.zeros(tcf.frames.shape[0])
    jc = jmc.update(mesh, jcf, jnp.asarray(x), *(jnp.asarray(z),) * 3, DHAT, KAPPA)
    tc = tmc.update(tm, tcf, t64(x), *(t64(z[:tcf.nreal]),) * 3, DHAT, KAPPA)
    # the port sums the active frames' blocks (the others add zero)
    act = torch.nonzero(tc.active).squeeze(1)
    frames = tcf.frames[act].long()
    pairs = tcoarse.contact_pairs(tcs, frames.numpy(), CPU)
    elem = set(zip(tcs.pair_rows.tolist(), tcs.pair_cols.tolist()))
    assert set(zip(pairs.rows.tolist(), pairs.cols.tolist())) - elem
    s = np.asarray(jms.reset(mesh, jnp.asarray(x))[0])
    jco = jms.update(mesh, jnp.asarray(x), jnp.asarray(s), 0.01)
    tco = tms.update(tm, t64(x), t64(s), 0.01)
    near(tcoarse.coarse_matrix(tm, tcs, tco,
                               (pairs, frames, tc.Gx[act], tc.H[act])),
         jcoarse.coarse_matrix(mesh, jcs, jco,
                               (jcf.frames, jc.Gx, jc.H, jc.active)))


def test_mixed_contact_merit(boxes):
    mesh, x, jcf, tcf = boxes
    C, n = tcf.frames.shape[0], tcf.nreal
    d, la, act = _prev(C, n, 14)
    rng = np.random.default_rng(15)
    xt = x + 1e-3 * rng.standard_normal(x.shape)
    for cd in (d, np.where(np.arange(C) == int(np.argmax(act)), -1e-3, d)):
        got = tnewton.mixed_contact_merit(
            tcf, t64(xt), *(t64(a[:n]) for a in (cd, act, la)), DHAT, KAPPA)
        want = jnewton.mixed_contact_merit(
            jcf, jnp.asarray(xt), jnp.asarray(cd), jnp.asarray(act),
            jnp.asarray(la), DHAT, KAPPA, jnp.float64)
        near(got, want)


# ---------------------------------------------------------------------------
# Simulation.step: trajectories and the retry
# ---------------------------------------------------------------------------

def _active(cf, x, dhat, dist_mod, np_x):
    """Real candidates with distance < dhat at positions x."""
    if np_x:
        D = np.asarray(dist_mod.frame_distance(x[cf.frames], cf.ftype))
        return int(((D < dhat) & (np.asarray(cf.fmask) > 0)).sum())
    D = dist_mod.frame_distance(x[cf.frames.long()], cf.ftype)
    return int(((D < dhat) & (cf.fmask > 0)).sum())


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
                                   jst["stats"]["alpha"], rtol=1e-12)
        na = _active(ts.state.contact, ts.state.x, ts.config.dhat, tdist, False)
        assert na == _active(js.state.contact, js.state.x, js.config.dhat,
                             jdist, True)
        assert int(ts.state.stats.active_frames[it - 1]) > 0
        assert float(ts.state.stats.min_distance[:it].min()) > 0


@pytest.mark.parametrize("variables", [(), ("friction",)])
def test_drop_trajectory(variables):
    """The drop scene with CCD on, mixed-collision (and lagged friction),
    3 steps of 3 Newton iterations."""
    mesh, config, _ = jtc.drop_scene(dhat=DHAT, kappa=KAPPA)
    config = dataclasses.replace(config, outer_steps=3, variables=variables)
    x0 = jnp.asarray(mesh.V0)
    jst = jnewton.init_state(mesh, config, (), x0, jnp.zeros_like(x0))
    js = JSim(mesh=mesh, config=config, bc_specs=(), state=jst, dim=3,
              obj_slices=[])
    tm, tst, _ = port(mesh, jst)
    tcfg = TConfig(**{k: v for k, v in config.__dict__.items()
                      if k != "matvec_scheme"})
    ts = TSim(mesh=tm, config=tcfg, bc_specs=(), state=tst, dim=3,
              obj_slices=[])
    _compare_steps(js, ts)


def test_drop_scene_without_mixed_variables(tmp_path):
    path = write_drop_scene(tmp_path)
    js = jload(path, dim=3, dtype="float64")
    ts = tload(path, dim=3, dtype="float64", device="cpu")
    assert ts.config.mixed_variables == ("mixed-stretch", "mixed-collision")
    assert bool((ts.mesh.free_mask[:18] == 0).all())
    _compare_steps(js, ts)


def test_cli_steps_scene_without_mixed_variables(tmp_path, capsys):
    path = write_drop_scene(tmp_path)
    sim = tsim.main([path, "--dim", "3", "-n", "1", "--device", "cpu",
                     "--out", str(tmp_path / "out"), "--dtype", "float64"])
    assert sim.state.step_count == 1 and sim.state.contact.nreal > 0
    assert torch.isfinite(sim.state.x).all()
    assert "Energy" in capsys.readouterr().out


def test_retry_catches_stale_candidates():
    """The fast drop of tests/test_collision.py (TestCandidateStaleness):
    candidates built once let the box fall through the slab; Simulation.step
    re-runs the step with a wider margin and keeps it above, from an intact
    pre-step state. One Newton iteration keeps it cheap (the retried
    step's candidate set has 2.3M frames); ACCD clamps that iteration."""
    mesh, config, n_slab = jtc.TestCandidateStaleness()._fast_drop()
    config = dataclasses.replace(config, outer_steps=1)
    x0 = jnp.asarray(mesh.V0)
    jst = jnewton.init_state(mesh, config, (), x0, jnp.zeros_like(x0))
    tcfg = TConfig(**{k: v for k, v in config.__dict__.items()
                      if k != "matvec_scheme"})
    slab_top = float(np.asarray(mesh.V0)[:n_slab, 1].max())

    def sim():
        tm, tst, _ = port(mesh, jst)
        return TSim(mesh=tm, config=tcfg, bc_specs=(), state=tst, dim=3,
                    obj_slices=[])

    once = sim()
    once._update_contact_candidates()
    once.state = once._one_step()
    assert float(once.state.x[n_slab:, 1].min()) < slab_top - 1e-3

    s = sim()
    pre = s.state
    saved = [t.clone() for t in (pre.x, pre.s, pre.la, pre.bdf.x_hist,
                                 pre.bdf.v_hist)]
    s.step()
    assert s.retries >= 1
    for a, b in zip((pre.x, pre.s, pre.la, pre.bdf.x_hist, pre.bdf.v_hist),
                    saved):
        assert torch.equal(a, b)
    assert torch.isfinite(s.state.x).all()
    assert float(s.state.x[n_slab:, 1].min()) > slab_top - 1e-4
