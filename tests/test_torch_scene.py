"""Parity of mixedfem_tpu_torch's scene path (mesh IO, boundary conditions,
press controllers, skinning, load_scene + Simulation.step, the CLI) with
mixedfem_tpu's, in float64 on the CPU, on scenes of at most 1k tets written
from the generators into a temporary directory.

Tolerances: host code (IO, BC set-up, skinning) is a copy of the JAX
package's and must give the same values (1e-15, or exactly for integers);
BC motion runs the same f64 arithmetic on the device (1e-14); the 3-step
scene trajectory is held to 1e-8 on positions of order 1, with equal CG and
Newton counts and equal BC and press states."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mixedfem_tpu.bc import boundary_conditions as jbc
from mixedfem_tpu.bc import press as jpress
from mixedfem_tpu.io import mesh_io as jio
from mixedfem_tpu.io.scene import load_scene as jload
from mixedfem_tpu.mesh.generators import box_tet_mesh
from mixedfem_tpu.utils import skinning as jskin
from mixedfem_tpu_torch import convert
from mixedfem_tpu_torch.apps import sim as tsim
from mixedfem_tpu_torch.bc import boundary_conditions as tbc
from mixedfem_tpu_torch.bc import press as tpress
from mixedfem_tpu_torch.io import mesh_io as tio
from mixedfem_tpu_torch.io.scene import load_scene as tload
from mixedfem_tpu_torch.mesh import discretization as tdisc
from mixedfem_tpu_torch.utils import skinning as tskin

from torch_parity import (  # noqa: F401 (one_torch_thread is a fixture)
    CPU, close, one_torch_thread, t64, to_numpy,
)

STEPS = 3


def _box(nx, ny, nz, size=(1.0, 0.5, 0.5)):
    return box_tet_mesh(nx, ny, nz, size=size)


# ---------------------------------------------------------------------------
# mesh IO
# ---------------------------------------------------------------------------

def test_mesh_roundtrip(tmp_path):
    V, T = _box(3, 2, 2)
    F = tdisc.boundary_facets(T)
    tio.write_mesh(str(tmp_path / "t.mesh"), V, T, F)
    jio.write_mesh(str(tmp_path / "j.mesh"), V, T, F)
    Vj, Tj, _ = jio.read_mesh(str(tmp_path / "t.mesh"))
    Vt, Tt, Ft = tio.read_mesh(str(tmp_path / "j.mesh"))
    for Vr, Tr in ((Vj, Tj), (Vt, Tt)):
        np.testing.assert_array_equal(Vr, V)
        np.testing.assert_array_equal(Tr, T)
    np.testing.assert_array_equal(Ft, F)


def test_obj_dmat_roundtrip(tmp_path):
    V, T = _box(2, 2, 2)
    F = tdisc.boundary_facets(T)
    # an unreferenced vertex, and a quad written by hand
    Vx = np.vstack([V, [[9.0, 9.0, 9.0]]])
    tio.write_obj(str(tmp_path / "t.obj"), Vx, F)
    with open(tmp_path / "t.obj", "a") as f:
        f.write("f 1/1 2/2 3/3 -1\n")
    Vj, Fj = jio.read_obj(str(tmp_path / "t.obj"))
    Vt, Ft = tio.read_obj(str(tmp_path / "t.obj"))
    np.testing.assert_array_equal(Vt, Vj)
    np.testing.assert_array_equal(Ft, Fj)
    for a, b in zip(tio.remove_unreferenced(Vt, Ft),
                    jio.remove_unreferenced(Vj, Fj)):
        np.testing.assert_array_equal(a, b)
    M = np.random.default_rng(0).standard_normal((7, 3))
    tio.write_dmat(str(tmp_path / "m.dmat"), M)
    np.testing.assert_array_equal(jio.read_dmat(str(tmp_path / "m.dmat")), M)
    jio.write_dmat(str(tmp_path / "n.dmat"), M)
    np.testing.assert_array_equal(tio.read_dmat(str(tmp_path / "n.dmat")), M)


def test_surface_extraction():
    from mixedfem_tpu.mesh import discretization as jdisc

    V, T = _box(3, 2, 2)
    F = tdisc.boundary_facets(T)
    np.testing.assert_array_equal(F, jdisc.boundary_facets(T))
    np.testing.assert_array_equal(tdisc.edges(F), jdisc.edges(F))


# ---------------------------------------------------------------------------
# boundary conditions, press, skinning
# ---------------------------------------------------------------------------

def _bc_pair(name, flip=False, offset=5, nv_total=None):
    V, _ = _box(3, 2, 2)
    V = V + np.array([0.3, -0.2, 0.1])
    nv_total = nv_total or len(V) + 2 * offset
    jcfg = jbc.BCConfig(type=name, ratio=0.2, axis=0, velocity=0.3,
                        duration=0.05, flip=flip)
    tcfg = tbc.BCConfig(**jcfg.__dict__)
    j = jbc.build_bc(V, jcfg, nv_total, offset, dtype=jnp.float64)
    t = tbc.build_bc(V, tcfg, nv_total, offset, dtype=torch.float64,
                     device="cpu")
    return V, j, t


@pytest.mark.parametrize("name", tbc.BC_NAMES)
def test_build_bc(name):
    _, (jspec, _, jfixed, jV), (tspec, tst, tfixed, tV) = _bc_pair(name)
    np.testing.assert_array_equal(tfixed, jfixed)
    close(torch.from_numpy(tV), jV, rtol=0, atol=1e-15)
    ref = to_numpy(jspec)
    for f in ("group0", "group1", "fixed", "center", "center0", "center1",
              "vel_vec"):
        close(getattr(tspec, f), ref[f], rtol=0, atol=1e-15)
    assert (tspec.type, tspec.velocity, tspec.duration, tspec.flip) == (
        ref["type"], ref["velocity"], ref["duration"], ref["flip"])
    assert tst == tbc.BCState()


@pytest.mark.parametrize("name,flip", [
    ("stretch", False), ("translate", False), ("translate", True),
    ("twist", False), ("bend", False), ("twist-and-stretch", False),
])
def test_bc_step(name, flip):
    """Several steps, long enough for translate to expire (and, with flip,
    to reverse and expire again)."""
    V, (jspec, jst, _, _), (tspec, tst, _, _) = _bc_pair(name, flip=flip,
                                                         offset=0)
    X = np.random.default_rng(1).standard_normal(V.shape) * 0.01 + V
    jX, tX = jnp.asarray(X), t64(X)
    for _ in range(14):
        jX, jst = jbc.bc_step(jspec, jst, jX, 0.01)
        tX, tst = tbc.bc_step(tspec, tst, tX, 0.01)
        close(tX, jX, rtol=0, atol=1e-14)
        assert tst == convert.bc_state_from_numpy(to_numpy(jst))


def test_press():
    V, _ = _box(3, 2, 2)
    nv = len(V)
    forced = (V[:, 1] > 0.4).astype(np.float64)
    kw = dict(axis=1, marker=int(np.nonzero(forced)[0][0]),
              target_velocity=0.2, max_force=30.0, max_displacement=0.05)
    jspec = jpress.PressSpec(forced=jnp.asarray(forced), **kw)
    tspec = tpress.PressSpec(forced=t64(forced), **kw)
    jst = jpress.press_init(jspec, jnp.asarray(V), -20.0)
    tst = tpress.press_init(tspec, t64(V), -20.0)
    X = V.copy()
    # the marker moves the wrong way, then too slowly, then past the limit
    for dy in (0.003, -0.001, -0.0045, -0.03, -0.03):
        close(tpress.press_force(tspec, tst, nv, 3),
              jpress.press_force(jspec, jst, nv, 3), rtol=0, atol=0)
        X = X + np.array([0.0, dy, 0.0])
        jst = jpress.press_step(jspec, jst, jnp.asarray(X), 0.02)
        tst = tpress.press_step(tspec, tst, t64(X), 0.02)
        assert tst == convert.press_state_from_numpy(to_numpy(jst))
    assert tst.f == 0.0


def test_skinning():
    V, T = _box(3, 2, 2)
    rng = np.random.default_rng(2)
    Vr = rng.uniform(-0.1, 1.1, size=(40, 3)) * np.array([1.0, 0.5, 0.5])
    tid_j, bary_j = jskin.embed_in_tets(Vr, V, T)
    tid_t, bary_t = tskin.embed_in_tets(Vr, V, T)
    np.testing.assert_array_equal(tid_t, tid_j)
    np.testing.assert_allclose(bary_t, bary_j, rtol=0, atol=1e-15)
    X = V + 0.01 * rng.standard_normal(V.shape)
    np.testing.assert_allclose(
        tskin.apply_skinning(X, T, tid_t, bary_t),
        jskin.apply_skinning(X, T, tid_j, bary_j), rtol=0, atol=1e-15)


# ---------------------------------------------------------------------------
# load_scene + Simulation.step
# ---------------------------------------------------------------------------

def write_scene(d, **extra):
    """Two objects, two materials: a twisted SNH beam with a skinned
    surface, and an ARAP/SNH block (per-tet material ids) hanging from one
    end with a press on its top slab; BDF2, mixed-stretch only."""
    Va, Ta = _box(6, 3, 3)
    Vb, Tb = _box(4, 3, 3)
    tio.write_mesh(str(d / "a.mesh"), Va, Ta)
    tio.write_mesh(str(d / "b.mesh"), Vb, Tb)
    tio.write_dmat(str(d / "b_mat.dmat"), (np.arange(len(Tb)) % 2)[:, None])
    Fa = tdisc.boundary_facets(Ta)
    tio.write_obj(str(d / "a_skin.obj"), 0.98 * Va + 0.01, Fa)
    scene = {
        "dt": 0.02,
        "time_integrator": "BDF2",
        "max_newton_iterations": 3,
        "iterative_solver_tolerance": 1e-6,
        "mixed_variables": ["mixed-stretch"],
        "linear_solver": "eigen-pcg-block_jacobi",
        "material_models": [
            {"energy": "Stable-Neohookean", "youngs_modulus": 1e5,
             "poissons_ratio": 0.4, "density": 1000.0},
            {"energy": "ARAP", "youngs_modulus": 5e4, "poissons_ratio": 0.3,
             "density": 800.0},
        ],
        "objects": [
            {"path": "a.mesh", "material_index": 0, "skinning_mesh":
             "a_skin.obj", "boundary_condition": {
                 "type": "twist", "ratio": 0.1, "axis": 0, "velocity": 0.5}},
            {"path": "b.mesh", "offset": [0.0, -1.0, 0.0],
             "material_ids": "b_mat.dmat",
             "boundary_condition": {"type": "hangends", "axis": 0},
             "external_force": {
                 "type": "press", "is_body_force": False, "axis": 1,
                 "ratio": 0.2, "force": [0.0, -5.0, 0.0], "max_force": 50.0,
                 "target_velocity": 0.05, "max_displacement": 0.3}},
        ],
    }
    scene.update(extra)
    path = d / "scene.json"
    path.write_text(json.dumps(scene))
    return str(path)


@pytest.fixture(scope="module")
def scene_pair(tmp_path_factory):
    d = tmp_path_factory.mktemp("scene")
    path = write_scene(d, linear_solver="pcg")
    js = jload(path, dim=3)
    ts = tload(path, dim=3, device="cpu")
    js.enable_coarse_preconditioner(48)
    ts.enable_coarse_preconditioner(48)
    return js, ts


def test_load_scene_mesh(scene_pair):
    js, ts = scene_pair
    jm, tm = js.mesh, ts.mesh
    for f in ("V0", "dphidX", "vols", "mass_coeff", "mass_diag", "free_mask",
              "mu", "lam", "ext_force"):
        close(getattr(tm, f), getattr(jm, f), rtol=1e-14, atol=1e-14)
    for f in ("T", "model_id", "obj_id", "F_srf", "E_srf"):
        np.testing.assert_array_equal(getattr(tm, f).numpy(),
                                      np.asarray(getattr(jm, f)))
    assert tm.models == jm.models == ("ARAP", "Stable-Neohookean")
    assert ts.obj_slices == js.obj_slices
    assert ts.config == type(ts.config)(**{
        k: v for k, v in js.config.__dict__.items() if k != "matvec_scheme"})
    assert ts.coarse.naggr == js.coarse.naggr
    for (Vt, Ft, tt, bt), (Vj, Fj, tj, bj) in zip(ts.skinning, js.skinning):
        np.testing.assert_array_equal(tt, tj)
        np.testing.assert_allclose(bt, bj, rtol=0, atol=1e-15)
    for tp, jp in zip(ts.press_specs, js.press_specs):
        assert (tp.axis, tp.marker) == (jp.axis, jp.marker)
        close(tp.forced, jp.forced, rtol=0, atol=0)


@pytest.fixture(scope="module")
def scene_traj(scene_pair):
    js, ts = scene_pair
    out = []
    for _ in range(STEPS):
        js.step()
        ts.step()
        out.append((to_numpy(js.state), ts.state))
    return out


def test_scene_trajectory_positions(scene_traj):
    for jst, tst in scene_traj:
        close(tst.x, jst["x"], rtol=0, atol=1e-8)
        close(tst.s, jst["s"], rtol=0, atol=1e-8)
        close(tst.bdf.x_hist, jst["bdf"]["x_hist"], rtol=0, atol=1e-8)
    x0 = scene_traj[0][1].bdf.x_hist[-1]
    assert (scene_traj[-1][1].x - x0).abs().max() > 1e-3


def test_scene_trajectory_counts(scene_traj):
    for jst, tst in scene_traj:
        assert tst.stats.iterations == int(jst["stats"]["iterations"])
        np.testing.assert_array_equal(tst.stats.solver_iters.numpy(),
                                      jst["stats"]["solver_iters"])


def test_scene_bc_and_press_states(scene_traj):
    for jst, tst in scene_traj:
        assert tst.bc_states == tuple(
            convert.bc_state_from_numpy(b) for b in jst["bc_states"])
        for tp, jp in zip(tst.press_states, jst["press_states"]):
            want = convert.press_state_from_numpy(jp)
            assert tp.marker_pos0 == want.marker_pos0
            # the marker's position is a position of the trajectory
            np.testing.assert_allclose(
                [tp.f, tp.marker_pos], [want.f, want.marker_pos],
                rtol=0, atol=1e-8)


def test_skinned_surfaces(scene_pair, scene_traj):
    js, ts = scene_pair
    for (Vt, Ft), (Vj, Fj) in zip(ts.skinned_surfaces(), js.skinned_surfaces()):
        np.testing.assert_allclose(Vt, Vj, rtol=0, atol=1e-8)
        np.testing.assert_array_equal(Ft, Fj)


def test_initial_state_resume(tmp_path):
    """initial_state x_path / v_path replace the rest positions and the
    initial velocity; a block-Jacobi scene keeps no coarse space."""
    path = write_scene(tmp_path)
    nv = len(tio.read_mesh(str(tmp_path / "a.mesh"))[0]) + len(
        tio.read_mesh(str(tmp_path / "b.mesh"))[0])
    rng = np.random.default_rng(3)
    x = tload(path, dim=3, device="cpu").mesh.V0.numpy()
    x = x + 0.01 * rng.standard_normal(x.shape)
    v = rng.standard_normal((nv, 3))
    tio.write_dmat(str(tmp_path / "x.dmat"), x)
    tio.write_dmat(str(tmp_path / "v.dmat"), v)
    over = {"initial_state": {"x_path": "x.dmat", "v_path": "v.dmat"}}
    js = jload(path, dim=3, overrides=over)
    ts = tload(path, dim=3, overrides=over, device="cpu")
    assert ts.coarse is None and ts.config.solver == "pcg-block-jacobi"
    close(ts.state.x, js.state.x, rtol=0, atol=0)
    close(ts.state.bdf.v_hist, js.state.bdf.v_hist, rtol=0, atol=0)
    close(ts.mesh.vols, js.mesh.vols, rtol=1e-14)


@pytest.mark.parametrize("extra,dim", [
    ({}, 2),
    ({"linear_solver": "eigen-llt"}, 3),
    ({"linear_solver": "subspace-gauss_seidel"}, 3),
])
def test_uncovered_scenes_raise(tmp_path, extra, dim):
    path = write_scene(tmp_path, **extra)
    with pytest.raises(NotImplementedError):
        tload(path, dim=dim, device="cpu")


def _touching(path, drop=()):
    """Rewrite the scene at `path` with the block 0.005 (half of dhat)
    below the beam, without the keys `drop`."""
    with open(path) as f:
        scene = json.load(f)
    scene["objects"][1]["offset"] = [0.0, -0.505, 0.0]
    for k in drop:
        del scene[k]
    with open(path, "w") as f:
        json.dump(scene, f)
    return path


def _step_contact(sim):
    sim.step()
    assert sim.state.contact.nreal > 0
    assert torch.isfinite(sim.state.x).all()
    return sim.state


@pytest.mark.parametrize("extra", [
    {"mixed_variables": ["mixed-stretch", "mixed-collision"]},
    {"variables": ["friction"]},
])
def test_contact_scenes_step(tmp_path, extra, one_torch_thread):
    """Scenes with mixed-collision or lagged friction load and step, with
    candidates between the two objects."""
    sim = tload(_touching(write_scene(tmp_path, **extra)), dim=3, device="cpu")
    st = _step_contact(sim)
    if "mixed_variables" in extra:
        assert int(st.stats.active_frames[:st.stats.iterations].max()) > 0
        assert float(st.stats.min_distance[:st.stats.iterations].min()) > 0


def test_scene_without_mixed_variables_needs_contact(tmp_path,
                                                     one_torch_thread):
    """The default mixed_variables include mixed-collision (contact): such a
    scene loads and steps with contact."""
    path = _touching(write_scene(tmp_path), drop=("mixed_variables",))
    sim = tload(path, dim=3, device="cpu")
    assert sim.config.mixed_variables == ("mixed-stretch", "mixed-collision")
    st = _step_contact(sim)
    assert int(st.stats.active_frames[:st.stats.iterations].max()) > 0


def test_cli_one_step(tmp_path, capsys):
    path = write_scene(tmp_path)
    out = tmp_path / "out"
    sim = tsim.main([path, "--dim", "3", "-n", "1", "--device", "cpu",
                     "--out", str(out), "--export-obj", "--save-substeps",
                     "--timing-csv", str(tmp_path / "timing.csv")])
    assert sim.mesh.device == CPU and sim.state.step_count == 1
    text = capsys.readouterr().out
    assert "Energy" in text and "final positions bbox" in text
    for name in ("frame_0000.obj", "skin0_0000.obj", "sim_x0_0000.dmat",
                 "sim_v_0000.dmat"):
        assert (out / name).exists(), name
    np.testing.assert_allclose(
        tio.read_dmat(str(out / "sim_x0_0000.dmat")), sim.state.x.numpy(),
        rtol=0, atol=1e-15)


def test_scene_needs_a_card_unless_cpu_is_asked(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    path = write_scene(tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tload(path, dim=3)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tsim.main([path, "-n", "1", "--out", str(tmp_path / "o")])
