"""The f64 islands' pieces with mixed contact against mixedfem_tpu's, on
the CPU: at a float32 state of the drop scene's slab and box inside dhat
(tests/test_torch_contact.py's pair, half the real frames active before),
the inertia gradient, the float64 coefficient and mixed-contact updates,
the rhs, both local solves and the merit at alpha = 0 and 0.5 against the
JAX step's float64 pieces (mixedfem_tpu/optimizer/newton.py:667-745,
:1145-1149, :1175-1191), to 1e-12 relative. And the drop scene through
load_scene (overrides rhs_precision='float64' and rotation_warm_start, in
float32) and Simulation.step: the state carries the rotations from
init_state on, every Newton iteration takes its update from the islands,
and the steps stay in contact, feasible and finite."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mixedfem_tpu.integrators import bdf as jbdf
from mixedfem_tpu.variables import mixed_stretch as jms
from mixedfem_tpu_torch.integrators import bdf as tbdf
from mixedfem_tpu_torch.variables import mixed_collision as tmc

from mixedfem_tpu_torch.io.scene import load_scene
from mixedfem_tpu_torch.optimizer import newton as tnewton

from test_torch_contact import DHAT, KAPPA, _prev, _two_boxes
from test_torch_islands import F32, _JPIECES, _hold, _port_pieces
from torch_parity import (  # noqa: F401 (one_torch_thread is a fixture)
    CPU, SolveRecorder, one_torch_thread, port, write_drop_scene,
)


@pytest.fixture(scope="module", autouse=True)
def _one_thread(one_torch_thread):
    """Every test of this module runs on one torch intra-op thread."""


def test_pieces_drop_scene():
    """The drop scene's slab and box inside dhat, float32: the island
    pieces with mixed contact (half the real frames active before) to
    1e-12 relative."""
    mesh, x, jcf, _ = _two_boxes(pin_slab=True)
    jm = jax.tree.map(lambda a: a.astype(jnp.float32)
                      if hasattr(a, "dtype") and a.dtype == jnp.float64 else a,
                      mesh)
    tm = port(mesh=jm, dtype=F32)[0]
    f, t, m = (np.asarray(a) for a in (jcf.frames, jcf.ftype, jcf.fmask))
    tcf = tmc.contact_frames(f, t, m, len(x), F32, CPU)
    C, n = len(f), tcf.nreal
    d, la, act = (a.astype(np.float32) for a in _prev(C, n, 9))
    rng = np.random.default_rng(5)
    x32 = x.astype(np.float32)
    s = np.asarray(jms.reset(mesh, jnp.asarray(x))[0])
    s32 = (s + 0.01 * rng.standard_normal(s.shape)).astype(np.float32)
    v32 = (0.3 * rng.standard_normal(x.shape)).astype(np.float32)
    dx = (1e-3 * rng.standard_normal(x.shape)).astype(np.float32)
    dx *= np.asarray(jm.free_mask)[:, None]
    jb = jbdf.bdf_init("BDF1", jnp.asarray(x32), jnp.asarray(v32), 0.01)
    tb = tbdf.bdf_init("BDF1", torch.tensor(x32), torch.tensor(v32), 0.01)
    jcf32 = jcf.replace(fmask=jnp.asarray(m, jnp.float32))
    want = _JPIECES(jm, jb, jnp.asarray(x32), jnp.asarray(s32),
                    jnp.asarray(dx), 1.0, None, jcf32,
                    tuple(jnp.asarray(a) for a in (d, la, act)), DHAT, KAPPA)
    got = _port_pieces(tm, tb, torch.tensor(x32), torch.tensor(s32),
                       torch.tensor(dx), 1.0, None, tcf,
                       tuple(torch.tensor(a[:n]) for a in (d, la, act)), DHAT,
                       KAPPA)
    assert int(torch.count_nonzero(got["cH"])) > 0
    _hold(got, want, n)


def test_scene_steps_with_islands_and_warm_start(tmp_path):
    sim = load_scene(write_drop_scene(tmp_path), dim=3, dtype="float32",
                     device="cpu", overrides={"rhs_precision": "float64",
                                              "rotation_warm_start": True})
    assert sim.config.rhs_precision == "float64"
    E = sim.mesh.nelem
    R0 = sim.state.R
    assert R0.shape == (E, 3, 3) and R0.dtype == F32
    newton_its = 0
    with SolveRecorder(tnewton, "island_update", iters_at=None) as rec:
        for _ in range(3):
            st = sim.step()
            it = st.stats.iterations
            newton_its += it
            assert it > 0 and torch.isfinite(st.x).all()
            assert int(st.stats.active_frames[it - 1]) > 0
            assert float(st.stats.min_distance[:it].min()) > 0
    # one island update a Newton iteration (more where a step was retried)
    if sim.retries:
        assert len(rec.calls) > newton_its
    else:
        assert len(rec.calls) == newton_its
    assert all(kw["cf"] is not None for _, kw, _ in rec.calls)
    assert st.R.shape == (E, 3, 3) and not torch.equal(st.R, R0)

