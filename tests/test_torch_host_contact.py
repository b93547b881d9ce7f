"""3-step trajectories of the port's host Newton step with contact
against the JAX package's, in float64 on the CPU, through both packages'
load_scene and Simulation.step: eigen-llt ('direct') with mixed-collision
(the loader's default) on the drop scene of tests/test_collision.py
(torch_parity.write_drop_scene). Positions to 1e-8, Newton counts and
alphas equal, equal counts of frames inside dhat, no retry. The nodal
collision and friction variables with cholmod are
tests/test_torch_host_friction.py's."""

import numpy as np
import pytest

from mixedfem_tpu.collision import distances as jdist
from mixedfem_tpu.io.scene import load_scene as jload
from mixedfem_tpu_torch.collision import distances as tdist
from mixedfem_tpu_torch.io.scene import load_scene as tload

from host_parity import compare_host_steps, jitted_jax
from torch_parity import (  # noqa: F401 (one_torch_thread is a fixture)
    one_torch_thread, to_numpy, write_drop_scene,
)


@pytest.fixture(scope="module", autouse=True)
def _one_thread(one_torch_thread):
    """Every test of this module runs on one torch intra-op thread."""


def inside(cf, x, dhat, dist, conv):
    """Real candidates with distance < dhat at positions x (conv makes the
    package's arrays)."""
    n = int((np.asarray(cf.fmask) > 0).sum())
    f = np.asarray(cf.frames)[:n].astype(np.int64)
    t = np.asarray(cf.ftype)[:n]
    D = np.asarray(dist.frame_distance(conv(np.asarray(x)[f]), conv(t)))
    return int((D < dhat).sum())


def scene_steps(path, dim, over):
    """3 Simulation.step calls of both packages on the scene at `path`:
    [(JAX state as numpy, port state)], with equal counts of frames inside
    dhat after each step (at least one after some step) and no retry."""
    import torch

    js = jload(path, dim=dim, dtype="float64", overrides=over)
    ts = tload(path, dim=dim, dtype="float64", overrides=over, device="cpu")
    assert ts.config.solver == "direct"
    out, seen = [], 0
    with jitted_jax():
        for _ in range(3):
            js.step()
            ts.step()
            dhat = ts.config.dhat
            n_t = inside(ts.state.contact, ts.state.x.numpy(), dhat, tdist,
                         torch.as_tensor)
            assert n_t == inside(js.state.contact, js.state.x, dhat, jdist,
                                 np.asarray)
            seen += n_t
            out.append((to_numpy(js.state), ts.state))
    assert ts.retries == 0 and seen > 0
    return out


def test_drop_scene_eigen_llt(tmp_path):
    over = {"linear_solver": "eigen-llt"}
    out = scene_steps(write_drop_scene(tmp_path), 3, over)
    compare_host_steps(out, str(over))
    for _, st in out:
        it = st.stats.iterations
        assert int(st.stats.active_frames[:it].max()) > 0
        assert float(st.stats.min_distance[:it].min()) > 0
