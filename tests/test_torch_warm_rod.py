"""Warm-started rotations on rods against mixedfem_tpu, in float64 on the
CPU: 3 steps of tests/test_rod.py's hanging chain_rod(9) through
newton_step with rotation_warm_start (a rod's F is 3x3, so its update
takes the warm polar), at tests/test_torch_rod.py's settings (CG to 1e-8:
the chain's 1e-10 stop is rounding's to decide, as that file says).
Positions, stretches and rotations to 1e-8, Newton counts, CG counts and
alphas equal."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mixedfem_tpu.config import SimConfig as JConfig
from mixedfem_tpu.mesh import mesh as jmesh
from mixedfem_tpu.optimizer import newton as jnewton
from mixedfem_tpu_torch.config import SimConfig as TConfig
from mixedfem_tpu_torch.optimizer import newton as tnewton

from test_torch_rod import STEP
from torch_parity import (  # noqa: F401 (one_torch_thread is a fixture)
    close, one_torch_thread, port, rod_arrays, to_numpy,
)


@pytest.fixture(scope="module", autouse=True)
def _one_thread(one_torch_thread):
    """Every test of this module runs on one torch intra-op thread."""


def test_trajectory_warm_start():
    V, E, kw = rod_arrays()
    jm = jmesh.build_rod_mesh_data(V, E, dtype=jnp.float64, **kw)
    cfg = dict(STEP, rotation_warm_start=True)
    jcfg, tcfg = JConfig(**cfg), TConfig(**cfg)
    x0 = jnp.asarray(V)
    st = jnewton.init_state(jm, jcfg, (), x0, jnp.zeros_like(x0))
    assert st.R.shape == (len(E), 3, 3)
    tm, ts, _ = port(mesh=jm, state=st)
    close(tnewton.init_state(tm, tcfg, (), ts.x, torch.zeros_like(ts.x)).R,
          st.R, rtol=0, atol=1e-12)
    jstep = jax.jit(lambda s: jnewton.newton_step(jm, jcfg, (), s))
    for _ in range(3):
        st = jstep(st)
        ts = tnewton.newton_step(tm, tcfg, (), ts)
        js = to_numpy(st)
        close(ts.x, js["x"], rtol=0, atol=1e-8)
        close(ts.s, js["s"], rtol=0, atol=1e-8)
        close(ts.R, js["R"], rtol=0, atol=1e-8)
        assert ts.stats.iterations == int(js["stats"]["iterations"]) > 0
        np.testing.assert_array_equal(ts.stats.solver_iters.numpy(),
                                      js["stats"]["solver_iters"])
        close(ts.stats.alpha, js["stats"]["alpha"], rtol=0, atol=0)
    # the chain swings: its rotations moved off the rest frame's
    R_rest = tnewton.init_state(tm, tcfg, (), tm.V0, torch.zeros_like(tm.V0)).R
    assert float((ts.R - R_rest).abs().max()) > 1e-3
