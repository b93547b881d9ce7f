"""The element-sharded step with a press controller (a vertex-side force,
every rank's whole, added once) on 2 gloo ranks against the JAX package's
shard_simulation + Simulation.step on 2 virtual CPU devices, float64: 2
steps of the 80-tet beam with its tip vertices pressed down, positions
and stretch to 1e-8 of scale, Newton counts equal, CG counts within 2%,
and the press states equal."""

import jax.numpy as jnp
import numpy as np
import pytest

from es_parity import check, run_both
from mixedfem_tpu.bc import press as jpress
from mixedfem_tpu.mesh import mesh as jmesh
from torch_parity import beam_arrays, one_torch_thread  # noqa: F401

CFG = dict(h=0.02, outer_steps=3, newton_tol=0.0, itr_tol=1e-8,
           max_iterative_solver_iters=500, dtype="float64",
           mixed_variables=("mixed-stretch",))


@pytest.fixture(scope="module", autouse=True)
def _one_thread(one_torch_thread):
    """Every test of this module runs on one torch intra-op thread."""


def test_press_matches_jax():
    V, T, kw, _ = beam_arrays(4, 2, 2)
    mesh = jmesh.build_mesh_data(V, T, dtype=jnp.float64, **kw)
    forced = (V[:, 0] > 3.9).astype(np.float64)
    spec = jpress.PressSpec(
        forced=jnp.asarray(forced), axis=1,
        marker=int(np.nonzero(forced)[0][0]), target_velocity=-0.5,
        max_force=2e4, max_displacement=0.5)
    press = [(spec, jpress.press_init(spec, jnp.asarray(V), -5e3))]
    got, want = run_both(mesh, CFG, V, np.zeros_like(V), 2, press=press)
    check(got, want, 1e-8, 0.02)
    # the press pulled the tip down further than gravity alone
    assert want[-1]["x"][forced > 0, 1].mean() < V[forced > 0, 1].mean()
