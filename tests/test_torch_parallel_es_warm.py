"""The element-sharded step with warm-started rotations (SimState.R
sliced like s and la, each rank's polar seeded with its slice) on 2 gloo
ranks against the JAX package's shard_simulation + Simulation.step on 2
virtual CPU devices, float64: 2 steps of the swinging 80-tet beam with
pcg, positions and stretch to 1e-8 of scale, Newton counts equal, CG
counts within 2%."""

import jax.numpy as jnp
import pytest

from es_parity import check, run_both
from mixedfem_tpu.mesh import mesh as jmesh
from solver_parity import swing
from torch_parity import beam_arrays, one_torch_thread  # noqa: F401

CFG = dict(h=0.02, outer_steps=3, newton_tol=0.0, itr_tol=1e-6,
           max_iterative_solver_iters=500, dtype="float64",
           mixed_variables=("mixed-stretch",), rotation_warm_start=True)


@pytest.fixture(scope="module", autouse=True)
def _one_thread(one_torch_thread):
    """Every test of this module runs on one torch intra-op thread."""


def test_warm_rotations_match_jax():
    V, T, kw, _ = beam_arrays(4, 2, 2)
    mesh = jmesh.build_mesh_data(V, T, dtype=jnp.float64, **kw)
    got, want = run_both(mesh, CFG, V, swing(V), 2)
    check(got, want, 1e-8, 0.02)
