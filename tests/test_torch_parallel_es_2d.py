"""The element-sharded step of a 2D triangle solid (K1's and K3's
triangle instances on each rank's slice) on 2 gloo ranks against the JAX
package's shard_simulation + Simulation.step on 2 virtual CPU devices,
float64: 2 steps of the swinging 2D cantilever (torch_parity.tri_arrays
at 8 x 2 cells, 32 triangles), positions and stretch to 1e-8 of scale,
Newton and CG counts equal."""

import jax.numpy as jnp
import numpy as np
import pytest

from es_parity import check, run_both
from mixedfem_tpu.mesh import mesh as jmesh
from solver_parity import swing
from torch_parity import one_torch_thread, tri_arrays  # noqa: F401

CFG = dict(h=0.02, outer_steps=3, itr_tol=1e-8,
           mixed_variables=("mixed-stretch",), dtype="float64")


@pytest.fixture(scope="module", autouse=True)
def _one_thread(one_torch_thread):
    """Every test of this module runs on one torch intra-op thread."""


def test_2d_cantilever_matches_jax():
    V, T, kw, _ = tri_arrays(8, 2)
    mesh = jmesh.build_mesh_data(V, T, dtype=jnp.float64, **kw)
    got, want = run_both(mesh, CFG, V, swing(V), 2)
    check(got, want, 1e-8, 0)
