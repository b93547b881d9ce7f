"""The element-sharded step with a banded plan (each rank's K4 plan over
its own slice, in banded order) on 2 gloo ranks, float64, 2 steps of the
swinging 80-tet beam (torch_parity.beam_arrays(4, 2, 2), banded element
order) with pcg-block-jacobi: held to the port's single-device step with
the whole mesh's banded plan and to the JAX package's shard_simulation +
Simulation.step on 2 virtual CPU devices without a plan (the same
function: the JAX banded plan runs its Pallas kernel, which has no CPU
path outside interpret mode), positions and stretch to 1e-8 of scale
(1e-12 against the port's own single-device step), Newton counts equal,
CG counts within 2%."""

import jax.numpy as jnp
import numpy as np
import pytest

from es_parity import check, run_both, single_device
from mixedfem_tpu.mesh import mesh as jmesh
from solver_parity import swing
from torch_parity import beam_arrays, one_torch_thread  # noqa: F401

CFG = dict(h=0.02, outer_steps=3, newton_tol=0.0, itr_tol=1e-6,
           max_iterative_solver_iters=500, dtype="float64",
           mixed_variables=("mixed-stretch",), solver="pcg-block-jacobi")


@pytest.fixture(scope="module", autouse=True)
def _one_thread(one_torch_thread):
    """Every test of this module runs on one torch intra-op thread."""


def test_banded_ranks_match_single_device_and_jax():
    V, T, kw, _ = beam_arrays(4, 2, 2)
    mesh = jmesh.build_mesh_data(V, T, dtype=jnp.float64, **kw)
    v0 = swing(V)
    (got, one), want = run_both(mesh, CFG, V, v0, 2, banded=True,
                                also=lambda: single_device(
                                    mesh, CFG, V, v0, banded=True))
    check(got, want, 1e-8, 0.02)
    check(got, one, 1e-12, 0.02)
