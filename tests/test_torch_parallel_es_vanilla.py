"""The element-sharded step with the vanilla F-space stretch beside the
mixed one, and the vanilla gradient norm recorded at every Newton iterate
(record_vanilla_gradient; the norm is over x, which every rank holds
whole), on 2 gloo ranks against the JAX package's shard_simulation +
Simulation.step on 2 virtual CPU devices, float64: 2 steps of the swinging
80-tet beam with pcg-block-jacobi, positions and stretch to 1e-8 of scale,
the recorded norms to 1e-8 of the step's largest (the later norms are
residuals, small beside the first), Newton counts equal, CG counts within
2%."""

import jax.numpy as jnp
import numpy as np
import pytest

from es_parity import check, run_both
from mixedfem_tpu.mesh import mesh as jmesh
from solver_parity import swing
from torch_parity import beam_arrays, one_torch_thread  # noqa: F401

CFG = dict(h=0.02, outer_steps=3, newton_tol=0.0, itr_tol=1e-6,
           max_iterative_solver_iters=500, dtype="float64",
           mixed_variables=("mixed-stretch",), variables=("stretch",),
           record_vanilla_gradient=True, solver="pcg-block-jacobi")


@pytest.fixture(scope="module", autouse=True)
def _one_thread(one_torch_thread):
    """Every test of this module runs on one torch intra-op thread."""


def test_vanilla_stretch_matches_jax():
    V, T, kw, _ = beam_arrays(4, 2, 2)
    mesh = jmesh.build_mesh_data(V, T, dtype=jnp.float64, **kw)
    got, want = run_both(mesh, CFG, V, swing(V), 2)
    check(got, want, 1e-8, 0.02)
    for k, w in enumerate(want):
        assert w["vanilla_grad"].min() > 0
        for rank_runs in got:
            np.testing.assert_allclose(rank_runs[k]["vanilla_grad"],
                                       w["vanilla_grad"], rtol=0,
                                       atol=1e-8 * w["vanilla_grad"].max())
