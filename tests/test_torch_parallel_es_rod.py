"""The element-sharded step of rods on gloo ranks against the JAX
package's shard_simulation + Simulation.step on as many virtual CPU
devices, float64: 2 steps of tests/test_rod.py's chain_rod(9) (8
segments, K1's and K7's k2d3 instances on each rank's slice) on 2 ranks
(4 ranks: tests/test_torch_parallel_es_rod4.py), positions and stretch
to 1e-8 of scale, Newton and CG counts equal (CG to 1e-8, as
tests/test_torch_rod.py says why)."""

import numpy as np
import pytest

from es_parity import check, run_both
from test_rod import chain_rod
from torch_parity import one_torch_thread  # noqa: F401

CFG = dict(h=0.01, outer_steps=3, itr_tol=1e-8,
           max_iterative_solver_iters=2000,
           mixed_variables=("mixed-stretch",), dtype="float64")


@pytest.fixture(scope="module", autouse=True)
def _one_thread(one_torch_thread):
    """Every test of this module runs on one torch intra-op thread."""


def test_chain_rod_matches_jax():
    mesh, V = chain_rod(9)
    got, want = run_both(mesh, CFG, V, np.zeros_like(V), 2)
    check(got, want, 1e-8, 0)
    assert want[-1]["x"][-1, 1] < 0
