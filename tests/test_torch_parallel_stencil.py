"""mixedfem_tpu_torch/parallel/stencil_shard.py's sharded_newton_step (2
gloo ranks on the CPU, one I-slab each) against
mixedfem_tpu/parallel/stencil_shard.py on 2 virtual CPU devices, float64,
with block-Jacobi: 2 steps of tests/test_sharding_full_step.py's 9 x 4 x 3
box grid. Positions and stretches to 1e-8 (of scale for positions),
Newton counts equal, CG counts within 2% but for the last Newton solve
(parallel_parity.check_steps says why)."""

import pytest

from parallel_parity import check_stencil, stencil_run_both
from torch_parity import one_torch_thread  # noqa: F401 (a fixture)


@pytest.fixture(scope="module", autouse=True)
def _one_thread(one_torch_thread):
    """Every test of this module runs on one torch intra-op thread."""


def test_sharded_stencil_step_matches_jax():
    got, want = stencil_run_both(coarse=False)
    check_stencil(got, want, 1e-8, 0.02)
