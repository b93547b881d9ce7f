"""mixedfem_tpu_torch/parallel/stencil_shard.py's sharded_newton_step with
the grid coarse space (2 gloo ranks on the CPU) against
mixedfem_tpu/parallel/stencil_shard.py on 2 virtual CPU devices, float64:
2 steps of tests/test_sharding_full_step.py's 9 x 4 x 3 box grid with its
lattice-block coarse space (block 2). Positions and stretches to 1e-8,
Newton counts equal, CG counts within 2% but for the last Newton solve."""

import pytest

from parallel_parity import check_stencil, stencil_run_both
from torch_parity import one_torch_thread  # noqa: F401 (a fixture)


@pytest.fixture(scope="module", autouse=True)
def _one_thread(one_torch_thread):
    """Every test of this module runs on one torch intra-op thread."""


def test_sharded_stencil_two_level_matches_jax():
    got, want = stencil_run_both(coarse=True)
    check_stencil(got, want, 1e-8, 0.02)
