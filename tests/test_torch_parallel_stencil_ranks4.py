"""mixedfem_tpu_torch/parallel/stencil_shard.py's sharded_newton_step on 4
gloo ranks with the grid coarse space (uneven slabs: 10 vertex planes
over 4 ranks leave the last slab short) against the port's own single-device
newton_step with the StencilPlan (held to the JAX step elsewhere),
float64: 2 steps of tests/test_sharding_full_step.py's 9 x 4 x 3 grid,
positions and stretches to 1e-8 (of scale for positions), Newton counts
equal, CG counts within 2 but for the last Newton solve."""

import pytest

from parallel_parity import stencil_vs_single
from torch_parity import one_torch_thread  # noqa: F401 (a fixture)


@pytest.fixture(scope="module", autouse=True)
def _one_thread(one_torch_thread):
    """Every test of this module runs on one torch intra-op thread."""


def test_sharded_stencil_four_ranks_two_level_match_the_single_device_step():
    stencil_vs_single(4, coarse=True)
