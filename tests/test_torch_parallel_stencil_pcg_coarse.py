"""mixedfem_tpu_torch/parallel/stencil_shard.py's sharded_pcg with the grid
coarse space (2 gloo ranks on the CPU) against
mixedfem_tpu/parallel/stencil_shard.py's on 2 virtual CPU devices,
float64: tests/test_stencil_shard.py's two-level solve on the 9 x 4 x 3
grid, to 1e-8 of scale with iteration counts within 2."""

import pytest

from test_torch_parallel_stencil_pcg import check_pcg
from torch_parity import one_torch_thread  # noqa: F401 (a fixture)


@pytest.fixture(scope="module", autouse=True)
def _one_thread(one_torch_thread):
    """Every test of this module runs on one torch intra-op thread."""


def test_sharded_pcg_two_level_matches_jax():
    check_pcg("two-level")
