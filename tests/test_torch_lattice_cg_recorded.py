"""The lattice-resident CG body with a recorded vanilla gradient against
mixedfem_tpu, in float64 on the CPU: case (c) of
tests/test_torch_lattice_cg.py ('pcg' with the grid coarse space and
record_vanilla_gradient on the 360-tet swinging grid, where the JAX step
refuses its row body and runs its `use_stencil_cg` branch). Positions and
stretches to 1e-8, Newton counts, CG counts and alphas equal, the
vanilla gradient norms to 1e-8 of the largest."""

import pytest

from test_torch_lattice_cg import CASES, check_trajectory, grid  # noqa: F401
from torch_parity import one_torch_thread  # noqa: F401 (a fixture)


@pytest.fixture(scope="module", autouse=True)
def _one_thread(one_torch_thread):
    """Every test of this module runs on one torch intra-op thread."""


def test_trajectory_recorded_gradient(grid):  # noqa: F811
    check_trajectory(grid, CASES["recorded_gradient"])
