"""The lattice-resident CG body with block-Jacobi alone against
mixedfem_tpu, in float64 on the CPU: case (b) of
tests/test_torch_lattice_cg.py ('pcg-block-jacobi', no coarse space, an
inertia blend of 0.5 on the 360-tet swinging grid, where the JAX step
refuses its row body and runs its `use_stencil_cg` branch). Positions and
stretches to 1e-8, Newton counts, CG counts and alphas equal."""

import pytest

from test_torch_lattice_cg import CASES, check_trajectory, grid  # noqa: F401
from torch_parity import one_torch_thread  # noqa: F401 (a fixture)


@pytest.fixture(scope="module", autouse=True)
def _one_thread(one_torch_thread):
    """Every test of this module runs on one torch intra-op thread."""


def test_trajectory_block_jacobi(grid):  # noqa: F811
    check_trajectory(grid, CASES["blend_block_jacobi"])
