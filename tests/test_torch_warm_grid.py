"""Warm-started rotations on a grid plan against mixedfem_tpu, in float64
on the CPU: the 360-tet swinging grid of tests/test_torch_lattice_cg.py
with 'pcg', its grid coarse space and rotation_warm_start, where the JAX
step refuses its row body (`not warm_R`) and runs its `use_stencil_cg`
branch, the port its 'lattice_cg' body. 3 steps: positions, stretches
and rotations to 1e-8, Newton counts, CG counts and alphas equal."""

import pytest

from test_torch_lattice_cg import check_trajectory, grid  # noqa: F401
from torch_parity import one_torch_thread  # noqa: F401 (a fixture)


@pytest.fixture(scope="module", autouse=True)
def _one_thread(one_torch_thread):
    """Every test of this module runs on one torch intra-op thread."""


def test_trajectory_warm_start(grid):  # noqa: F811
    check_trajectory(grid, dict(solver="pcg", coarse=True,
                                rotation_warm_start=True))
