"""The solver family through the scene loader: the drop scene of
tests/test_collision.py (contact, float64, CPU) stepped 3 times with 3
Newton iterations by both packages' load_scene and Simulation.step with
minres-indefinite-block and subspace-CG (held by
solver_parity.drop_scene_trajectory: positions to 1e-8, equal Newton
counts, alphas and active frames, solver counts within its contact band).
The other contact solvers' scenes are in test_torch_solvers_contact.py
and test_torch_solvers_scene_da.py."""

import pytest

from solver_parity import drop_scene_trajectory
from torch_parity import one_torch_thread  # noqa: F401 (a fixture)


@pytest.fixture(scope="module", autouse=True)
def _one_thread(one_torch_thread):
    """Every test of this module runs on one torch intra-op thread."""


@pytest.mark.parametrize("name", ["minres-indefinite-block", "subspace-CG"])
def test_drop_scene(tmp_path, name):
    drop_scene_trajectory(tmp_path, name)
