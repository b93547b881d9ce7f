"""The drop scene of tests/test_collision.py (contact, float64, CPU)
stepped 3 times with 3 Newton iterations by both packages' load_scene and
Simulation.step with eigen-pcg-dualascent (held by
solver_parity.drop_scene_trajectory: positions to 1e-8, equal Newton
counts, alphas and active frames, solver counts within its contact
band)."""

import pytest

from solver_parity import drop_scene_trajectory
from torch_parity import one_torch_thread  # noqa: F401 (a fixture)


@pytest.fixture(scope="module", autouse=True)
def _one_thread(one_torch_thread):
    """Every test of this module runs on one torch intra-op thread."""


def test_drop_scene_dualascent(tmp_path):
    """eigen-pcg-dualascent: the dual-ascent loop runs where frames are
    active, with the JAX step's power-iteration start vector."""
    drop_scene_trajectory(tmp_path, "eigen-pcg-dualascent")
