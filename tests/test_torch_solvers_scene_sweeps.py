"""The drop scene of tests/test_collision.py (contact, float64, CPU)
stepped 3 times with 3 Newton iterations by both packages' load_scene and
Simulation.step with admm-solver and subspace-gauss_seidel (held by
solver_parity.drop_scene_trajectory: positions to 1e-8, equal Newton
counts, alphas and active frames, solver counts within its contact band),
and the loader's Gauss-Seidel coloring against the JAX loader's."""

import numpy as np
import pytest

from solver_parity import drop_scene_trajectory
from torch_parity import one_torch_thread  # noqa: F401 (a fixture)


@pytest.fixture(scope="module", autouse=True)
def _one_thread(one_torch_thread):
    """Every test of this module runs on one torch intra-op thread."""


def test_drop_scene_admm(tmp_path):
    """admm-solver: ADMM takes hundreds of sweeps per Newton iteration on
    this scene; both packages stop at the same cap of 40."""
    drop_scene_trajectory(tmp_path, "admm-solver",
                          max_iterative_solver_iters=40)


def test_drop_scene_gauss_seidel(tmp_path):
    """subspace-gauss_seidel: the loader builds the coloring (JAX's colors)
    and Simulation.step passes it to newton_step."""
    js, ts = drop_scene_trajectory(tmp_path, "subspace-gauss_seidel")
    assert ts.gs_plan.ncolors == js.gs_plan.ncolors
    np.testing.assert_array_equal(ts.gs_plan.masks.numpy(),
                                  np.asarray(js.gs_plan.masks))
