"""The element-sharded Simulation.step with 2D mixed-IPC contact and CCD
on 4 gloo ranks against the JAX package's shard_simulation +
Simulation.step on 4 virtual CPU devices, float64: 2 steps of
tests/test_collision.py's 2D drop scene (12 triangles, 3 a rank) with the
box thrown at the slab, so that frames activate and the first step is
re-run once with a wider candidate margin (the retry, taken on every rank
alike). Positions and stretch to 1e-8 of scale, Newton counts equal, CG
counts within solver_parity's contact band, JAX's frames on every rank."""

import numpy as np
import pytest

from es_parity import check, run_both
from solver_parity import CONTACT_BAND
from test_collision import drop_scene
from torch_parity import one_torch_thread  # noqa: F401

CFG = dict(h=0.01, outer_steps=3, itr_tol=1e-8, dhat=1e-2, kappa=1e5,
           enable_ccd=True, mixed_variables=("mixed-stretch",
                                             "mixed-collision"),
           dtype="float64")


@pytest.fixture(scope="module", autouse=True)
def _one_thread(one_torch_thread):
    """Every test of this module runs on one torch intra-op thread."""


def test_2d_contact_scene_matches_jax_on_4_ranks():
    mesh, _, n_slab = drop_scene(dim=2)
    V = np.asarray(mesh.V0)
    v0 = np.zeros_like(V)
    v0[n_slab:, 1] = -1.5
    got, want = run_both(mesh, CFG, V, v0, 4)
    check(got, want, 1e-8, CONTACT_BAND)
    for rank_runs in got:
        assert [g["retries"] for g in rank_runs] == [1, 1]
        assert rank_runs[-1]["active"] > 0
