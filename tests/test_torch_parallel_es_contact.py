"""The element-sharded Simulation.step with mixed-IPC contact and CCD on 2
gloo ranks against the JAX package's shard_simulation + Simulation.step
on 2 virtual CPU devices, float64: 2 steps of tests/test_collision.py's
3D drop scene with the box thrown at the slab (some frames active in the
second step). Positions and stretch to 1e-8 of scale, Newton counts
equal, CG counts within solver_parity's contact band; every rank holds
JAX's candidate frames (the broadphase runs on every rank over the whole
positions); and the merit at the base point of every Newton iteration is
the port's single-device merit, so the contact terms, which every rank
holds whole, are counted once."""

import numpy as np
import pytest

from es_parity import check, run_both, single_device
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


def test_contact_scene_matches_jax_and_counts_contact_once():
    mesh, _, n_slab = drop_scene(dim=3)
    V = np.asarray(mesh.V0)
    v0 = np.zeros_like(V)
    v0[n_slab:, 1] = -0.8
    (got, one), want = run_both(mesh, CFG, V, v0, 2, also=lambda: single_device(
        mesh, CFG, V, v0))
    check(got, want, 1e-8, CONTACT_BAND)
    assert one[-1]["active"] > 0
    for k, w in enumerate(one):
        for rank_runs in got:
            g = rank_runs[k]
            assert g["iterations"] == w["iterations"]
            assert g["active"] == w["active"]
            np.testing.assert_allclose(g["energy"], w["energy"], rtol=1e-12)
            np.testing.assert_array_equal(g["frames"], w["frames"])
