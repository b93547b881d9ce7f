"""The element-sharded Simulation.step with lagged friction
(config.variables, no mixed-collision) on 2 gloo ranks against the JAX
package's shard_simulation + Simulation.step on 2 virtual CPU devices,
float64: 2 steps of tests/test_collision.py's 2D drop scene with the box
thrown at the slab and sliding (the 3D scene's thousand candidate frames
make the JAX package's friction step take minutes on the CPU). The
friction terms are over contact frames, which every rank holds whole:
they join after the sum over the ranks. The nodal collision barrier is
tests/test_torch_parallel_es_collision.py's (the two in one JAX step take
over a minute to compile on the CPU). Positions and stretch to 1e-8 of
scale, Newton counts equal, CG counts within solver_parity's contact
band, JAX's frames on every rank."""

import numpy as np
import pytest

from es_parity import check, run_both
from solver_parity import CONTACT_BAND
from test_collision import drop_scene
from torch_parity import one_torch_thread  # noqa: F401

CFG = dict(h=0.01, outer_steps=3, itr_tol=1e-8, dhat=1e-2, kappa=1e5,
           enable_ccd=True, mixed_variables=("mixed-stretch",),
           variables=("friction",), contact_mu=0.3,
           dtype="float64")


@pytest.fixture(scope="module", autouse=True)
def _one_thread(one_torch_thread):
    """Every test of this module runs on one torch intra-op thread."""


def test_friction_matches_jax():
    mesh, _, n_slab = drop_scene(dim=2)
    V = np.asarray(mesh.V0)
    v0 = np.zeros_like(V)
    v0[n_slab:, 1] = -1.5
    v0[n_slab:, 0] = 0.3
    got, want = run_both(mesh, CFG, V, v0, 2)
    check(got, want, 1e-8, CONTACT_BAND)
