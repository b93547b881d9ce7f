"""The element-sharded Simulation.step with the nodal collision barrier
(config.variables, no mixed-collision) on 2 gloo ranks against the JAX
package's shard_simulation + Simulation.step on 2 virtual CPU devices,
float64: 2 steps of tests/test_collision.py's 2D drop scene with the box
thrown at the slab (the 3D scene's thousand candidate frames make the JAX
package's nodal contact step take minutes on the CPU). The nodal terms
are over contact frames, which every rank holds whole: they join after
the sum over the ranks. Friction is tests/test_torch_parallel_es_
friction.py's (the two in one JAX step take over a minute to compile on
the CPU). Positions and stretch to 1e-8 of scale, Newton counts equal,
CG counts within solver_parity's contact band, JAX's frames on every
rank; and every rank's line searches (parallel/ranks.py LineSearchTrace)
the same bits."""

import numpy as np
import pytest

from es_parity import check, run_both
from solver_parity import CONTACT_BAND
from test_collision import drop_scene
from torch_parity import one_torch_thread  # noqa: F401

CFG = dict(h=0.01, outer_steps=3, itr_tol=1e-8, dhat=1e-2, kappa=1e5,
           enable_ccd=True, mixed_variables=("mixed-stretch",),
           variables=("collision",),
           dtype="float64")


@pytest.fixture(scope="module", autouse=True)
def _one_thread(one_torch_thread):
    """Every test of this module runs on one torch intra-op thread."""


@pytest.fixture(scope="module")
def runs():
    """(the port's ranks' records with their line searches, JAX's)."""
    mesh, _, n_slab = drop_scene(dim=2)
    V = np.asarray(mesh.V0)
    v0 = np.zeros_like(V)
    v0[n_slab:, 1] = -1.5
    return run_both(mesh, CFG, V, v0, 2, trace=True)


def test_nodal_collision_matches_jax(runs):
    got, want = runs
    check(got, want, 1e-8, CONTACT_BAND)


def test_ranks_take_the_same_line_searches(runs):
    """Every line-search decision branches on values reduced over the
    ranks or held whole by every rank: the merits tried, the CCD bound
    and the accepted alpha are the same bits on both ranks, and the CCD
    bound held a step below 1."""
    got, _ = runs
    first = [r["line_search"] for r in got[0]]
    for rank_runs in got[1:]:
        assert [r["line_search"] for r in rank_runs] == first
    assert min(ls["alpha0"] for step in first for ls in step) < 0.9
