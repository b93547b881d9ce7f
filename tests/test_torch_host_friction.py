"""3-step trajectories of the port's host Newton step with the nodal
collision barrier and lagged friction (in place of mixed-collision; the
configuration of tests/test_friction.py's cholmod oracle) against the JAX
package's, in float64 on the CPU, through both packages' load_scene and
Simulation.step on the 2D drop scene of tests/test_collision.py
(torch_parity.write_tri_drop_scene) with cholmod. Positions to 1e-8,
Newton counts and alphas equal, equal counts of frames inside dhat, no
retry.

The box sits 0.01 to the right of the scene's place, so that no box
vertex lies straight above a slab vertex: there the closest point of a
frame is a vertex of both, the distance's Hessian switches branches
within rounding, and the two packages' exact solves part by 4e-7 after a
step (seen on the 3D drop scene, whose box edges run parallel to the
slab's). 2D keeps JAX's reference within the test's time: its 12x12 PSD
projection of the 3D frame Hessians takes XLA 55 s to compile, the 8x8
one of 2D frames a few seconds."""

import json

import pytest

from host_parity import compare_host_steps
from test_torch_host_contact import scene_steps
from torch_parity import (  # noqa: F401 (one_torch_thread is a fixture)
    one_torch_thread, write_tri_drop_scene,
)


@pytest.fixture(scope="module", autouse=True)
def _one_thread(one_torch_thread):
    """Every test of this module runs on one torch intra-op thread."""


def test_drop_scene_cholmod_collision_friction(tmp_path):
    path = write_tri_drop_scene(tmp_path)
    with open(path) as f:
        scene = json.load(f)
    scene["objects"][1]["offset"] = [0.36, 0.23, 0.0]
    with open(path, "w") as f:
        json.dump(scene, f)
    over = {"linear_solver": "cholmod", "mixed_variables": ["mixed-stretch"],
            "variables": ["collision", "friction"]}
    out = scene_steps(path, 2, over)
    compare_host_steps(out, str(over))
