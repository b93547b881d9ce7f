"""The solver family on the 2D path and through the port's CLI, against
mixedfem_tpu in float64 on the CPU:

- minres-kkt and pcg-laplacian step the swinging 200-triangle cantilever
  (tri_arrays) 3 times with 3 Newton iterations through newton_step, held
  by solver_parity.compare_steps (positions to 1e-8, equal Newton counts
  and alphas, equal CG counts, MINRES counts as check_minres_counts holds
  them);
- every on-device solver name steps the drop scene once through the CLI."""

import json

import jax.numpy as jnp
import pytest
import torch

from mixedfem_tpu.mesh import mesh as jmesh
from mixedfem_tpu_torch.apps import sim as tsim
from mixedfem_tpu_torch.solvers import factory as tfactory

import solver_parity as sp
from torch_parity import (  # noqa: F401 (one_torch_thread is a fixture)
    one_torch_thread, tri_arrays, write_drop_scene,
)


@pytest.fixture(scope="module", autouse=True)
def _one_thread(one_torch_thread):
    """Every test of this module runs on one torch intra-op thread."""


@pytest.mark.parametrize("solver", ["minres-kkt", "pcg-laplacian"])
def test_cantilever_2d(solver):
    V, T, kw, _ = tri_arrays()
    jm = jmesh.build_mesh_data(V, T, dtype=jnp.float64, **kw)
    out, recs, jcfg = sp.mesh_trajectory(V, jm, solver)
    sp.compare_steps(out, recs, f"2D {solver}", jm, jcfg)


def test_cli_every_solver(tmp_path, capsys):
    """One step of the drop scene (1 Newton iteration, itr_tol 1e-4, at most
    50 solver iterations) through the CLI with --solver for every path
    that takes contact: the on-device paths and the host paths 'direct'
    and 'pcg-ic'; 'amgcl' refuses the scene's mixed-collision frames, as
    in the JAX package."""
    path = write_drop_scene(tmp_path, newton=1)
    with open(path) as f:
        scene = json.load(f)
    # a short solve keeps the slower paths (dual ascent, ADMM) quick
    scene.update(iterative_solver_tolerance=1e-4, max_iterative_solver_iters=50)
    with open(path, "w") as f:
        json.dump(scene, f)
    for solver in tfactory.INTERNAL_SOLVERS:
        if solver == "amgcl":
            with pytest.raises(NotImplementedError, match="dual system only"):
                tsim.main([path, "--dim", "3", "-n", "1", "--device", "cpu",
                           "--out", str(tmp_path / "out"), "--dtype",
                           "float64", "--solver", solver])
            continue
        sim = tsim.main([path, "--dim", "3", "-n", "1", "--device", "cpu",
                         "--out", str(tmp_path / "out"), "--dtype", "float64",
                         "--solver", solver])
        assert sim.config.solver == solver and sim.state.step_count == 1
        assert torch.isfinite(sim.state.x).all()
        assert (sim.gs_plan is not None) == (solver == "gauss-seidel")
    assert "Energy" in capsys.readouterr().out
