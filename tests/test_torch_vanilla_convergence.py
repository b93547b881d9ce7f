"""The port's convergence harness (mixedfem_tpu_torch/apps/convergence.py)
against the top-level apps/convergence.py, in float64 on the CPU: a 2D
cantilever scene written to a temporary directory, 3 steps of its mixed
Newton solver with the vanilla gradient norm recorded at every iterate;
the two .dmat files agree to 1e-8 relative, through run_convergence and
through the port's command line (--device cpu). Three Newton iterations
at itr_tol 1e-4 keep every recorded norm above the rounding floor (a
fourth, converged to it, read 1.4e-8 in one package and 2.8e-8 in the
other)."""

import importlib.util
import os

import numpy as np
import pytest

from mixedfem_tpu_torch.apps import convergence as tconv
from mixedfem_tpu_torch.io import mesh_io as tio
from mixedfem_tpu_torch.mesh import generators

from solver_parity import near
from torch_parity import (  # noqa: F401 (one_torch_thread is a fixture)
    one_torch_thread, write_tri_scene,
)


@pytest.fixture(scope="module", autouse=True)
def _one_thread(one_torch_thread):
    """Every test of this module runs on one torch intra-op thread."""


def _jax_app():
    path = os.path.join(os.path.dirname(__file__), "..", "apps",
                        "convergence.py")
    spec = importlib.util.spec_from_file_location("jax_convergence_app", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def scene_and_reference(tmp_path_factory):
    d = tmp_path_factory.mktemp("conv")
    path = write_tri_scene(
        d, [("beam", generators.grid_tri_mesh(20, 5, size=(4.0, 1.0)),
             {"normalize": False, "boundary_condition":
              {"type": "hangends", "axis": 0, "ratio": 0.05}})],
        mixed_variables=["mixed-stretch"], max_newton_iterations=3,
        linear_solver="eigen-pcg-block_jacobi", iterative_solver_tolerance=1e-4)
    out = str(d / "jax" / "convergence.dmat")
    want = _jax_app().run_convergence(path, 2, 3, out, dtype="float64")
    return path, d, want


def test_run_convergence(scene_and_reference):
    path, d, want = scene_and_reference
    out = str(d / "port" / "convergence.dmat")
    got = tconv.run_convergence(path, 2, 3, out, dtype="float64",
                                device="cpu")
    assert got.shape == want.shape == (3, 3) and (want > 0).all()
    near(got, want, 1e-8)
    near(tio.read_dmat(out), want, 1e-8)


def test_cli(scene_and_reference):
    path, d, want = scene_and_reference
    out = str(d / "cli" / "convergence.dmat")
    tconv.main([path, "--dim", "2", "-n", "3", "--out", out, "--dtype",
                "float64", "--device", "cpu"])
    near(tio.read_dmat(out), want, 1e-8)
    assert np.isfinite(tio.read_dmat(out)).all()
