"""Shared fixtures of the parity tests between mixedfem_tpu (JAX) and
mixedfem_tpu_torch (PyTorch): one small beam built by both packages from
the same host arrays, two contact scenes written as scene files, and the
numpy hand-over of JAX dataclasses that mixedfem_tpu_torch.convert takes.
Nothing here imports JAX, so the card tests use it too."""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import pytest
import torch

from mixedfem_tpu_torch import convert

CPU = torch.device("cpu")


@pytest.fixture
def one_torch_thread():
    """One intra-op thread for the test. The suite runs in several worker
    processes on shared cores; torch's intra-op threads in each of them
    then oversubscribe the cores and stall on their barriers, and the
    contact tests, which run tens of thousands of small ops, slow down
    by two orders of magnitude."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def beam_arrays(nx=6, ny=4, nz=3, seed=None):
    """Host arrays of the bench's cantilever beam (bench.py:build) at a
    small size: box (4, 1, 1), banded element order, x=0 face pinned,
    gravity. `seed` perturbs the interior positions for a deformed state."""
    from mixedfem_tpu_torch.config import enu_to_lame
    from mixedfem_tpu_torch.mesh import generators
    from mixedfem_tpu_torch.solvers.operator import sort_elements_banded

    V, T = generators.box_tet_mesh(nx, ny, nz, size=(4.0, 1.0, 1.0))
    T = T[sort_elements_banded(T)]
    la, mu = enu_to_lame(1e6, 0.45)
    is_fixed = V[:, 0] < 1e-9
    kw = dict(
        density=np.full(len(T), 1000.0),
        mu=np.full(len(T), mu),
        lam=np.full(len(T), la),
        model_id=np.zeros(len(T), int),
        models=("Stable-Neohookean",),
        is_fixed=is_fixed,
        ext_force=np.tile(np.array([0.0, -9.8, 0.0]), (len(V), 1)),
    )
    x = V.copy()
    if seed is not None:
        rng = np.random.default_rng(seed)
        x = V + 0.02 * rng.standard_normal(V.shape) * (~is_fixed)[:, None]
    return V, T, kw, x


def to_numpy(obj):
    """A JAX dataclass (or tuple / array / scalar) as nested dicts of numpy
    arrays, the form convert.from_jax_numpy takes."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {
            f.name: to_numpy(getattr(obj, f.name))
            for f in dataclasses.fields(obj)
        }
    if isinstance(obj, tuple):
        return tuple(to_numpy(o) for o in obj)
    if isinstance(obj, (str, int, float, bool)) or obj is None:
        return obj
    return np.asarray(obj)


def port(mesh=None, state=None, coarse=None, dtype=torch.float64):
    """The port's (MeshData, SimState, CoarseSpace) on the CPU from JAX
    objects."""
    return convert.from_jax_numpy(
        mesh=None if mesh is None else to_numpy(mesh),
        state=None if state is None else to_numpy(state),
        coarse=None if coarse is None else to_numpy(coarse),
        dtype=dtype, device=CPU,
    )


def t64(a) -> torch.Tensor:
    return torch.tensor(np.asarray(a), dtype=torch.float64)


def close(actual, expected, rtol, atol=0.0):
    """assert_allclose on a torch tensor against a JAX/numpy array."""
    a = actual.detach().cpu().numpy() if torch.is_tensor(actual) else actual
    np.testing.assert_allclose(a, np.asarray(expected), rtol=rtol, atol=atol)


SNH_04 = {"energy": "Stable-Neohookean", "youngs_modulus": 1e6,
          "poissons_ratio": 0.4, "density": 1000.0}


def write_contact_scene(d, slab_cells, box_cells, slab_size, box_size,
                        offset, slab_bc, **extra):
    """A slab and a box as slab.mesh and box.mesh in directory `d` (a
    pathlib.Path), and a scene JSON without mixed_variables, so that the
    loader's default adds mixed-collision; the path of the JSON."""
    from mixedfem_tpu_torch.io import mesh_io
    from mixedfem_tpu_torch.mesh import generators

    V1, T1 = generators.box_tet_mesh(*slab_cells, size=slab_size)
    V2, T2 = generators.box_tet_mesh(*box_cells, size=box_size)
    mesh_io.write_mesh(str(d / "slab.mesh"), V1, T1)
    mesh_io.write_mesh(str(d / "box.mesh"), V2, T2)
    scene = {
        "dt": 0.01, "enable_ccd": True, "kappa": 1e5,
        "material_models": [SNH_04],
        "objects": [
            {"path": "slab.mesh", "normalize": False,
             "boundary_condition": slab_bc},
            {"path": "box.mesh", "normalize": False, "offset": list(offset)},
        ],
    }
    scene.update(extra)
    path = d / "contact.json"
    path.write_text(json.dumps(scene))
    return str(path)


def write_drop_scene(d, dhat=3e-2, newton=3):
    """The drop scene of tests/test_collision.py (drop_scene): a slab
    box_tet_mesh(2, 1, 2) over (1, 0.25, 1), pinned whole (hangends along y
    with ratio 2), and a box_tet_mesh(2, 1, 2) over (0.4, 0.2, 0.4) at
    (0.3, 0.27, 0.3); float64 contact at `dhat` (3e-2: inside it from the
    start), itr_tol 1e-8."""
    return write_contact_scene(
        d, (2, 1, 2), (2, 1, 2), (1.0, 0.25, 1.0), (0.4, 0.2, 0.4),
        (0.3, 0.27, 0.3), {"type": "hangends", "axis": 1, "ratio": 2.0},
        dhat=dhat, max_newton_iterations=newton,
        iterative_solver_tolerance=1e-8)
