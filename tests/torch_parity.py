"""Shared fixtures of the parity tests between mixedfem_tpu (JAX) and
mixedfem_tpu_torch (PyTorch): one small beam (3D tets) and one small 2D
cantilever (triangles) built by both packages from the same host arrays,
contact scenes written as scene files, and the numpy hand-over of JAX
dataclasses that mixedfem_tpu_torch.convert takes. Nothing here imports
JAX, so the card tests use it too."""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import pytest
import torch

from mixedfem_tpu_torch import convert

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def one_torch_thread():
    """One intra-op thread for the tests of a module (each port test module
    takes it through an autouse fixture). The suite runs in several worker
    processes on shared cores; torch's intra-op threads in each of them
    then oversubscribe the cores and stall on their barriers, and tests
    that run tens of thousands of small ops slow down by two orders of
    magnitude."""
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


def tri_arrays(nx=20, ny=5, seed=None):
    """Host arrays of the beam's 2D counterpart at a small size:
    grid_tri_mesh(nx, ny) over (4, 1), x=0 edge pinned, gravity, SNH
    (E=1e6, nu=0.45, rho=1000). `seed` perturbs the free positions for a
    deformed state."""
    from mixedfem_tpu_torch.config import enu_to_lame
    from mixedfem_tpu_torch.mesh import generators

    V, T = generators.grid_tri_mesh(nx, ny, size=(4.0, 1.0))
    la, mu = enu_to_lame(1e6, 0.45)
    is_fixed = V[:, 0] < 1e-9
    kw = dict(
        density=np.full(len(T), 1000.0),
        mu=np.full(len(T), mu),
        lam=np.full(len(T), la),
        model_id=np.zeros(len(T), int),
        models=("Stable-Neohookean",),
        is_fixed=is_fixed,
        ext_force=np.tile(np.array([0.0, -9.8]), (len(V), 1)),
    )
    x = V.copy()
    if seed is not None:
        rng = np.random.default_rng(seed)
        x = V + 0.02 * rng.standard_normal(V.shape) * (~is_fixed)[:, None]
    return V, T, kw, x


def cloth_arrays(nx=6, ny=6):
    """Host arrays of tests/test_shell.py:cloth: grid_tri_mesh(nx, ny) over
    the unit square at z = 0, two corners pinned, gravity along -z, SNH
    (E=1e5, nu=0.40), density 100, thickness 1e-3 (build_mesh_data's
    keywords, shell=True among them)."""
    from mixedfem_tpu_torch.config import enu_to_lame
    from mixedfem_tpu_torch.mesh import generators

    V2, T = generators.grid_tri_mesh(nx, ny, size=(1.0, 1.0))
    V = np.concatenate([V2, np.zeros((len(V2), 1))], axis=1)
    la, mu = enu_to_lame(1e5, 0.40)
    is_fixed = np.zeros(len(V), bool)
    is_fixed[np.argmin(V[:, 0] + V[:, 1])] = True
    is_fixed[np.argmin(-V[:, 0] + V[:, 1])] = True
    ext = np.zeros_like(V)
    ext[:, 2] = -9.8
    kw = dict(density=np.full(len(T), 100.0), mu=np.full(len(T), mu),
              lam=np.full(len(T), la), model_id=np.zeros(len(T), int),
              models=("Stable-Neohookean",), is_fixed=is_fixed,
              ext_force=ext, shell=True, thickness=1e-3)
    return V, T, kw


def rod_arrays(strands=1, n=9, length=1.0, spacing=0.1):
    """Host arrays of rods: strands of n nodes along +x
    (tests/test_rod.py:chain_rod for one), their roots on a square grid in
    the y-z plane `spacing` apart and pinned, gravity along -y; ARAP, E =
    1e7, nu = 0.40, density 1000, radius 5e-3 (build_rod_mesh_data's
    keywords)."""
    from mixedfem_tpu_torch.config import enu_to_lame

    side = int(np.ceil(np.sqrt(strands)))
    V, E, fixed = [], [], []
    for s in range(strands):
        P = np.zeros((n, 3))
        P[:, 0] = np.linspace(0.0, length, n)
        P[:, 1] = spacing * (s // side)
        P[:, 2] = spacing * (s % side)
        E.append(np.stack([np.arange(n - 1), np.arange(1, n)], axis=1) + s * n)
        V.append(P)
        fixed.append(np.arange(n) == 0)
    V, E = np.concatenate(V), np.concatenate(E)
    la, mu = enu_to_lame(1e7, 0.40)
    kw = dict(density=np.full(len(E), 1000.0), mu=np.full(len(E), mu),
              lam=np.full(len(E), la), model_id=np.zeros(len(E), int),
              models=("ARAP",), is_fixed=np.concatenate(fixed),
              ext_force=np.tile(np.array([0.0, -9.8, 0.0]), (len(V), 1)),
              radius=5e-3)
    return V, E, kw


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


def write_tri_scene(d, objects, **extra):
    """A 2D scene in directory `d` (a pathlib.Path): each entry of `objects`
    is (name, (V, T), scene object dict); the meshes are written as
    <name>.obj, and the scene JSON (keys `extra`) as scene2d.json, whose
    path is returned."""
    from mixedfem_tpu_torch.io import mesh_io

    objs = []
    for name, (V, T), obj in objects:
        mesh_io.write_obj(str(d / f"{name}.obj"), V, T)
        objs.append(dict(obj, path=f"{name}.obj"))
    scene = {"dt": 0.01, "material_models": [SNH_04], "objects": objs}
    scene.update(extra)
    path = d / "scene2d.json"
    path.write_text(json.dumps(scene))
    return str(path)


def write_tri_drop_scene(d, dhat=3e-2, newton=3, **extra):
    """The 2D drop scene of tests/test_collision.py (drop_scene(dim=2)): a
    slab grid_tri_mesh(4, 1) over (1, 0.2), pinned whole (hangends along y
    with ratio 2), and a box grid_tri_mesh(2, 1) over (0.3, 0.15) at
    (0.35, 0.23), as .obj files; a JSON without mixed_variables (the loader
    adds mixed-collision), CCD on, kappa 1e5, itr_tol 1e-8."""
    from mixedfem_tpu_torch.mesh import generators

    return write_tri_scene(
        d,
        [("slab", generators.grid_tri_mesh(4, 1, size=(1.0, 0.2)),
          {"normalize": False, "boundary_condition":
           {"type": "hangends", "axis": 1, "ratio": 2.0}}),
         ("box", generators.grid_tri_mesh(2, 1, size=(0.3, 0.15)),
          {"normalize": False, "offset": [0.35, 0.23, 0.0]})],
        enable_ccd=True, dhat=dhat, kappa=1e5, max_newton_iterations=newton,
        iterative_solver_tolerance=1e-8, **extra)


class SolveRecorder:
    """Records every call of one of the port's functions (a module
    attribute such as solvers/minres.py's `minres`) while active: its
    arguments and, for a solver, the iteration count it returned (at index
    `iters_at` of its result; None records none)."""

    def __init__(self, module, name, iters_at=1):
        self.module, self.name, self.iters_at = module, name, iters_at
        self.calls = []

    def __enter__(self):
        fn = self.fn = getattr(self.module, self.name)

        def recorded(*args, **kwargs):
            out = fn(*args, **kwargs)
            self.calls.append((args, kwargs, None if self.iters_at is None
                               else int(out[self.iters_at])))
            return out

        setattr(self.module, self.name, recorded)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.fn)

    def count_with(self, call, patches) -> int:
        """The count of `call` re-run with module attributes replaced:
        `patches` is a list of (module, name, replacement)."""
        args, kwargs, _ = call
        saved = [(m, n, getattr(m, n)) for m, n, _ in patches]
        try:
            for m, n, f in patches:
                setattr(m, n, f)
            return int(self.fn(*args, **kwargs)[self.iters_at])
        finally:
            for m, n, f in saved:
                setattr(m, n, f)
