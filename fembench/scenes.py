"""Scene generation for the benchmark: a configuration's mesh recipe and
scene JSON, written as MEDIT .mesh files and a scene JSON in the
evouga/mixed-fem vocabulary, with the vertex ids and the element order of
every .mesh file permuted from the run's seed.

An object's mesh comes from the recipe its configuration names
(fembench/meshes/<recipe>.py). `write_mesh` is a frozen, vectorised copy
of mixedfem_tpu_torch/io/mesh_io.py:write_mesh (coordinates written with
17 significant digits, so they read back exactly), so that the
benchmark's inputs do not change when the program does.
"""

from __future__ import annotations

import json
import os
import time

import numpy as np

from fembench import module_at

def write_mesh(path: str, V: np.ndarray, T: np.ndarray) -> None:
    """A MEDIT .mesh file of tets (1-based ids, reference 0)."""
    with open(path, "w") as f:
        f.write(f"MeshVersionFormatted 1\nDimension 3\nVertices\n{len(V)}\n")
        np.savetxt(f, np.column_stack([V, np.zeros(len(V))]),
                   fmt="%.17g %.17g %.17g %d")
        f.write(f"Tetrahedra\n{len(T)}\n")
        np.savetxt(f, np.column_stack([T.astype(np.int64) + 1,
                                       np.zeros(len(T), np.int64)]),
                   fmt="%d")
        f.write("End\n")


def permute(V: np.ndarray, T: np.ndarray, rng: np.random.Generator):
    """The mesh with its vertex ids and its element order permuted, as a
    mesher's file looks to a loader: (V', T') with V'[inv[v]] = V[v]."""
    perm = rng.permutation(len(V))
    inv = np.empty_like(perm)
    inv[perm] = np.arange(len(perm))
    return V[perm], inv[T][rng.permutation(len(T))].astype(np.int32)


def object_mesh(root: str, obj: dict):
    """(V, T) of one object of a configuration, by its recipe,
    fembench/meshes/<recipe>.py: make(**params) -> (V, T) and, where the
    object is no tet mesh, its own write(path, V, T)."""
    recipe = module_at(root, "meshes", obj["mesh"]["recipe"])
    params = {k: v for k, v in obj["mesh"].items() if k != "recipe"}
    return recipe, recipe.make(**params)


def scene_dir(root: str, config_name: str, seed: int) -> str:
    """The cache directory of a configuration's files for one seed."""
    return os.path.join(root, "fembench", ".cache", f"{config_name}-{seed}")


def write_scene(root: str, config: dict, traffic: dict, cell: str,
                seed: int) -> tuple[str, list, float]:
    """Write (or find) the configuration's meshes for `seed` and the cell's
    scene JSON. Returns (scene path, per object (V, T) in file order,
    seconds spent writing)."""
    t0 = time.perf_counter()
    d = scene_dir(root, config["name"], seed)
    os.makedirs(d, exist_ok=True)
    meshes, objects = [], []
    for n, obj in enumerate(config["objects"]):
        name = obj["name"]
        npz = os.path.join(d, f"{name}.npz")
        mesh = os.path.join(d, f"{name}.mesh")
        if os.path.exists(npz) and os.path.exists(mesh):
            with np.load(npz) as z:
                V, T = z["V"], z["T"]
        else:
            recipe, VT = object_mesh(root, obj)
            V, T = permute(*VT, np.random.default_rng([seed, n]))
            getattr(recipe, "write", write_mesh)(mesh + ".part", V, T)
            np.savez(npz + ".part.npz", V=V, T=T)
            os.replace(npz + ".part.npz", npz)
            os.replace(mesh + ".part", mesh)
        meshes.append((V, T))
        objects.append(dict(obj["scene"], path=f"{name}.mesh"))
    scene = dict(config["scene"], **traffic.get("scene", {}), objects=objects)
    path = os.path.join(d, f"{cell}.json")
    with open(path + ".part", "w") as f:
        json.dump(scene, f, indent=1)
    os.replace(path + ".part", path)
    return path, meshes, time.perf_counter() - t0
