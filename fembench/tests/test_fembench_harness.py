"""The harness runs every cell end to end on a scaled-down copy of its
configuration (the program's plain paths on the CPU), a cell added by new
files and entries alone runs too, the scene files follow the seed, and a
run without a card or without the program prints no result."""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from conftest import ROOT, small_copy

from fembench import harness, run, scenes
from fembench.meshes import box_tets

SEED = 2**31 + 11
CELLS = [w["name"] for w in harness.read_json(
    os.path.join(ROOT, "BENCHMARK.json"))["workloads"]]


@pytest.mark.parametrize("name", CELLS)
def test_cell_runs_small(small, name):
    cell = harness.Cell.find(small, name)
    out = harness.run_cell(cell, SEED, 0.0, False, device="cpu")
    assert out["correct"], out["checks"]
    assert out["attempted"] == cell.traffic["episode_steps"]
    assert out["failed"] == 0
    assert {"ms_per_step", "setup_s"} <= set(out["metrics"])
    assert list(out)[-1] == "checks"
    assert all(v["value"] <= v["limit"] for v in out["checks"].values())


@pytest.mark.parametrize("name", CELLS)
def test_cell_traced_small(small, name):
    cell = harness.Cell.find(small, name)
    out = harness.run_cell(cell, SEED + 1, 0.0, True, device="cpu")
    assert out["correct"], out["checks"]
    # on the CPU no device operation runs: the readers of device time
    # find nothing, those of host clocks and counters do
    assert {"load_s", "newton_per_step", "cg_per_newton"} <= set(out["metrics"])
    assert "K1_roofline" not in out["metrics"]
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    assert out["device"]["window_s"] > 0


JUDGE = """
import torch

NUMBERS = ("drop",)
KEEP = {"x": "vertex"}


def prepare(config, traffic, meshes, device, dtype=torch.float64):
    return torch.as_tensor(meshes[0][0], dtype=dtype, device=device)


def failed(state, T):
    return (~torch.isfinite(state.x).all()).to(torch.int32)


def readings(V0, steps):
    # how far the lowest vertex fell, over the box's height
    y = torch.as_tensor(steps[-1]["x"], dtype=V0.dtype)[:, 1]
    return {"drop": float((V0[:, 1].min() - y.min())
                          / (V0[:, 1].max() - V0[:, 1].min()))}


def control_episode(V0, steps):
    return [{"x": V0} for _ in range(steps)]
"""

RECIPE = """
from fembench import scenes
from fembench.meshes import box_tets


def make(cells, lift):
    return box_tets.box_tet_mesh(*cells, size=(2.0, 1.0, 1.0),
                                 origin=(0.0, lift, 0.0))


def write(path, V, T):
    # a recipe of another kind of mesh writes its own file
    scenes.write_mesh(path, V, T)
    with open(path + ".written", "w") as f:
        f.write(str(len(T)))
"""


def test_a_cell_added_by_files_alone(small):
    """A configuration with its own judge and mesh recipe, a traffic mix,
    a cell and a per-layer metric, each a new file, and new entries in
    BENCHMARK.json: no file is edited."""
    here = os.path.join(small, "fembench")
    files = {
        "reference/hang_drop.py": JUDGE,
        "meshes/lifted_box.py": RECIPE,
        "metrics/steps_seen.py":
            "def read(ctx):\n    return float(ctx['counters']['steps'])\n",
    }
    for rel, text in files.items():
        with open(os.path.join(here, rel), "w") as f:
            f.write(text)
    cfg = {
        "name": "hanging_box", "reference": "hang_drop",
        "precision": "float64", "dim": 3,
        "objects": [{"name": "box",
                     "mesh": {"recipe": "lifted_box", "cells": [4, 2, 2],
                              "lift": 1.0},
                     "scene": {"normalize": False,
                               "boundary_condition": {"type": "hang",
                                                      "ratio": 0.1,
                                                      "axis": 0}}}],
        "scene": {"time_integrator": "BDF1", "max_newton_iterations": 3,
                  "mixed_variables": ["mixed-stretch"],
                  "material_models": [{"energy": "Stable-Neohookean",
                                       "youngs_modulus": 1e5,
                                       "poissons_ratio": 0.3,
                                       "density": 1000.0}]},
    }
    with open(os.path.join(here, "configs", "hanging_box.json"), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(here, "traffic", "hang_dt0.01.json"), "w") as f:
        json.dump({"scene": {"dt": 0.01}, "episode_steps": 2}, f)
    with open(os.path.join(here, "workloads", "throwaway.json"), "w") as f:
        json.dump({"limits": {"drop": 0.5}}, f)
    path = os.path.join(small, "BENCHMARK.json")
    bench = harness.read_json(path)
    bench["configs"].append(dict(bench["configs"][0], name="hanging_box",
                                 file="fembench/configs/hanging_box.json"))
    bench["workloads"].append({"name": "throwaway", "config": "hanging_box",
                               "traffic": "hang_dt0.01", "chips": 1,
                               "why": "a cell added by files alone"})
    bench["end_to_end"][0].setdefault("workloads", []).append("throwaway")
    bench["per_layer"].append({"name": "steps_seen", "unit": "1",
                               "better": "higher", "source": "host_clock",
                               "layer": "Newton step", "moves": "ms_per_step",
                               "workloads": ["throwaway"]})
    with open(path, "w") as f:
        json.dump(bench, f)
    cell = harness.Cell.find(small, "throwaway")
    out = harness.run_cell(cell, SEED, 0.0, True, device="cpu")
    assert out["correct"], out["checks"]
    assert set(out["checks"]) == {"drop"}
    assert 0.0 < out["checks"]["drop"]["value"] < 0.5
    assert out["metrics"]["steps_seen"]["value"] == 2.0
    assert out["attempted"] == 2
    written = os.path.join(scenes.scene_dir(small, "hanging_box", SEED),
                           "box.mesh.part.written")
    assert open(written).read() == "80"


def test_scene_files_follow_the_seed(tmp_path):
    from mixedfem_tpu_torch.io import mesh_io
    from mixedfem_tpu_torch.mesh import generators

    for dims in ((3, 2, 2), (4, 5, 3)):
        a = box_tets.box_tet_mesh(*dims, size=(4.0, 1.0, 1.0))
        b = generators.box_tet_mesh(*dims, size=(4.0, 1.0, 1.0))
        assert all(np.array_equal(x, y) for x, y in zip(a, b))
    cfg = harness.read_json(os.path.join(ROOT, "fembench", "configs",
                                         "beam_snh_800k.json"))
    cfg["objects"][0]["mesh"]["cells"] = [4, 3, 2]
    traffic = {"scene": {"dt": 0.01}}
    files = {}
    for seed in (SEED, SEED, 3):
        root = tmp_path / f"r{seed}-{len(files)}"
        root.mkdir()
        root = small_copy(str(root))
        path, meshes, _ = scenes.write_scene(root, cfg, traffic, "c", seed)
        files[seed] = meshes[0]
        V, T, _ = mesh_io.read_mesh(os.path.join(os.path.dirname(path),
                                                 "beam.mesh"))
        assert np.array_equal(V, meshes[0][0]) and np.array_equal(T, meshes[0][1])
        with open(path) as f:
            assert json.load(f)["dt"] == 0.01
    (Va, Ta), (Vb, Tb) = files[SEED], files[3]
    assert not np.array_equal(Va, Vb)
    # the same mesh in another numbering: sorted coordinates agree
    assert np.array_equal(np.sort(Va, axis=0), np.sort(Vb, axis=0))


def test_no_card_no_result(monkeypatch, capsys):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(ROOT)
    rc = run.main(["--workload", CELLS[0], "--seed", "1", "--seconds", "1"])
    assert rc != 0
    assert capsys.readouterr().out == ""


def test_benchmark_files_alone_give_no_result(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "fembench"), tmp_path / "fembench",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-m", "fembench.run", "--workload", CELLS[0],
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert "{" not in out.stdout


@pytest.mark.cuda
def test_cell_on_the_card_small(card, tmp_path):
    """On the card at 2,160 tets: the loader keeps its elements in the
    banded order and builds the coarse space, and the comparison reads
    the element rows through the program's own table."""
    root = small_copy(str(tmp_path), cells=(12, 6, 6))
    cell = harness.Cell.find(root, CELLS[0])
    out = harness.run_cell(cell, SEED, 0.0, True, device="cuda")
    assert out["correct"], out["checks"]
    assert out["device"]["platform"] == "gpu"
    assert "K1_roofline" in out["metrics"]


@pytest.mark.parametrize("loads_jax", [False, True])
def test_the_last_look_for_jax(small, monkeypatch, capsys, loads_jax):
    """A whole run on the CPU (the look for a card skipped) prints its
    result last; where a metric reader loads a module named jax after the
    window, it prints none and names the module."""
    import functools

    import torch

    with open(os.path.join(small, "fembench", "metrics", "probe.py"),
              "w") as f:
        f.write("import sys\nimport types\n\n"
                + ("sys.modules['jax'] = types.ModuleType('jax')\n"
                   if loads_jax else "") +
                "\n\ndef read(ctx):\n    return 1.0\n")
    path = os.path.join(small, "BENCHMARK.json")
    bench = harness.read_json(path)
    bench["per_layer"].append({"name": "probe", "unit": "1",
                               "better": "lower", "source": "host_clock",
                               "layer": "Newton step", "moves": "ms_per_step",
                               "workloads": [CELLS[0]]})
    with open(path, "w") as f:
        json.dump(bench, f)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(harness, "run_cell",
                        functools.partial(harness.run_cell, device="cpu"))
    for k in ("TRITON_CACHE_DIR", "TORCH_EXTENSIONS_DIR"):
        monkeypatch.setenv(k, os.environ.get(k, ""))
    monkeypatch.chdir(small)
    had = sys.modules.get("jax")
    try:
        rc = run.main(["--workload", CELLS[0], "--seed", str(SEED + 2),
                       "--seconds", "0", "--trace", "1"])
    finally:
        if had is None:
            sys.modules.pop("jax", None)
        else:
            sys.modules["jax"] = had
    out = capsys.readouterr()
    if loads_jax:
        assert rc != 0 and out.out == ""
        assert "'jax'" in out.err
    else:
        assert rc == 0
        line = json.loads(out.out.strip().splitlines()[-1])
        assert line["correct"] and list(line)[-1] == "checks"
        assert line["metrics"]["probe"]["value"] == 1.0
