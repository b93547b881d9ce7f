"""BENCHMARK.json keeps the benchmark's contract: its keys, names, units
and limits, a file for every configuration, traffic, cell and metric; and
nothing the benchmark runs loads JAX or the JAX package, nor does the
reference take anything of the program."""

import ast
import json
import os
import re
import subprocess
import sys

import pytest

from conftest import ROOT

from fembench import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"},
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_keys_and_text(bench):
    assert set(bench) == KEYS["top"]
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024
    assert bench["paths"] == ["fembench"]
    assert 1 <= len(bench["command"]) <= 32
    assert all(_line(w) and not w.startswith("/") and ".." not in w
               for w in bench["command"])
    assert isinstance(bench["run_seconds"], int)
    assert 1 <= bench["run_seconds"] <= 51
    for part in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in bench[part]:
            extra = set(entry) - KEYS[part]
            assert extra <= ({"workloads"} if part in ("end_to_end",
                                                       "per_layer") else set())
            assert KEYS[part] <= set(entry)
            assert NAME.match(entry["name"]), entry["name"]
            for k in ("why", "layer", "source"):
                if k in entry and part != "end_to_end":
                    assert _line(entry[k])


@pytest.mark.parametrize("part", ["configs", "workloads", "metrics"])
def test_unique_names(bench, part):
    if part == "metrics":
        names = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    else:
        names = [e["name"] for e in bench[part]]
    assert len(names) == len(set(names))


def test_configs_and_cells(bench):
    used = {w["config"] for w in bench["workloads"]}
    assert used == {c["name"] for c in bench["configs"]}
    for c in bench["configs"]:
        assert c["file"].startswith("fembench/configs/")
        assert os.path.exists(os.path.join(ROOT, c["file"]))
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
    pairs = [(w["config"], w["traffic"]) for w in bench["workloads"]]
    assert len(pairs) == len(set(pairs))
    four = sum(w["chips"] == 4 for w in bench["workloads"])
    assert four <= max(1, len(bench["workloads"]) // 4)
    for w in bench["workloads"]:
        assert w["chips"] in (1, 4)
        assert NAME.match(w["traffic"]) and NAME.match(w["config"])
        cell = harness.Cell.find(ROOT, w["name"], bench)
        assert set(cell.limits) == set(
            harness.check.judge_of(ROOT, cell.config).NUMBERS)
        assert cell.traffic["episode_steps"] >= 1


def test_metrics(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    cells = {w["name"] for w in bench["workloads"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
        assert set(m.get("workloads", cells)) <= cells
        assert os.path.exists(os.path.join(ROOT, "fembench", "metrics",
                                           f"{m['name']}.py"))
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
        assert set(m.get("workloads", cells)) <= set(
            e2e[m["moves"]].get("workloads", cells))
    layers = {}
    for m in bench["per_layer"]:
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())
    for w in cells:
        cell = harness.Cell.find(ROOT, w, bench)
        names = {m["name"] for m in cell.metrics(False)}
        assert "setup_s" in names and len(names) >= 2
        assert cell.metrics(True)


def test_forbidden_modules_compare_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "mixedfem_tpu_torch_probe", sys)
    assert "mixedfem_tpu_torch_probe" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "mixedfem_tpu.config", sys)
    assert "mixedfem_tpu.config" in harness.forbidden_modules()


def test_run_loads_no_jax():
    """The modules a run imports (the harness, the program's loader and
    kernels, the profiler) hold no JAX and no JAX package."""
    code = ("import fembench.run, fembench.harness, fembench.control, "
            "fembench.trace\n"
            "import mixedfem_tpu_torch.io.scene, mixedfem_tpu_torch.cuda\n"
            "import torch.profiler\n"
            "from fembench.harness import forbidden_modules\n"
            "print(forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                         capture_output=True, text=True, timeout=300)
    assert out.stdout.strip() == "[]"


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            yield node.module or ""


def test_reference_takes_nothing_of_the_program():
    ref = os.path.join(ROOT, "fembench", "reference")
    for name in os.listdir(ref):
        if name.endswith(".py"):
            for mod in _imports(os.path.join(ref, name)):
                assert mod.split(".")[0] in ("__future__", "math", "numpy",
                                             "torch", "fembench"), mod
                if mod.startswith("fembench"):
                    assert mod.startswith("fembench.reference"), mod
    mods = sorted(n[:-3] for n in os.listdir(ref)
                  if n.endswith(".py") and n != "__init__.py")
    code = ("import sys, fembench.check\n"
            + "".join(f"import fembench.reference.{m}\n" for m in mods)
            + "print(sorted(m for m in sys.modules if m.split('.')[0] in "
              "('mixedfem_tpu_torch', 'mixedfem_tpu', 'jax')))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                         capture_output=True, text=True, timeout=300)
    assert out.stdout.strip() == "[]"
