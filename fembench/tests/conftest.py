"""Settings of the benchmark's own tests (run with `python -m pytest
fembench/tests` from the root of a checkout; the repository's tests/ do
not collect them)."""

import json
import os
import shutil

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA GPU and nvcc (mixedfem_tpu_torch's CUDA "
        "kernels); skips where torch.cuda.is_available() is false")


@pytest.fixture
def card():
    """The CUDA device; skips the test where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda")


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def small_copy(dest: str, cells=(6, 3, 3)) -> str:
    """A copy of BENCHMARK.json and fembench/ in `dest` with every box of
    every configuration cut to `cells`; returns `dest`."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), dest)
    shutil.copytree(os.path.join(ROOT, "fembench"),
                    os.path.join(dest, "fembench"),
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    cfg_dir = os.path.join(dest, "fembench", "configs")
    for name in os.listdir(cfg_dir):
        path = os.path.join(cfg_dir, name)
        with open(path) as f:
            cfg = json.load(f)
        for obj in cfg["objects"]:
            obj["mesh"]["cells"] = list(cells)
        with open(path, "w") as f:
            json.dump(cfg, f)
    return dest


@pytest.fixture
def small(tmp_path):
    """A scaled-down copy of the benchmark (fembench/tests/conftest.py
    small_copy) in a temporary directory."""
    return small_copy(str(tmp_path))
