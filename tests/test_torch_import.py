"""mixedfem_tpu_torch and chip_smoke.py stand alone: importing every module
of the port (its sharded paths in parallel/ included) loads neither JAX
nor the JAX package, and no source file of the port names either."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

from torch_parity import one_torch_thread  # noqa: F401 (a fixture)

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "mixedfem_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "mixedfem_tpu")


@pytest.fixture(scope="module", autouse=True)
def _one_thread(one_torch_thread):
    """Every test of this module runs on one torch intra-op thread."""


def _sources():
    return sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def test_import_loads_no_jax():
    mods = [
        "mixedfem_tpu_torch." + ".".join(p.relative_to(PKG).with_suffix("").parts)
        for p in sorted(PKG.rglob("*.py")) if p.name != "__init__.py"
    ]
    code = (
        "import sys, importlib, runpy\n"
        "import mixedfem_tpu_torch\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "runpy.run_path('chip_smoke.py', run_name='imported')\n"
        f"bad = [m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}]\n"
        "assert not bad, bad\n"
        "print('ok', len(sys.modules))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def test_parallel_modules_are_walked():
    """The sharded paths (mixedfem_tpu_torch/parallel/) are among the
    modules and sources the two checks here walk."""
    names = {p.stem for p in (PKG / "parallel").glob("*.py")}
    assert {"reorder", "comm", "launch", "halo", "sharding", "vp_step",
            "stencil_shard", "dryrun", "ranks"} <= names
    walked = set(_sources())
    assert all(p in walked for p in (PKG / "parallel").glob("*.py"))


def test_sources_name_no_jax():
    for path in _sources():
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in FORBIDDEN, (path, name)


def test_banded_sum_launcher_takes_cuda_tensors_only():
    """K4's launcher refuses CPU tensors before touching the compiler; the
    CPU path (ops/banded_scatter.py) counts no launch."""
    import torch

    from mixedfem_tpu_torch import cuda
    from mixedfem_tpu_torch.ops import banded_scatter as bs

    cuda.LAUNCHES.clear()
    plan = bs.build_banded_scatter_plan(
        [0, 1, 2, 3, 1, 2, 3, 4, 4, 0, 2, 5], 7, chunk=8, device="cpu")
    i32 = torch.int32
    with pytest.raises(ValueError, match="CUDA tensors"):
        cuda.banded_sum(plan.csr.row_ptr, plan.csr.slots, torch.zeros(16, 3), 7)
    with pytest.raises(ValueError, match="CUDA tensors"):
        cuda.banded_sum(*(torch.zeros(n, dtype=i32) for n in (8, 12)),
                        torch.zeros(16, 9, dtype=torch.float64), 7,
                        *(torch.zeros(n, dtype=i32) for n in (10, 8)))
    out = bs.scatter_add_sorted(plan, bs.pad_rows(plan, torch.ones(12, 3)))
    assert out[:, 0].tolist() == [2, 2, 3, 2, 2, 1, 0]
    assert sum(cuda.LAUNCHES.values()) == 0


def test_banded_plan_defaults_to_the_card(monkeypatch):
    """Without a device argument the banded plan is built for the card, and
    raises where there is none rather than landing on the CPU."""
    import torch

    from mixedfem_tpu_torch.ops import banded_scatter as bs

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bs.build_banded_scatter_plan([0, 1, 2, 3], 4, chunk=4)
