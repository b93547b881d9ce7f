"""The element-sharded step's kernels at rank shapes on the card (marker
`cuda`): each rank's slice (parallel/sharding.py) of a tet beam, a 2D
triangle solid, a shell and rods, padded where the solid's element count
does not divide by the ranks, goes through K1 (its tet, k3d2, k3d3 and
k2d3 instances), K3 (solids) or K7 (shells and rods) and K2, each held to
its plain version on the same CUDA inputs (float64 1e-12, float32 1e-5 of
scale); the ranks' K2 sums add up to the whole mesh's. Two gloo ranks on
the card then step the cloth through Simulation.step as two CPU ranks
do. This file imports neither JAX nor the JAX package:

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda_es.py

Every test skips where torch.cuda.is_available() is false."""

import numpy as np
import pytest
import torch

from mixedfem_tpu_torch import convert, cuda
from mixedfem_tpu_torch.config import SimConfig
from mixedfem_tpu_torch.mesh import mesh as tmesh
from mixedfem_tpu_torch.ops import assembly
from mixedfem_tpu_torch.parallel import launch, ranks, sharding
from mixedfem_tpu_torch.solvers import operator as top
from mixedfem_tpu_torch.variables import mixed_stretch as tms

from torch_parity import (  # noqa: F401 (one_torch_thread is a fixture)
    beam_arrays, cloth_arrays, one_torch_thread, rod_arrays, tri_arrays,
)

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module", autouse=True)
def _one_thread(one_torch_thread):
    """Every test of this module runs on one torch intra-op thread."""


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    return torch.device("cuda")


def _mesh(kind, dtype, device):
    """(mesh, deformed positions) of a tet beam (80 tets), a 2D solid (64
    triangles), the cloth (72 triangles) or 4 rods of 8 segments."""
    rng = np.random.default_rng(0)
    if kind == "tet":
        V, T, kw, _ = beam_arrays(4, 2, 2)
        mesh = tmesh.build_mesh_data(V, T, dtype=dtype, device=device, **kw)
    elif kind == "tri":
        V, T, kw, _ = tri_arrays(8, 4)
        mesh = tmesh.build_mesh_data(V, T, dtype=dtype, device=device, **kw)
    elif kind == "shell":
        V, T, kw = cloth_arrays(6, 6)
        mesh = tmesh.build_mesh_data(V, T, dtype=dtype, device=device, **kw)
    else:
        V, T, kw = rod_arrays(4)
        mesh = tmesh.build_rod_mesh_data(V, T, dtype=dtype, device=device,
                                         **kw)
    x = V + 0.01 * rng.standard_normal(V.shape)
    return mesh, torch.tensor(x, dtype=dtype, device=device)


def _to_cpu(mesh):
    """The mesh's copy on the CPU (its plan rebuilt there)."""
    return convert.mesh_from_numpy(convert.mesh_to_numpy(mesh),
                                   mesh.vols.dtype, "cpu")


@pytest.mark.parametrize("kind,D", [("tet", 3), ("tri", 3), ("shell", 2),
                                    ("rod", 4)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_rank_shapes_match_plain(card, dtype, kind, D):
    """Each rank's update (K3, or K7 for shells and rods) and matvec rows
    (K1's instance) against their plain versions at the rank's shapes, and
    the ranks' K2 sums of the rows against the whole mesh's."""
    tol = 1e-12 if dtype == torch.float64 else 1e-5
    mesh, x = _mesh(kind, dtype, card)
    sh = cuda.SHAPES[(mesh.T.shape[1], mesh.dim)]
    s, _ = tms.reset(mesh, x)
    p = torch.randn(x.shape, generator=torch.Generator(device=card)
                    .manual_seed(1), device=card, dtype=dtype)
    whole = assembly.segment_sum(mesh.plan, top.element_rows(
        mesh, p, tms.update(mesh, x, s, 0.01)))
    total = torch.zeros_like(whole)
    _, pad = sharding.shard_mesh_data(mesh, 0, D)
    for r in range(D):
        lmesh, _ = sharding.shard_mesh_data(mesh, r, D)
        ls = sharding.slice_rank(s, pad, r, D)
        cuda.LAUNCHES.clear()
        c = tms.update(lmesh, x, ls, 0.01)
        rows = top.element_apply(lmesh, c.Gw, p)
        torch.cuda.synchronize()
        k37 = sh.k7 if (mesh.shell or mesh.rod) else sh.k3
        assert cuda.LAUNCHES.get(k37, 0) >= 1 and cuda.LAUNCHES.get(sh.k1) == 1
        ref = top.element_apply_plain(lmesh.T, c.Gw, lmesh.mass_coeff,
                                      lmesh.free_mask, p)
        assert (rows - ref).abs().max().item() <= tol * ref.abs().max().item()
        # the update's plain versions: the same slice on the CPU
        cpu = tms.update(_to_cpu(lmesh), x.cpu(), ls.cpu(), 0.01)
        for f in ("G", "Gw"):
            a, b = getattr(c, f).cpu(), getattr(cpu, f)
            assert (a - b).abs().max().item() <= tol * b.abs().max().item()
        total += assembly.segment_sum(lmesh.plan, rows)
    assert (total - whole).abs().max().item() <= tol * whole.abs().max().item()


def test_sharded_cloth_on_card_matches_cpu_ranks(card):
    """2 gloo ranks on the card step the 6 x 6 cloth twice through
    Simulation.step as 2 CPU ranks do: float64 positions to 1e-9 of scale,
    equal Newton and CG counts; each card rank launched K1's and K7's
    k3d3 instances."""
    V, T, kw = cloth_arrays(6, 6)
    mesh = tmesh.build_mesh_data(V, T, dtype=torch.float64, device="cpu", **kw)
    cfg = SimConfig(h=0.01, outer_steps=3, itr_tol=1e-10,
                    max_iterative_solver_iters=2000,
                    mixed_variables=("mixed-stretch",), dtype="float64")
    args = (convert.mesh_to_numpy(mesh), cfg, V, np.zeros_like(V), 2)
    got = launch.run_ranks(ranks.simulation_steps, 2, devices=["cuda:0"] * 2,
                           args=args)
    want = launch.run_ranks(ranks.simulation_steps, 2, args=args)
    sh = cuda.SHAPES[(3, 3)]
    for g_runs, c_runs in zip(got, want):
        for g, c in zip(g_runs, c_runs):
            scale = np.abs(c["x"]).max()
            assert np.abs(g["x"] - c["x"]).max() <= 1e-9 * scale
            assert g["iterations"] == c["iterations"]
            assert g["solver_iters"].tolist() == c["solver_iters"].tolist()
            assert g["launches"].get(sh.k1, 0) > 0
            assert g["launches"].get(sh.k7, 0) > 0
