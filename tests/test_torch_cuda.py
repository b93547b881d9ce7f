"""mixedfem_tpu_torch's CUDA kernels on the card (marker `cuda`).

Each kernel is built with nvcc from mixedfem_tpu_torch/csrc/kernels.cu and
held to its plain PyTorch version on the same CUDA inputs: float64 to 1e-12
and float32 to 1e-5 of the output's scale (the kernels sum in another order
than the plain versions). A short float64 step on the card goes through K1-K3
and matches the CPU's step; a loaded scene steps through K4 and repeats bit
for bit; K5 and K6 are held to theirs on box grids up to the bench's 100k
tets, and a grid step through them repeats bit for bit; the contact path's
frame and pair plans go through K2 as the plain version adds, two float32
contact runs repeat bit for bit, and a float64 contact trajectory matches
the CPU's. The triangle instances of K1 and K3 are held to theirs at the
100k-triangle shapes and at sizes off K3's tile, a float64 2D step matches
the CPU's and two float32 runs of the 100k-triangle step repeat bit for
bit. The host solve paths (direct, IC-PCG, AMG, and the vanilla stretch
alone with the direct solve) step on the card as on the CPU. K7 is held
to its plain version at the shell and rod shapes and K1's shell and rod
instances to theirs, off K7's tile and from misaligned buffers; the
Laplacian rows go through K3; shell and rod steps match the CPU's in
float64, and two float32 shell steps repeat bit for bit. The warm-started
polar matches the CPU's in float64; an f64-island iteration's pieces match
the CPU's, and a float32 island step with warm-started rotations repeats
bit for bit with K3 in float64 only. This file
imports neither JAX nor the JAX package, so it also runs
where only PyTorch is installed:

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py

Every test skips where torch.cuda.is_available() is false."""

import json
import math

import numpy as np
import pytest
import torch

from mixedfem_tpu_torch import cuda
from mixedfem_tpu_torch.config import SimConfig
from mixedfem_tpu_torch.integrators import bdf as tbdf
from mixedfem_tpu_torch.io import mesh_io
from mixedfem_tpu_torch.io.scene import load_scene
from mixedfem_tpu_torch.mesh import generators
from mixedfem_tpu_torch.mesh import mesh as tmesh
from mixedfem_tpu_torch.ops import assembly, rotation, smallops
from mixedfem_tpu_torch.ops import banded_scatter as bs
from mixedfem_tpu_torch.optimizer import newton
from mixedfem_tpu_torch.solvers import coarse as tcoarse
from mixedfem_tpu_torch.solvers import operator as top
from mixedfem_tpu_torch.variables import mixed_stretch as tms

from torch_parity import (  # noqa: F401 (one_torch_thread is a fixture)
    beam_arrays, cloth_arrays, one_torch_thread, rod_arrays, tri_arrays,
    write_contact_scene, write_drop_scene,
)


@pytest.fixture(scope="module", autouse=True)
def _one_thread(one_torch_thread):
    """Every test of this module runs on one torch intra-op thread."""


DT = 0.02
pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    return torch.device("cuda")


def _beam(dtype, device):
    V, T, kw, x = beam_arrays(seed=0)
    mesh = tmesh.build_mesh_data(V, T, dtype=dtype, device=device, **kw)
    return mesh, torch.tensor(x, dtype=dtype, device=device)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_kernels_match_plain(card, dtype):
    tol = 1e-12 if dtype == torch.float64 else 1e-5
    torch.manual_seed(0)
    mesh, x = _beam(dtype, card)
    s, _ = tms.reset(mesh, x)
    c = tms.update(mesh, x, s, DT)
    p = torch.randn(mesh.nv, 3, dtype=dtype, device=card)

    def check(got, ref):
        torch.cuda.synchronize()
        scale = ref.abs().max().item()
        assert (got - ref).abs().max().item() <= tol * scale

    args = (mesh.T, c.Gw, mesh.mass_coeff, mesh.free_mask, p)
    check(cuda.element_apply(*args), top.element_apply_plain(*args))
    rows = torch.randn(mesh.nelem * 4, 9, dtype=dtype, device=card)
    for m in (3, 6, 9):
        r = rows[:, :m].contiguous()
        check(cuda.segment_sum(mesh.plan.row_ptr, mesh.plan.slots, r, mesh.nv),
              assembly.segment_sum_plain(mesh.plan, r))
    R, S = rotation.polar33(tmesh.def_grad(mesh, x))
    D = rotation.dsdF33(R, S).contiguous()
    Hs = torch.randn(mesh.nelem, 6, 6, dtype=dtype, device=card)
    got = cuda.contract_G_Gw(D, mesh.dphidX, Hs, mesh.vols)
    ref = smallops.contract_G_Gw_plain(D, mesh.dphidX, Hs, mesh.vols)
    for a, b in zip(got, ref):
        check(a, b)


def _k3_inputs(E, dtype, device, seed=0, offset=0):
    """Random K3 inputs for E elements (positive volumes); with offset > 0
    each lies `offset` elements into its own buffer, a contiguous view that
    is not 16-byte aligned."""
    rng = np.random.default_rng(seed)
    out = []
    for shape in ((E, 6, 3, 3), (E, 4, 3), (E, 6, 6), (E,)):
        a = rng.standard_normal(shape)
        if len(shape) == 1:
            a = np.abs(a) + 0.1
        buf = torch.zeros(a.size + offset, dtype=dtype, device=device)
        buf[offset:] = torch.tensor(a.reshape(-1), dtype=dtype, device=device)
        out.append(buf[offset:].view(shape))
    return out


def _check_k3(got, ref, tol):
    torch.cuda.synchronize()
    for a, b in zip(got, ref):
        assert a.shape == b.shape
        scale = b.abs().max().item()
        assert (a - b).abs().max().item() <= tol * scale


@pytest.mark.parametrize("tile", cuda.CONTRACT_TILES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_contract_G_Gw_tile_edges(card, dtype, tile):
    """K3 at E = 1, TE - 1, TE + 1 and 3 TE + 7 for each tile size TE: a
    single element, a tile one short, a tile and one, a partial last tile."""
    tol = 1e-12 if dtype == torch.float64 else 1e-5
    for E in (1, tile - 1, tile + 1, 3 * tile + 7):
        ins = _k3_inputs(E, dtype, card, seed=E)
        _check_k3(cuda.contract_G_Gw_tile(*ins, tile),
                  smallops.contract_G_Gw_plain(*ins), tol)


@pytest.mark.parametrize("dtype,offset", [
    (torch.float32, 1), (torch.float32, 2), (torch.float32, 3),
    (torch.float64, 1), (torch.float64, 3)])
def test_contract_G_Gw_misaligned(card, dtype, offset):
    """K3 on contiguous views that start 1-3 elements into their storage
    (4-, 8-, 12- or 24-byte offsets, so the 16-byte copies give way to 8-
    or 4-byte ones), through the wrapper the step calls, with a partial
    last tile."""
    tol = 1e-12 if dtype == torch.float64 else 1e-5
    ins = _k3_inputs(1000 + offset, dtype, card, seed=offset, offset=offset)
    assert all(t.data_ptr() % 16 for t in ins)
    _check_k3(smallops.contract_G_Gw(*ins), smallops.contract_G_Gw_plain(*ins),
              tol)


def test_contract_G_Gw_float32_order(card):
    """K3 adds in the plain version's order (G over c ascending, then Hs G
    over j ascending, then the sqrt(vol) product), so at the main path's
    100k elements its float32 results are the plain version's bits, and
    on the first 20,011 elements alone K3 gives the same bits again. (The
    plain version does not: the batched product behind it picks another
    order for Hs G at that batch size.)"""
    ins = _k3_inputs(100_000, torch.float32, card, seed=7)
    got = cuda.contract_G_Gw(*ins)
    ref = smallops.contract_G_Gw_plain(*ins)
    part = cuda.contract_G_Gw(*(t[:20_011] for t in ins))
    torch.cuda.synchronize()
    for name, a, b, p in zip(("G", "Gw"), got, ref, part):
        assert torch.equal(a, b), (name, int((a != b).sum()),
                                   (a - b).abs().max().item())
        assert torch.equal(p, a[:20_011]), name


def test_wrappers_check_their_inputs(card):
    mesh, x = _beam(torch.float32, card)
    Gw = torch.zeros(mesh.nelem, 6, 4, 3, device=card)
    with pytest.raises(TypeError):
        cuda.element_apply(mesh.T, Gw.double(), mesh.mass_coeff,
                           mesh.free_mask, x)
    with pytest.raises(ValueError):
        cuda.element_apply(mesh.T, Gw[:, :5], mesh.mass_coeff,
                           mesh.free_mask, x)
    with pytest.raises(ValueError):
        cuda.segment_sum(mesh.plan.row_ptr, mesh.plan.slots,
                         torch.zeros(mesh.nelem * 4, 9, device=card)[:, :3],
                         mesh.nv)
    with pytest.raises(TypeError):
        cuda.contract_G_Gw(*(torch.zeros(s, dtype=torch.float16, device=card)
                             for s in ((2, 6, 3, 3), (2, 4, 3), (2, 6, 6), (2,))))


def test_step_on_card_matches_cpu(card):
    """Two float64 steps with the two-level preconditioner: the card (all
    three kernels launched) against the CPU (plain versions)."""
    V, T, kw, _ = beam_arrays()
    cfg = SimConfig(h=DT, outer_steps=3, newton_tol=0.0, coarse_refresh_every=2)
    out = {}
    for dev in (card, torch.device("cpu")):
        mesh = tmesh.build_mesh_data(V, T, dtype=torch.float64, device=dev, **kw)
        cs = tcoarse.build_coarse_space(V, T, kw["is_fixed"], target_size=8,
                                        dtype=torch.float64, device=dev)
        x0 = torch.tensor(V, dtype=torch.float64, device=dev)
        st = newton.init_state(mesh, cfg, (), x0, torch.zeros_like(x0))
        cuda.LAUNCHES.clear()
        for _ in range(2):
            st = newton.newton_step(mesh, cfg, (), st, cs)
        out[dev.type] = (st, dict(cuda.LAUNCHES))
    (g, launches), (c, none) = out["cuda"], out["cpu"]
    assert not none
    for k in ("element_apply", "contract_G_Gw", "segment_sum_m3",
              "segment_sum_m9", "segment_sum_m6", "segment_sum_m36"):
        assert launches.get(k, 0) > 0, k
    np.testing.assert_allclose(g.x.cpu().numpy(), c.x.numpy(), rtol=0,
                               atol=1e-9 * c.x.abs().max().item())
    assert g.stats.solver_iters.tolist() == c.stats.solver_iters.tolist()


def test_float32_step_repeats_on_card(card):
    """Every sum of the step runs in a fixed order on the card, so two
    float32 runs from the same state agree bit for bit."""
    V, T, kw, _ = beam_arrays()
    cfg = SimConfig(h=DT, outer_steps=3, newton_tol=0.0, dtype="float32")
    mesh = tmesh.build_mesh_data(V, T, dtype=torch.float32, device=card, **kw)
    cs = tcoarse.build_coarse_space(V, T, kw["is_fixed"], target_size=8,
                                    dtype=torch.float32, device=card)
    x0 = torch.tensor(V, dtype=torch.float32, device=card)
    runs = []
    for _ in range(2):
        st = newton.init_state(mesh, cfg, (), x0, torch.zeros_like(x0))
        for _ in range(2):
            st = newton.newton_step(mesh, cfg, (), st, cs)
        runs.append(st)
    assert torch.equal(runs[0].x, runs[1].x)
    assert torch.equal(runs[0].stats.energy, runs[1].stats.energy)


def _k4_meshes():
    """A 2000-tet beam in banded order, and the same beam with its vertex
    ids in a seeded random order (windows as wide as the mesh)."""
    V, T = generators.box_tet_mesh(20, 5, 4, size=(4.0, 1.0, 1.0))
    p = np.random.default_rng(0).permutation(len(V))
    inv = np.empty_like(p)
    inv[p] = np.arange(len(p))
    Ts = inv[T]
    return {
        "banded": T[top.sort_elements_banded(T)],
        "shuffled": Ts[top.sort_elements_banded(Ts)],
    }, len(V)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_segment_sum_with_pieces_matches_plain(card, dtype):
    """K2 over plans that split long segments into pieces (two launches,
    one count), at m = 36, 9, 6 and 3: piece bounds and the row count fall
    off multiples of 32 and of L, and one segment is empty."""
    tol = 1e-12 if dtype == torch.float64 else 1e-5
    rng = np.random.default_rng(0)
    lens = np.concatenate([rng.integers(1, 200, 200),
                           rng.integers(257, 1500, 20), [4193, 0, 256, 257, 33]])
    seg = np.repeat(np.arange(len(lens)), lens)
    rng.shuffle(seg)
    assert len(seg) % 32
    g = torch.Generator(device=card).manual_seed(0)
    for L in (100, 256):
        plan = assembly.build_incidence_plan(seg, len(lens), card, piece_rows=L)
        assert plan.piece_ptr is not None
        for m in (36, 9, 6, 3):
            rows = torch.randn(len(seg), m, generator=g, device=card, dtype=dtype)
            cuda.LAUNCHES.clear()
            got = assembly.segment_sum(plan, rows[:, None])
            assert dict(cuda.LAUNCHES) == {f"segment_sum_m{m}": 1}
            ref = assembly.segment_sum_plain(plan, rows)
            torch.cuda.synchronize()
            scale = ref.abs().max().item()
            assert (got - ref).abs().max().item() <= tol * scale, (L, m)


@pytest.mark.parametrize("chunk", [512, 54])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_banded_sum_matches_plain(card, dtype, chunk):
    """K4 at both window widths, m = 3 and 9, over 1997 tets: a row count
    that is a multiple of neither 32 nor the chunk, so the last warp's tile
    is partial and zero padding rows follow the rows."""
    tol = 1e-12 if dtype == torch.float64 else 1e-5
    meshes, nv = _k4_meshes()
    g = torch.Generator(device=card).manual_seed(0)
    for name, T in meshes.items():
        T = T[:-3]
        plan = bs.build_banded_scatter_plan(T.reshape(-1), nv, chunk=chunk,
                                            device=card)
        assert T.size % chunk and T.size % 32 and (
            plan.W >= nv if name == "shuffled" else plan.W < nv)
        for m in (3, 9):
            rows = bs.pad_rows(plan, torch.randn(T.size, m, generator=g,
                                                 device=card, dtype=dtype))
            cuda.LAUNCHES.clear()
            got = bs.scatter_add_sorted(plan, rows)
            assert dict(cuda.LAUNCHES) == {f"banded_sum_m{m}": 1}
            ref = bs.banded_sum_plain(plan, rows)
            torch.cuda.synchronize()
            scale = ref.abs().max().item()
            assert (got - ref).abs().max().item() <= tol * scale, (name, m)


def _write_scene(d, nx=20, ny=5, nz=4):
    V, T = generators.box_tet_mesh(nx, ny, nz, size=(4.0, 1.0, 1.0))
    mesh_io.write_mesh(str(d / "beam.mesh"), V, T)
    scene = {
        "dt": 0.02, "max_newton_iterations": 3,
        "mixed_variables": ["mixed-stretch"],
        "material_models": [{"energy": "Stable-Neohookean"}],
        "objects": [{"path": "beam.mesh", "boundary_condition": {
            "type": "twist", "ratio": 0.1, "axis": 0}}],
    }
    (d / "scene.json").write_text(json.dumps(scene))
    return str(d / "scene.json")


def test_float32_scene_step_repeats_on_card(card, tmp_path):
    """A 2000-tet scene loads with the banded plan and the coarse space; its
    float32 steps (K1, K3, K4, and K2 in the coarse space) repeat bit for
    bit."""
    path = _write_scene(tmp_path)
    runs = []
    for _ in range(2):
        sim = load_scene(path, dim=3, dtype="float32")
        assert sim.matvec_plan is not None and sim.coarse is not None
        cuda.LAUNCHES.clear()
        sim.run(2)
        runs.append(sim.state)
        for k in ("element_apply", "contract_G_Gw", "banded_sum_m3",
                  "banded_sum_m9", "segment_sum_m6", "segment_sum_m36"):
            assert cuda.LAUNCHES.get(k, 0) > 0, k
        assert not cuda.LAUNCHES.get("segment_sum_m3", 0)
    assert torch.equal(runs[0].x, runs[1].x)
    assert torch.equal(runs[0].stats.energy, runs[1].stats.energy)


def _grid_plan(cells, device):
    from mixedfem_tpu_torch.ops import stencil as tst

    nx, ny, nz = cells
    V, T = generators.box_tet_mesh(nx, ny, nz, size=(4.0, 1.0, 1.0))
    plan, perm = tst.build_stencil_plan(T, len(V), (nx + 1, ny + 1, nz + 1),
                                        device=device)
    return V, T[perm], plan


def _view(shape, dtype, device, gen, offset):
    """A contiguous view `offset` elements into its storage."""
    n = int(np.prod(shape))
    buf = torch.randn(n + offset, generator=gen, dtype=dtype, device=device)
    return buf[offset:].view(shape)


# (cells, offset): the 100k-tet bench grid; lattices whose vertex counts are
# no multiple of K5's threads a block or K6's tiles (6x4x8: 480 padded
# vertices; a single cell: 64); padded vertex counts that are odd (7x5x5:
# 175, 5x7x9: 315) or even but no multiple of 4 (9x7x6: 378), so that no
# plane of W starts 16 bytes after another; views 1-3 elements into storage
STENCIL_CASES = [((40, 25, 20), 0), ((5, 3, 7), 0), ((1, 1, 1), 0),
                 ((5, 3, 7), 1), ((6, 4, 3), 3), ((4, 2, 2), 0),
                 ((2, 4, 6), 1)]


@pytest.mark.parametrize("cells,offset", STENCIL_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_stencil_kernels_match_plain(card, dtype, cells, offset):
    """K6 (stencil_assemble) and K5 (stencil_apply, with and without the
    free mask, x = 0 pinned) against their plain versions on the same
    inputs: f64 to 1e-12 and f32 to 1e-5 of the output's scale. K5 also
    runs on a W with rows at the ghost vertices and in the 8 planes the
    plan leaves empty, which it must neither read nor pass on."""
    from mixedfem_tpu_torch.ops import stencil as tst

    tol = 1e-12 if dtype == torch.float64 else 1e-5
    V, T, plan = _grid_plan(cells, card)
    E, npad = len(T), plan.npad
    g = torch.Generator(device=card).manual_seed(sum(cells) + offset)
    Gw = _view((E, 6, 4, 3), dtype, card, g, offset)
    mass = _view((E, 4, 4), dtype, card, g, offset).abs_()
    cuda.LAUNCHES.clear()
    W = tst.assemble_W(plan, Gw, mass)
    ref = tst.assemble_W_plain(plan, Gw, mass)
    assert cuda.LAUNCHES["stencil_assemble"] == 1

    def check(got, want):
        torch.cuda.synchronize()
        assert got.shape == want.shape
        scale = want.abs().max().item()
        assert scale > 0
        assert (got - want).abs().max().item() <= tol * scale

    check(W, ref)
    fixed = torch.tensor(V[:, 0] < 1e-9, device=card)
    fm = tst.to_lat(plan, (~fixed).to(dtype)[:, None].expand(-1, 3))
    x = _view((3, npad), dtype, card, g, offset)
    fm_v = _view((3, npad), dtype, card, g, offset)
    fm_v.copy_(fm)
    Wr = _view((27, 3, 3, npad), dtype, card, g, offset)
    for W_ in (W, Wr):
        for f in (None, fm_v):
            check(tst.matvec_lat(plan, W_, x, f),
                  tst.stencil_apply_plain(plan, W_, x, f))
    assert cuda.LAUNCHES["stencil_apply"] == 4


def test_stencil_kernels_repeat_bit_for_bit(card):
    """Both kernels add in a fixed order: two launches on the same inputs
    give the same bits."""
    from mixedfem_tpu_torch.ops import stencil as tst

    _, T, plan = _grid_plan((12, 7, 5), card)
    g = torch.Generator(device=card).manual_seed(3)
    Gw = torch.randn(len(T), 6, 4, 3, generator=g, device=card)
    mass = torch.rand(len(T), 4, 4, generator=g, device=card)
    W1, W2 = (tst.assemble_W(plan, Gw, mass) for _ in range(2))
    x = torch.randn(3, plan.npad, generator=g, device=card)
    assert torch.equal(W1, W2)
    assert torch.equal(tst.matvec_lat(plan, W1, x), tst.matvec_lat(plan, W2, x))


@pytest.mark.parametrize("cells", [(40, 25, 20), (4, 2, 2), (6, 4, 3)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_stencil_apply_other_planes(card, dtype, cells):
    """K5 with a plane mask other than the plan's 19 planes (all 27, and a
    seeded random subset of 11), through its generic path, against the
    plain sum over the same planes, on a W with rows in every plane."""
    import dataclasses

    from mixedfem_tpu_torch.ops import stencil as tst

    tol = 1e-12 if dtype == torch.float64 else 1e-5
    _, _, plan = _grid_plan(cells, card)
    npad, dims = plan.npad, (plan.NI, plan.NJ, plan.NK)
    g = torch.Generator(device=card).manual_seed(5)
    W = torch.randn(27, 3, 3, npad, generator=g, dtype=dtype, device=card)
    x = torch.randn(3, npad, generator=g, dtype=dtype, device=card)
    fm = (torch.rand(3, npad, generator=g, device=card) > 0.2).to(dtype)
    subset = np.sort(np.random.default_rng(1).choice(27, 11, replace=False))
    for planes in (tuple(range(27)), tuple(int(o) for o in subset)):
        assert len(planes) != len(plan.used)
        mask = sum(1 << o for o in planes)
        ref = tst.stencil_apply_plain(dataclasses.replace(plan, used=planes),
                                      W, x, fm)
        got = cuda.stencil_apply(W, x, fm, dims, mask)
        torch.cuda.synchronize()
        scale = ref.abs().max().item()
        assert scale > 0
        assert (got - ref).abs().max().item() <= tol * scale, planes


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_stencil_assemble_zero_planes(card, dtype):
    """K6 writes the 8 planes that no term touches as exact zeros, into
    memory that held NaN just before."""
    from mixedfem_tpu_torch.ops import stencil as tst

    for cells in ((40, 25, 20), (4, 2, 2), (6, 4, 3)):
        _, T, plan = _grid_plan(cells, card)
        g = torch.Generator(device=card).manual_seed(2)
        Gw = torch.randn(len(T), 6, 4, 3, generator=g, dtype=dtype, device=card)
        mass = torch.rand(len(T), 4, 4, generator=g, dtype=dtype, device=card)
        junk = torch.full((27, 3, 3, plan.npad), float("nan"), dtype=dtype,
                          device=card)
        del junk
        W = tst.assemble_W(plan, Gw, mass)
        unused = [o for o in range(27) if o not in plan.used]
        torch.cuda.synchronize()
        assert len(unused) == 8
        assert torch.count_nonzero(W[unused]).item() == 0, cells
        assert torch.isfinite(W).all(), cells


def test_stencil_assemble_checks_its_schedule(card):
    """K6 refuses, before a launch, a schedule too short to hold an entry
    for each term row; the plan's own schedule runs."""
    from mixedfem_tpu_torch.ops import stencil as tst

    _, T, plan = _grid_plan((3, 2, 2), card)
    dims = (plan.NI, plan.NJ, plan.NK)
    Gw = torch.zeros(len(T), 6, 4, 3, device=card)
    mass = torch.zeros(len(T), 4, 4, device=card)
    with pytest.raises(ValueError, match="one entry per row"):
        cuda.stencil_assemble(Gw, mass, plan.term_table, plan.plane_ptr, dims,
                              plan.nslots, plan.schedule[:4 + len(plan.term_table)])
    with pytest.raises(TypeError):
        cuda.stencil_assemble(Gw, mass, plan.term_table, plan.plane_ptr, dims,
                              plan.nslots, plan.schedule.long())
    assert tst.assemble_W(plan, Gw, mass).shape == (27, 3, 3, plan.npad)


def test_stencil_wrappers_check_their_inputs(card):
    from mixedfem_tpu_torch.ops import stencil as tst

    _, T, plan = _grid_plan((3, 2, 2), card)
    npad, dims = plan.npad, (plan.NI, plan.NJ, plan.NK)
    W = torch.zeros(27, 3, 3, npad, device=card)
    x = torch.zeros(3, npad, device=card)
    with pytest.raises(ValueError):
        cuda.stencil_apply(W[:, :, :, :-1], x[:, :-1], None, dims, plan.used_mask)
    with pytest.raises(TypeError):
        cuda.stencil_apply(W.double(), x, None, dims, plan.used_mask)
    with pytest.raises(ValueError):
        cuda.stencil_apply(W, x, None, dims, 1 << 27)
    with pytest.raises(ValueError):
        cuda.stencil_assemble(torch.zeros(len(T) - 1, 6, 4, 3, device=card),
                              torch.zeros(len(T) - 1, 4, 4, device=card),
                              plan.term_table, plan.plane_ptr, dims, plan.nslots,
                              plan.schedule)


def _grid_step_setup(cells, dtype, device, coarse=True):
    from mixedfem_tpu_torch.config import enu_to_lame

    V, T, plan = _grid_plan(cells, device)
    la, mu = enu_to_lame(1e6, 0.45)
    fixed = V[:, 0] < 1e-9
    mesh = tmesh.build_mesh_data(
        V, T, density=np.full(len(T), 1000.0), mu=np.full(len(T), mu),
        lam=np.full(len(T), la), model_id=np.zeros(len(T), int),
        models=("Stable-Neohookean",), is_fixed=fixed,
        ext_force=np.tile(np.array([0.0, -9.8, 0.0]), (len(V), 1)),
        dtype=dtype, device=device)
    cs = None
    if coarse:
        cs = tcoarse.build_coarse_space_grid(
            V, T, fixed, (plan.NI, plan.NJ, plan.NK), dtype=dtype,
            device=device)
    return mesh, plan, cs


def test_float32_grid_step_repeats_on_card(card):
    """The grid body's sums all run in a fixed order (K2, K3, K5, K6), so
    two float32 runs of two steps from the same state agree bit for bit."""
    cfg = SimConfig(h=DT, outer_steps=3, newton_tol=0.0, dtype="float32",
                    coarse_refresh_every=10)
    mesh, plan, cs = _grid_step_setup((10, 6, 5), torch.float32, card)
    x0 = mesh.V0.clone()
    runs = []
    for _ in range(2):
        cuda.LAUNCHES.clear()
        st = newton.init_state(mesh, cfg, (), x0, torch.zeros_like(x0))
        st.precond = torch.zeros((cs.ncd, cs.ncd), device=card)
        for _ in range(2):
            st = newton.newton_step(mesh, cfg, (), st, cs, (), plan)
        runs.append(st)
        for k in ("stencil_apply", "stencil_assemble", "contract_G_Gw",
                  "segment_sum_m3", "segment_sum_m36"):
            assert cuda.LAUNCHES.get(k, 0) > 0, k
        assert cuda.LAUNCHES.get("element_apply", 0) == 0
    assert torch.equal(runs[0].x, runs[1].x)
    assert torch.equal(runs[0].stats.energy, runs[1].stats.energy)
    assert runs[0].stats.solver_iters.tolist() == runs[1].stats.solver_iters.tolist()


# ---------------------------------------------------------------------------
# contact
# ---------------------------------------------------------------------------

def _slab_box(tmp_path):
    """A 5080-tet contact scene (the loader gives it the banded plan and
    the coarse space), the box half of dhat above the slab."""
    return write_contact_scene(
        tmp_path, (20, 2, 20), (6, 6, 6), (1.0, 0.1, 1.0), (0.3, 0.3, 0.3),
        (0.35, 0.105, 0.35), {"type": "hangends", "axis": 0},
        dhat=1e-2, max_newton_iterations=3)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_contact_plans_match_plain(card, tmp_path, dtype):
    """K2 over the contact frame plan (m=3, 9) and a coarse contact pair
    plan (m=36, over all candidates) against the plain version."""
    tol = 1e-12 if dtype == torch.float64 else 1e-5
    sim = load_scene(_slab_box(tmp_path), dim=3, device=card,
                     dtype=str(dtype).removeprefix("torch."))
    assert sim.matvec_plan is not None and sim.coarse is not None
    sim._update_contact_candidates()
    cf = sim.state.contact
    assert cf.nreal > 0
    pairs = tcoarse.contact_pairs(sim.coarse, cf.frames[:cf.nreal].cpu().numpy(),
                                  card)
    g = torch.Generator(device=card).manual_seed(0)
    for plan, m in ((cf.plan, 3), (cf.plan, 9), (pairs.plan, 36)):
        rows = torch.randn((plan.nrows, m), generator=g, device=card,
                           dtype=dtype)
        got = cuda.segment_sum(plan.row_ptr, plan.slots, rows, plan.nseg,
                               plan.piece_ptr, plan.seg_pieces)
        ref = assembly.segment_sum_plain(plan, rows)
        torch.cuda.synchronize()
        assert (got - ref).abs().max().item() <= tol * ref.abs().max().item()


def test_float32_contact_steps_repeat_on_card(card, tmp_path):
    """Every contact sum runs through an incidence plan, so two float32
    runs of two contact steps agree bit for bit, with the frame scatters
    on K2."""
    path = _slab_box(tmp_path)
    runs = []
    for _ in range(2):
        sim = load_scene(path, dim=3, dtype="float32", device=card)
        cuda.LAUNCHES.clear()
        sim.run(2)
        launches = dict(cuda.LAUNCHES)
        runs.append((sim.state, launches))
    (a, la), (b, lb) = runs
    for key in ("segment_sum_m3", "segment_sum_m9", "segment_sum_m36",
                "banded_sum_m3", "element_apply"):
        assert la.get(key, 0) > 0, key
    assert la == lb
    assert int(a.stats.active_frames.max()) > 0
    assert torch.equal(a.x, b.x)
    assert a.stats.solver_iters.tolist() == b.stats.solver_iters.tolist()


def test_contact_trajectory_on_card_matches_cpu(card, tmp_path):
    """Three float64 steps of the drop scene: the card against the CPU."""
    from mixedfem_tpu_torch.device import to_device

    g_sim = load_scene(write_drop_scene(tmp_path), dim=3, dtype="float64",
                       device=card)
    c_sim = to_device(g_sim, "cpu")
    for _ in range(3):
        g, c = g_sim.step(), c_sim.step()
        np.testing.assert_allclose(g.x.cpu().numpy(), c.x.numpy(), rtol=0,
                                   atol=1e-9 * c.x.abs().max().item())
        assert g.stats.iterations == c.stats.iterations
        assert g.stats.solver_iters.tolist() == c.stats.solver_iters.tolist()
        assert g.stats.active_frames.tolist() == c.stats.active_frames.tolist()
    assert int(c.stats.active_frames.max()) > 0


# ---------------------------------------------------------------------------
# the triangle instances (k=3, d=2, N=3)
# ---------------------------------------------------------------------------

def _tri_beam(nx, ny, dtype, device):
    V, T, kw, _ = tri_arrays(nx, ny)
    T = T[top.sort_elements_banded(T)]
    mesh = tmesh.build_mesh_data(V, T, dtype=dtype, device=device, **kw)
    cs = tcoarse.build_coarse_space(V, T, kw["is_fixed"], target_size=48,
                                    dtype=dtype, device=device)
    return mesh, cs


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_tri_kernels_match_plain(card, dtype):
    """K1 (k=3, d=2), K3 (N=3) and K2 at m=2 and 4 on the 100k-triangle
    cantilever's coefficients at a perturbed state."""
    tol = 1e-12 if dtype == torch.float64 else 1e-5
    mesh, _ = _tri_beam(400, 125, dtype, card)
    g = torch.Generator(device=card).manual_seed(0)
    x = mesh.V0 + 0.01 * torch.randn(mesh.V0.shape, generator=g, device=card,
                                     dtype=dtype) * mesh.free_mask[:, None]
    s, _ = tms.reset(mesh, x)
    c = tms.update(mesh, x, s, DT)
    p = torch.randn(mesh.nv, 2, generator=g, device=card, dtype=dtype)

    def check(got, ref):
        torch.cuda.synchronize()
        assert got.shape == ref.shape
        assert (got - ref).abs().max().item() <= tol * ref.abs().max().item()

    cuda.LAUNCHES.clear()
    args = (mesh.T, c.Gw, mesh.mass_coeff, mesh.free_mask, p)
    check(cuda.element_apply(*args), top.element_apply_plain(*args))
    rows = top.element_apply_plain(*args).reshape(-1, 2).contiguous()
    check(cuda.segment_sum(mesh.plan.row_ptr, mesh.plan.slots, rows, mesh.nv),
          assembly.segment_sum_plain(mesh.plan, rows))
    blk = torch.einsum("eikr,eiks->ekrs", c.Gw, c.Gw).reshape(-1, 4).contiguous()
    check(cuda.segment_sum(mesh.plan.row_ptr, mesh.plan.slots, blk, mesh.nv),
          assembly.segment_sum_plain(mesh.plan, blk))
    R, S = rotation.polar22(tmesh.def_grad(mesh, x))
    D = rotation.dsdF22(R, S).contiguous()
    Hs = torch.randn(mesh.nelem, 3, 3, generator=g, device=card, dtype=dtype)
    for a, b in zip(cuda.contract_G_Gw(D, mesh.dphidX, Hs, mesh.vols),
                    smallops.contract_G_Gw_plain(D, mesh.dphidX, Hs, mesh.vols)):
        check(a, b)
    assert dict(cuda.LAUNCHES) == {"element_apply_k3d2": 1, "segment_sum_m2": 1,
                                   "segment_sum_m4": 1, "contract_G_Gw_n3": 1}


def _tri_k3_inputs(E, dtype, device, seed=0, offset=0):
    """Random triangle K3 inputs for E elements (positive areas); with
    offset > 0 each lies `offset` elements into its own buffer, a
    contiguous view that is not 16-byte aligned."""
    rng = np.random.default_rng(seed)
    out = []
    for shape in ((E, 3, 2, 2), (E, 3, 2), (E, 3, 3), (E,)):
        a = rng.standard_normal(shape)
        if len(shape) == 1:
            a = np.abs(a) + 0.1
        buf = torch.zeros(a.size + offset, dtype=dtype, device=device)
        buf[offset:] = torch.tensor(a.reshape(-1), dtype=dtype, device=device)
        out.append(buf[offset:].view(shape))
    return out


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_tri_kernels_off_the_tile(card, dtype, offset):
    """K3 (N=3) at E = 1, 31, 33, 103 and 100,003 (one element, a tile one
    short, a tile and one, partial last tiles; 2D rows of 48 and 72 bytes
    in float32 end their spans off 16 bytes), from aligned and misaligned
    buffers; K1 (k=3, d=2) at the same counts."""
    tol = 1e-12 if dtype == torch.float64 else 1e-5
    for E in (1, 31, 33, 103, 100003):
        ins = _tri_k3_inputs(E, dtype, card, seed=E, offset=offset)
        _check_k3(cuda.contract_G_Gw(*ins),
                  smallops.contract_G_Gw_plain(*ins), tol)
        g = torch.Generator(device=card).manual_seed(E)
        nv = E + 2
        T = torch.randint(0, nv, (E, 3), generator=g, device=card,
                          dtype=torch.int32)
        Gw = torch.randn(E, 3, 3, 2, generator=g, device=card, dtype=dtype)
        mass = torch.randn(E, 3, 3, generator=g, device=card, dtype=dtype)
        fm = (torch.rand(nv, generator=g, device=card) > 0.2).to(dtype)
        p = torch.randn(nv, 2, generator=g, device=card, dtype=dtype)
        got = cuda.element_apply(T, Gw, mass, fm, p)
        ref = top.element_apply_plain(T, Gw, mass, fm, p)
        torch.cuda.synchronize()
        assert (got - ref).abs().max().item() <= tol * ref.abs().max().item()


def test_tri_wrappers_refuse_other_shapes(card):
    """No instance, no launch: a wrapper raises for an element shape the
    kernels have no instance of, and never hands it to the plain version."""
    f = lambda *s: torch.zeros(s, device=card)  # noqa: E731
    T = torch.zeros((2, 3), dtype=torch.int32, device=card)
    T5 = torch.zeros((2, 5), dtype=torch.int32, device=card)
    cuda.LAUNCHES.clear()
    with pytest.raises(ValueError, match="instances"):
        cuda.element_apply(T5, f(2, 6, 5, 3), f(2, 5, 5), f(5), f(5, 3))
    with pytest.raises(ValueError, match="instances"):
        cuda.contract_G_Gw(f(2, 6, 2, 2), f(2, 4, 2), f(2, 6, 6), f(2))
    with pytest.raises(ValueError, match="instances"):
        cuda.contract_Gw(f(2, 6, 6), f(2, 6, 5, 3), f(2))
    # a tet's G and Gw come from K3 in one pass: K7 has no tet instance
    with pytest.raises(ValueError, match="K3"):
        cuda.contract_Gw(f(2, 6, 6), f(2, 6, 4, 3), f(2))
    # a shell's G is a Jacobian's: K3 has no shell instance, K7 serves it
    with pytest.raises(ValueError, match="Jacobian"):
        cuda.contract_G_Gw(f(2, 6, 3, 3), f(2, 3, 3), f(2, 6, 6), f(2))
    with pytest.raises(ValueError):
        cuda.element_apply(T, f(2, 3, 3, 3), f(2, 3, 3), f(5), f(5, 2))
    with pytest.raises(ValueError, match="tets only"):
        cuda.contract_G_Gw_tile(f(2, 3, 2, 2), f(2, 3, 2), f(2, 3, 3), f(2), 32)
    assert sum(cuda.LAUNCHES.values()) == 0


def test_tri_step_on_card_matches_cpu(card):
    """Two float64 steps of a 200-triangle cantilever with the two-level
    preconditioner: the card (every triangle kernel launched) against the
    CPU (plain versions)."""
    V, T, kw, _ = tri_arrays()
    cfg = SimConfig(h=DT, outer_steps=3, newton_tol=0.0, coarse_refresh_every=2)
    out = {}
    for dev in (card, torch.device("cpu")):
        mesh = tmesh.build_mesh_data(V, T, dtype=torch.float64, device=dev, **kw)
        cs = tcoarse.build_coarse_space(V, T, kw["is_fixed"], target_size=8,
                                        dtype=torch.float64, device=dev)
        x0 = torch.tensor(V, dtype=torch.float64, device=dev)
        v0 = torch.zeros_like(x0)
        v0[:, 1] = -2.0 * x0[:, 0] / 4.0
        st = newton.init_state(mesh, cfg, (), x0, v0)
        cuda.LAUNCHES.clear()
        for _ in range(2):
            st = newton.newton_step(mesh, cfg, (), st, cs)
        out[dev.type] = (st, dict(cuda.LAUNCHES))
    (g, launches), (c, none) = out["cuda"], out["cpu"]
    assert not none
    for k in ("element_apply_k3d2", "contract_G_Gw_n3", "segment_sum_m2",
              "segment_sum_m4", "segment_sum_m6", "segment_sum_m36"):
        assert launches.get(k, 0) > 0, k
    np.testing.assert_allclose(g.x.cpu().numpy(), c.x.numpy(), rtol=0,
                               atol=1e-9 * c.x.abs().max().item())
    assert g.stats.solver_iters.tolist() == c.stats.solver_iters.tolist()


def test_float32_tri_step_repeats_on_card(card):
    """chip_smoke.py phase 14's step (the 100k-triangle cantilever, f32, 5
    Newton iterations, the two-level coarse space): two runs from the same
    state agree bit for bit."""
    mesh, cs = _tri_beam(400, 125, torch.float32, card)
    cfg = SimConfig(h=DT, outer_steps=5, newton_tol=0.0, itr_tol=1e-4,
                    coarse_refresh_every=10, dtype="float32")
    runs = []
    for _ in range(2):
        st = newton.init_state(mesh, cfg, (), mesh.V0.clone(),
                               torch.zeros_like(mesh.V0))
        st = newton.newton_step(mesh, cfg, (), st, cs)
        runs.append(st)
    assert torch.equal(runs[0].x, runs[1].x)
    assert torch.equal(runs[0].stats.energy, runs[1].stats.energy)
    assert runs[0].stats.solver_iters.tolist() == runs[1].stats.solver_iters.tolist()


@pytest.mark.parametrize("solver,cfg", [
    ("direct", {}),
    ("pcg-ic", {}),
    ("amgcl", {}),
    ("direct", dict(mixed_variables=(), variables=("stretch",))),
], ids=["direct", "pcg-ic", "amgcl", "direct-vanilla-only"])
def test_host_step_on_card_matches_cpu(card, solver, cfg):
    """Two float64 steps of the host Newton step (optimizer/newton_direct.py)
    on the card (K3 and K2 in the coefficient update and the sums; the
    vanilla stretch's sums through K2 alone) against the CPU (plain
    versions): positions to 1e-9 of scale, equal Newton and linear counts."""
    from mixedfem_tpu_torch.optimizer import newton_direct

    V, T, kw, x = beam_arrays(seed=0)
    if solver == "amgcl":
        # Stable-Neo-Hookean's clamped stretch Hessians make the dual solve
        # part at the inputs' rounding (tests/test_torch_host_amg.py)
        kw = dict(kw, models=("Fung",))
    step = dict(dict(h=DT, outer_steps=3, newton_tol=0.0, itr_tol=1e-6,
                     mixed_variables=("mixed-stretch",), solver=solver), **cfg)
    out = {}
    for dev in (card, torch.device("cpu")):
        mesh = tmesh.build_mesh_data(V, T, dtype=torch.float64, device=dev, **kw)
        x0 = torch.tensor(x, dtype=torch.float64, device=dev)
        st = newton.init_state(mesh, SimConfig(**step), (), x0,
                               torch.zeros_like(x0))
        cuda.LAUNCHES.clear()
        for _ in range(2):
            st = newton_direct.newton_step_direct(mesh, SimConfig(**step), (),
                                                  st)
        out[dev.type] = (st, dict(cuda.LAUNCHES))
    (g, launches), (c, none) = out["cuda"], out["cpu"]
    assert not none
    need = (("segment_sum_m3",) if cfg else
            ("contract_G_Gw", "segment_sum_m3"))
    for k in need:
        assert launches.get(k, 0) > 0, k
    assert ("contract_G_Gw" in launches) == (not cfg)
    np.testing.assert_allclose(g.x.cpu().numpy(), c.x.numpy(), rtol=0,
                               atol=1e-9 * c.x.abs().max().item())
    assert g.stats.iterations == c.stats.iterations
    assert g.stats.solver_iters.tolist() == c.stats.solver_iters.tolist()


def test_vanilla_gradient_on_card_matches_cpu(card):
    """Three float64 steps of newton_step with record_vanilla_gradient (the
    probe apps/convergence.py reads, on the generic body) on the 1000-tet
    Fung beam from rest, pcg-block-jacobi, as chip_smoke.py's phase 20
    runs it, on the card against the CPU: positions to 1e-9 of scale,
    equal Newton counts, CG counts within 2% (at least 1; rounding decides
    a stop at the tolerance), the gradient norms to 1e-9 of the largest.
    CG stops at 1e-8: the stiff gradient magnifies a position difference
    about 3e3 times, and the two devices' CG iterates part by rounding (on
    the 360-tet beam from a deformed start, 2.8e-8 at 1e-6 and 8.6e-11 at
    1e-8 with equal counts)."""
    V, T, kw, x = beam_arrays(10, 5, 4)
    step = SimConfig(h=DT, outer_steps=3, newton_tol=0.0, itr_tol=1e-8,
                     mixed_variables=("mixed-stretch",),
                     solver="pcg-block-jacobi", record_vanilla_gradient=True)
    out = {}
    for dev in (card, torch.device("cpu")):
        mesh = tmesh.build_mesh_data(V, T, dtype=torch.float64, device=dev,
                                     **dict(kw, models=("Fung",)))
        x0 = torch.tensor(x, dtype=torch.float64, device=dev)
        st = newton.init_state(mesh, step, (), x0, torch.zeros_like(x0))
        for _ in range(3):
            st = newton.newton_step(mesh, step, (), st)
        out[dev.type] = st
    g, c = out["cuda"], out["cpu"]
    np.testing.assert_allclose(g.x.cpu().numpy(), c.x.numpy(), rtol=0,
                               atol=1e-9 * c.x.abs().max().item())
    assert g.stats.iterations == c.stats.iterations
    for a, b in zip(g.stats.solver_iters.tolist(), c.stats.solver_iters.tolist()):
        assert abs(a - b) <= max(1, math.ceil(0.02 * max(a, b))), (a, b)
    vc = c.stats.vanilla_grad
    assert (vc[:c.stats.iterations] > 0).all()
    # relative to the largest norm, as chip_smoke.py's phase 20 holds it
    np.testing.assert_allclose(g.stats.vanilla_grad.cpu().numpy(), vc.numpy(),
                               rtol=0, atol=1e-9 * vc.abs().max().item())


# ---------------------------------------------------------------------------
# shells and rods: K7 and K1's (3, 3, 6) and (2, 3, 6) instances
# ---------------------------------------------------------------------------

def _on_card(a, dtype, device, offset):
    """`a` on the card, `offset` elements into its own buffer (a contiguous
    view that is not 16-byte aligned when offset > 0)."""
    buf = torch.zeros(a.size + offset, dtype=dtype, device=device)
    buf[offset:] = torch.tensor(a.reshape(-1), dtype=dtype, device=device)
    return buf[offset:].view(a.shape)


@pytest.mark.parametrize("k,d", [(3, 3), (2, 3)])
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_contract_Gw_matches_plain(card, dtype, offset, k, d):
    """K7 at the shell (3, 3) and rod (2, 3) shapes, at E = 1, 31, 33, 103
    and 100,003 (partial last tiles of 32), from aligned and misaligned
    buffers, against contract_Gw_plain."""
    tol = 1e-12 if dtype == torch.float64 else 1e-5
    N = cuda.SHAPES[(k, d)].N
    for E in (1, 31, 33, 103, 100003):
        rng = np.random.default_rng(E)
        Hs = _on_card(rng.standard_normal((E, N, N)), dtype, card, offset)
        G = _on_card(rng.standard_normal((E, N, k, d)), dtype, card, offset)
        vols = _on_card(np.abs(rng.standard_normal(E)) + 0.1, dtype, card, offset)
        cuda.LAUNCHES.clear()
        got = smallops.contract_Gw(Hs, G, vols)
        ref = smallops.contract_Gw_plain(Hs, G, vols)
        torch.cuda.synchronize()
        assert dict(cuda.LAUNCHES) == {cuda.SHAPES[(k, d)].k7: 1}
        assert got.shape == ref.shape
        assert (got - ref).abs().max().item() <= tol * ref.abs().max().item()


@pytest.mark.parametrize("k", [3, 2])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_shell_rod_element_apply_matches_plain(card, dtype, k):
    """K1's shell (3, 3, 6) and rod (2, 3, 6) instances at E = 1, 31, 33,
    103 and 100,003 against element_apply_plain."""
    tol = 1e-12 if dtype == torch.float64 else 1e-5
    name = cuda.SHAPES[(k, 3)].k1
    for E in (1, 31, 33, 103, 100003):
        g = torch.Generator(device=card).manual_seed(E)
        nv = E + 2
        T = torch.randint(0, nv, (E, k), generator=g, device=card,
                          dtype=torch.int32)
        Gw = torch.randn(E, 6, k, 3, generator=g, device=card, dtype=dtype)
        mass = torch.randn(E, k, k, generator=g, device=card, dtype=dtype)
        fm = (torch.rand(nv, generator=g, device=card) > 0.2).to(dtype)
        p = torch.randn(nv, 3, generator=g, device=card, dtype=dtype)
        cuda.LAUNCHES.clear()
        got = cuda.element_apply(T, Gw, mass, fm, p)
        ref = top.element_apply_plain(T, Gw, mass, fm, p)
        torch.cuda.synchronize()
        assert dict(cuda.LAUNCHES) == {name: 1}
        assert (got - ref).abs().max().item() <= tol * ref.abs().max().item()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_laplacian_rows_on_k3(card, dtype):
    """The Laplacian preconditioner's rows go through K3 (Hs = I, one
    launch) and equal the plain rows sqrt(vol) D(I) : dphi to 1e-12 (f64)
    or 1e-6 (f32) of scale; shells and rods are refused."""
    from mixedfem_tpu_torch.solvers import laplacian as lapmod

    tol = 1e-12 if dtype == torch.float64 else 1e-6
    mesh, _ = _beam(dtype, card)
    cuda.LAUNCHES.clear()
    got = lapmod.laplacian_rows(mesh)
    assert dict(cuda.LAUNCHES) == {"contract_G_Gw": 1}
    E = mesh.nelem
    eye = torch.eye(3, dtype=dtype, device=card).expand(E, 3, 3)
    D = rotation.dsdF(eye, eye, 3)
    ref = torch.sqrt(mesh.vols)[:, None, None, None] * smallops.contract_D_dphi(
        D, mesh.dphidX)
    torch.cuda.synchronize()
    assert (got - ref).abs().max().item() <= tol * ref.abs().max().item()
    V, T, kw = cloth_arrays()
    shell = tmesh.build_mesh_data(V, T, dtype=dtype, device=card, **kw)
    with pytest.raises(NotImplementedError):
        lapmod.laplacian_rows(shell)


def _shell_rod_mesh(kind, dtype, device):
    if kind == "shell":
        V, T, kw = cloth_arrays(6, 6)
        return tmesh.build_mesh_data(V, T, dtype=dtype, device=device, **kw)
    V, E, kw = rod_arrays(4)
    return tmesh.build_rod_mesh_data(V, E, dtype=dtype, device=device, **kw)


@pytest.mark.parametrize("kind", ["shell", "rod"])
def test_shell_rod_steps_on_card_match_cpu(card, kind):
    """Three float64 steps of the 6 x 6 cloth and of a 4-strand bundle
    (default pcg, no coarse space) on the card, through K1, K7 and K2 and
    not K3, against the CPU: positions to 1e-9 of scale, equal Newton and
    CG counts."""
    cfg = SimConfig(h=0.01, outer_steps=3, itr_tol=1e-8,
                    max_iterative_solver_iters=2000,
                    mixed_variables=("mixed-stretch",))
    out = {}
    for dev in (card, torch.device("cpu")):
        mesh = _shell_rod_mesh(kind, torch.float64, dev)
        st = newton.init_state(mesh, cfg, (), mesh.V0.clone(),
                               torch.zeros_like(mesh.V0))
        cuda.LAUNCHES.clear()
        for _ in range(3):
            st = newton.newton_step(mesh, cfg, (), st)
        out[dev.type] = (st, dict(cuda.LAUNCHES))
    (g, launches), (c, none) = out["cuda"], out["cpu"]
    k = 3 if kind == "shell" else 2
    sh = cuda.SHAPES[(k, 3)]
    assert not none
    for name in (sh.k1, sh.k7, "segment_sum_m3", "segment_sum_m9"):
        assert launches.get(name, 0) > 0, name
    assert not any(n.startswith("contract_G_Gw") for n in launches)
    np.testing.assert_allclose(g.x.cpu().numpy(), c.x.numpy(), rtol=0,
                               atol=1e-9 * c.x.abs().max().item())
    assert g.stats.iterations == c.stats.iterations
    assert g.stats.solver_iters.tolist() == c.stats.solver_iters.tolist()


def test_float32_shell_step_repeats_on_card(card):
    """One float32 step of a 100 x 100 cloth (20,000 triangles) from rest,
    twice from the same state: the runs agree bit for bit."""
    V, T, kw = cloth_arrays(100, 100)
    mesh = tmesh.build_mesh_data(V, T, dtype=torch.float32, device=card, **kw)
    cfg = SimConfig(h=0.01, outer_steps=5, newton_tol=0.0, itr_tol=1e-4,
                    mixed_variables=("mixed-stretch",), dtype="float32")
    runs = []
    for _ in range(2):
        st = newton.init_state(mesh, cfg, (), mesh.V0.clone(),
                               torch.zeros_like(mesh.V0))
        runs.append(newton.newton_step(mesh, cfg, (), st))
    assert torch.equal(runs[0].x, runs[1].x)
    assert torch.equal(runs[0].stats.energy, runs[1].stats.energy)
    assert runs[0].stats.solver_iters.tolist() == runs[1].stats.solver_iters.tolist()


def test_polar_warm_on_card_matches_cpu(card):
    """rotation.polar_warm in float64 on the card against the CPU to 1e-12,
    from a seed off the optimum and from a broadcast identity."""
    rng = np.random.default_rng(0)
    F = rng.standard_normal((4096, 3, 3)) * 0.3 + np.eye(3)
    w = rng.standard_normal((4096, 3)) * 0.3
    for seed in ("rotated", "identity"):
        out = {}
        for dev in (card, torch.device("cpu")):
            Ft = torch.tensor(F, device=dev)
            if seed == "identity":
                R0 = torch.eye(3, dtype=torch.float64, device=dev).expand(
                    4096, 3, 3)
            else:
                R0 = rotation.polar33(Ft)[0] @ rotation._rodrigues(
                    torch.tensor(w, device=dev))
            out[dev.type] = [a.cpu() for a in rotation.polar_warm(Ft, R0)]
        for g, c in zip(out["cuda"], out["cpu"]):
            assert (g - c).abs().max().item() <= 1e-12


def _island_inputs(device):
    """The 360-tet beam at a float32 state with a velocity, a stretch off
    S(x), a warm-start seed and a displacement (made on the CPU, then
    copied to `device`, so that both devices start from the same bits):
    newton.island_update's, island_local_solve's and island_merit's
    inputs."""
    V, T, kw, x = beam_arrays(seed=0)
    cpu = torch.device("cpu")
    mesh = tmesh.build_mesh_data(V, T, dtype=torch.float32, device=cpu, **kw)
    rng = np.random.default_rng(4)
    f32 = dict(dtype=torch.float32)
    xt = torch.tensor(x, **f32)
    s = tms.reset(mesh, xt)[0]
    s = s + torch.tensor(0.01 * rng.standard_normal(tuple(s.shape)), **f32)
    v = torch.tensor(0.3 * rng.standard_normal(V.shape), **f32)
    dx = torch.tensor(1e-3 * rng.standard_normal(V.shape)
                      * (~kw["is_fixed"])[:, None], **f32)
    R = tms.stretch_of_x(mesh, mesh.V0)[1]
    mesh = tmesh.build_mesh_data(V, T, dtype=torch.float32, device=device,
                                 **kw)
    xt, s, v, dx, R = (a.to(device) for a in (xt, s, v, dx, R))
    return mesh, tbdf.bdf_init("BDF1", xt, v, DT), xt, s, dx, R


def test_island_pieces_on_card_match_cpu(card):
    """One island iteration's float64 pieces (the inertia gradient, the
    coefficient update through K3's f64 instance, the rhs through K2's,
    the local solve, the merit at alpha = 0 and 0.5) on the card against
    the CPU at the same float32 state, to 1e-12 of scale; K3 launches in
    float64 only."""
    out = {}
    for dev in (card, torch.device("cpu")):
        mesh, bdf, x, s, dx, R = _island_inputs(dev)
        mesh_hp = newton._cast(mesh, torch.float64)
        bdf_hp = newton._cast(bdf, torch.float64)
        cuda.clear_launches()
        g, b, c, _ = newton.island_update(mesh_hp, bdf_hp, x, s, DT,
                                          blend=0.5, R_prev=R)
        ds, la, _, _ = newton.island_local_solve(mesh_hp, None, c, None, s,
                                                 torch.zeros_like(s), dx)
        merit = newton.island_merit(mesh_hp, bdf_hp, DT * DT, x, s, dx, ds,
                                    la)
        typed = dict(cuda.LAUNCHES_BY_TYPE)
        pieces = [g, b, c.G, c.Gw, c.H, c.g, c.Sv, c.R, ds, la, merit(0.0),
                  merit(0.5)]
        out[dev.type] = ([p.cpu() for p in pieces], typed)
    (gp, typed), (cp, none) = out["cuda"], out["cpu"]
    assert not none
    assert typed.get("contract_G_Gw_f64", 0) == 1
    assert typed.get("segment_sum_m3_f64", 0) >= 2
    assert not any(k.endswith("_f32") for k in typed), typed
    for a, e in zip(gp, cp):
        assert a.dtype == torch.float64
        scale = max(e.abs().max().item(), 1e-300)
        assert (a - e).abs().max().item() <= 1e-12 * scale


def test_float32_island_step_repeats_on_card(card):
    """One float32 step of a 1200-tet beam with f64 islands and
    warm-started rotations, twice from the same state: the runs agree bit
    for bit, and the coefficient update ran in float64 only."""
    V, T, kw, _ = beam_arrays(10, 5, 4)
    mesh = tmesh.build_mesh_data(V, T, dtype=torch.float32, device=card,
                                 **kw)
    cfg = SimConfig(h=DT, outer_steps=5, newton_tol=0.0, itr_tol=1e-4,
                    mixed_variables=("mixed-stretch",), dtype="float32",
                    rhs_precision="float64", rotation_warm_start=True)
    runs = []
    for _ in range(2):
        st = newton.init_state(mesh, cfg, (), mesh.V0.clone(),
                               torch.zeros_like(mesh.V0))
        cuda.clear_launches()
        runs.append(newton.newton_step(mesh, cfg, (), st))
        typed = dict(cuda.LAUNCHES_BY_TYPE)
        assert typed.get("contract_G_Gw_f64", 0) == runs[-1].stats.iterations
        assert typed.get("contract_G_Gw_f32", 0) == 0
    assert torch.equal(runs[0].x, runs[1].x)
    assert torch.equal(runs[0].R, runs[1].R)
    assert torch.equal(runs[0].stats.energy, runs[1].stats.energy)
    assert runs[0].stats.solver_iters.tolist() == runs[1].stats.solver_iters.tolist()
