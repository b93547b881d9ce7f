"""The three CUDA kernels of mixedfem_tpu_torch (csrc/kernels.cu) and the
functions they compute.

On the CPU each wrapper runs its plain PyTorch version, held here to the
JAX package's functions on the same inputs:
  K1 + K2 (the CG matvec)   vs  operator.element_matvec (f64, 1e-12) and
                                ops/brick.py:brick_matvec in interpret mode
                                (f32; the brick kernel's bf16 hi/lo split is
                                ~3e-6 relative, as tests/test_brick.py holds it)
  K2 (segment_sum)          vs  jax.ops.segment_sum (f64, 1e-13; also over
                                a plan that splits long segments into
                                pieces) and brick_scatter in interpret mode
                                (f32, 3e-6)
  K3 (contract_G_Gw)        vs  tests/test_torch_step.py::test_contractions
                                and ::test_contract_G_Gw_tile_edges
  K5, K6 (stencil_apply,    vs  tests/test_torch_stencil.py
  stencil_assemble)
The kernels themselves are held to the plain versions on the card by
tests/test_torch_cuda.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mixedfem_tpu.mesh import mesh as jmesh
from mixedfem_tpu.ops import brick
from mixedfem_tpu.solvers import operator as jop
from mixedfem_tpu.variables import mixed_stretch as jms
from mixedfem_tpu_torch import cuda
from mixedfem_tpu_torch.mesh import generators
from mixedfem_tpu_torch.mesh import mesh as tmesh
from mixedfem_tpu_torch.ops import assembly, smallops
from mixedfem_tpu_torch.solvers import coarse as tcoarse
from mixedfem_tpu_torch.solvers import operator as top
from mixedfem_tpu_torch.variables import mixed_stretch as tms

from torch_parity import (  # noqa: F401 (one_torch_thread is a fixture)
    beam_arrays, close, one_torch_thread, port,
)


@pytest.fixture(scope="module", autouse=True)
def _one_thread(one_torch_thread):
    """Every test of this module runs on one torch intra-op thread."""


DT = 0.02


def _setup(dtype):
    """The beam in both packages, and JAX StretchCoeffs whose Gw (the only
    field the matvec reads) is random, of the order of the mass blocks."""
    V, T, kw, _ = beam_arrays()
    jm = jmesh.build_mesh_data(V, T, dtype=dtype, **kw)
    E = len(T)
    Gw = np.random.default_rng(7).standard_normal((E, 6, 4, 3))
    z = jnp.zeros((E, 6, 6), dtype)
    coeffs = jms.StretchCoeffs(
        G=jnp.zeros((E, 6, 4, 3), dtype), Gw=jnp.asarray(Gw, dtype), H=z,
        Hinv=z, g=z[:, 0], Sv=z[:, 0], R=z[:, :3, :3], max_evals=z[:, 0, 0],
    )
    tm, _, _ = port(mesh=jm, dtype=torch.float64 if dtype == jnp.float64
                    else torch.float32)
    return jm, tm, coeffs


@pytest.fixture(scope="module")
def f64():
    return _setup(jnp.float64)


@pytest.fixture(scope="module")
def f32():
    return _setup(jnp.float32)


def test_incidence_plan():
    """CSR of (element, corner) slots per vertex, ascending within each
    vertex; every slot appears once."""
    T = np.array([[0, 1, 2, 3], [1, 2, 3, 4], [4, 0, 2, 5]])
    plan = assembly.build_incidence_plan(T, 7, "cpu")
    row_ptr, slots = plan.row_ptr.numpy(), plan.slots.numpy()
    assert row_ptr.tolist() == [0, 2, 4, 7, 9, 11, 12, 12]
    assert sorted(slots.tolist()) == list(range(12))
    flat = T.reshape(-1)
    for v in range(7):
        seg = slots[row_ptr[v]:row_ptr[v + 1]]
        assert np.all(flat[seg] == v) and np.all(np.diff(seg) > 0)
    with pytest.raises(ValueError):
        assembly.segment_sum(plan, torch.zeros(2, 4, 3))


def _pair_like_segments(seed=0):
    """Segment ids of rows with a length mix like the coarse pair plan's
    (most segments under 200 rows, a few of 257-1200, one of 4193, an empty
    one, lengths at and just past 256), in a shuffled row order; 10,000+
    rows, not a multiple of 32."""
    rng = np.random.default_rng(seed)
    lens = np.concatenate([rng.integers(1, 200, 60), rng.integers(257, 1200, 6),
                           [4193, 0, 256, 257, 33]])
    seg = np.repeat(np.arange(len(lens)), lens)
    rng.shuffle(seg)
    assert len(seg) % 32
    return seg, len(lens)


@pytest.mark.parametrize("L", [32, 100, 256])
def test_piece_split(L):
    """Segments longer than L slots split into consecutive pieces of at
    most L, each inside its segment, in slot order; the plain sum adds the
    rows in slot order per piece, then the pieces in order."""
    seg, nseg = _pair_like_segments()
    plan = assembly.build_incidence_plan(seg, nseg, "cpu", piece_rows=L)
    rp, pp = plan.row_ptr.numpy(), plan.piece_ptr.numpy()
    sp, ps = plan.seg_pieces.numpy(), plan.piece_seg.numpy()
    assert pp[0] == 0 and pp[-1] == len(seg) and plan.npieces == len(ps)
    assert np.all(np.diff(pp) >= 0) and np.all(np.diff(pp) <= L)
    for v in range(nseg):
        n = rp[v + 1] - rp[v]
        assert sp[v + 1] - sp[v] == max(1, -(-n // L))
        assert np.all(ps[sp[v]:sp[v + 1]] == v)
        assert pp[sp[v]] == rp[v] and pp[sp[v + 1]] == rp[v + 1]
    rows = np.random.default_rng(1).standard_normal((len(seg), 36))
    got = assembly.segment_sum_plain(plan, torch.from_numpy(rows))
    want = np.zeros((nseg, 36))
    np.add.at(want, seg, rows)
    close(got, want, rtol=0, atol=1e-13 * np.abs(want).max())
    # the order, bit for bit in float32: per piece, then per segment
    r32 = rows.astype(np.float32)[plan.slots.numpy()]
    part = [np.zeros(36, np.float32) for _ in ps]
    for p in range(len(ps)):
        for j in range(pp[p], pp[p + 1]):
            part[p] = part[p] + r32[j]
    ordered = np.zeros((nseg, 36), np.float32)
    for p in range(len(ps)):
        ordered[ps[p]] = ordered[ps[p]] + part[p]
    got32 = assembly.segment_sum_plain(plan, torch.from_numpy(rows.astype(np.float32)))
    np.testing.assert_array_equal(got32.numpy(), ordered)


def test_bench_plans_have_no_pieces_but_the_pair_plan():
    """At the 100k-tet beam's shapes and the default L, the vertex plan (at
    most 32 rows per vertex) and the aggregate plan (at most 90) have no
    pieces, so their sums keep their order; the pair plan (up to 4193 rows
    per aggregate pair) has."""
    V, T = generators.box_tet_mesh(40, 25, 20, size=(4.0, 1.0, 1.0))
    vert = assembly.build_incidence_plan(T, len(V), "cpu")
    cs = tcoarse.build_coarse_space(V, T, V[:, 0] < 1e-9, target_size=48,
                                    dtype=torch.float32, device="cpu")
    longest = [int(np.diff(p.row_ptr.numpy()).max())
               for p in (vert, cs.agg_plan, cs.pair_plan)]
    assert longest == [32, 90, 4193]
    assert vert.piece_ptr is None and cs.agg_plan.piece_ptr is None
    assert vert.npieces == len(V) and cs.agg_plan.npieces == cs.naggr
    assert cs.pair_plan.npieces > cs.pair_plan.nseg


@pytest.mark.parametrize("L", [64, 256])
def test_segment_sum_with_pieces_vs_jax_segment_sum(L):
    seg, nseg = _pair_like_segments(2)
    plan = assembly.build_incidence_plan(seg.reshape(-1, 1), nseg, "cpu",
                                         piece_rows=L)
    assert plan.piece_ptr is not None
    vals = np.random.default_rng(L).standard_normal((len(seg), 1, 6, 6))
    ref = jax.ops.segment_sum(jnp.asarray(vals).reshape(-1, 36),
                              jnp.asarray(seg), num_segments=nseg)
    got = assembly.segment_sum(plan, torch.tensor(vals))
    assert got.shape == (nseg, 6, 6)
    close(got.reshape(nseg, 36), ref, rtol=0,
          atol=1e-13 * float(jnp.max(jnp.abs(ref))))


@pytest.mark.parametrize("m", [3, 9])
def test_segment_sum_vs_jax_segment_sum(f64, m):
    jm, tm, _ = f64
    E = jm.nelem
    vals = np.random.default_rng(m).standard_normal((E, 4, m))
    ref = jax.ops.segment_sum(
        jnp.asarray(vals).reshape(-1, m), jm.T.reshape(-1), num_segments=jm.nv
    )
    got = assembly.segment_sum(tm.plan, torch.tensor(vals))
    assert got.shape == (jm.nv, m)
    close(got, ref, rtol=1e-13, atol=1e-13)


@pytest.mark.parametrize("m", [3, 9])
def test_segment_sum_vs_brick_scatter(f32, m):
    jm, tm, _ = f32
    vals = np.random.default_rng(10 + m).standard_normal(
        (jm.nelem, 4, m)).astype(np.float32)
    plan = brick.build_brick_plan(np.asarray(jm.T), jm.nv, ce=128)
    ref = brick.from_brick(
        brick.brick_scatter(plan, jnp.asarray(vals), interpret=True), jm.nv, m
    )
    got = assembly.segment_sum(tm.plan, torch.tensor(vals))
    scale = float(jnp.max(jnp.abs(ref)))
    close(got, ref, rtol=0, atol=3e-6 * scale)


def _p(jm, seed, dtype=np.float64):
    return np.random.default_rng(seed).standard_normal((jm.nv, 3)).astype(dtype)


def test_matvec_vs_element_matvec(f64):
    """K1 + K2 against the JAX generic matvec, pinned vertices included."""
    jm, tm, coeffs = f64
    p = _p(jm, 20)
    ref = jop.element_matvec(jm, jnp.asarray(p), ms_coeffs=coeffs)
    Gw = torch.tensor(np.asarray(coeffs.Gw))
    got = top.element_matvec(tm, torch.tensor(p), tms.StretchCoeffs(
        G=None, Gw=Gw, H=None, Hinv=None, g=None, Sv=None, R=None,
        max_evals=None))
    assert not got[tm.free_mask == 0].any()
    close(got, ref, rtol=1e-12, atol=1e-13 * float(jnp.max(jnp.abs(ref))))


def test_element_apply_rows(f64):
    """K1 alone: per-corner rows (E, 4, 3) of the projected element product."""
    jm, tm, coeffs = f64
    p = _p(jm, 21)
    pe = (jnp.asarray(p) * jm.free_mask[:, None])[jm.T]
    q = jnp.einsum("eikr,ekr->ei", coeffs.Gw, pe)
    ref = jnp.einsum("eikr,ei->ekr", coeffs.Gw, q) + jnp.einsum(
        "ekl,eld->ekd", jm.mass_coeff, pe)
    got = top.element_apply(tm, torch.tensor(np.asarray(coeffs.Gw)),
                            torch.tensor(p))
    assert got.shape == (jm.nelem, 4, 3)
    close(got, ref, rtol=1e-12, atol=1e-13 * float(jnp.max(jnp.abs(ref))))


def test_matvec_vs_brick_matvec(f32):
    """K1 + K2 against the TPU kernel itself (Pallas interpret mode)."""
    jm, tm, coeffs = f32
    p = _p(jm, 22, np.float32)
    plan = brick.build_brick_plan(np.asarray(jm.T), jm.nv, ce=128)
    Gw_rows, m_rows = brick.element_rows(jm, coeffs)
    pm = jnp.asarray(p) * jm.free_mask[:, None]
    ref = brick.from_brick(
        brick.brick_matvec(
            plan, brick.pad_rows(plan, Gw_rows), brick.pad_rows(plan, m_rows),
            brick.to_brick(pm, plan.Hpad), 3, interpret=True,
        ),
        jm.nv, 3,
    ) * jm.free_mask[:, None]
    got = top.element_matvec(tm, torch.tensor(p), tms.StretchCoeffs(
        G=None, Gw=torch.tensor(np.asarray(coeffs.Gw)), H=None, Hinv=None,
        g=None, Sv=None, R=None, max_evals=None))
    scale = float(jnp.max(jnp.abs(ref)))
    close(got, ref, rtol=0, atol=3e-6 * scale)


def test_launchers_take_cuda_tensors_only():
    """No fallback: the CUDA launchers refuse CPU tensors before touching
    the compiler, and the CPU path never counts a launch."""
    cuda.LAUNCHES.clear()
    T = torch.zeros((2, 4), dtype=torch.int32)
    f = torch.zeros
    with pytest.raises(ValueError, match="CUDA tensors"):
        cuda.element_apply(T, f(2, 6, 4, 3), f(2, 4, 4), f(5), f(5, 3))
    with pytest.raises(ValueError, match="CUDA tensors"):
        cuda.segment_sum(torch.zeros(6, dtype=torch.int32),
                         torch.zeros(8, dtype=torch.int32), f(8, 3), 5)
    with pytest.raises(ValueError, match="CUDA tensors"):
        cuda.contract_G_Gw(f(2, 6, 3, 3), f(2, 4, 3), f(2, 6, 6), f(2))
    with pytest.raises(ValueError, match="CUDA tensors"):
        cuda.contract_G_Gw_tile(f(2, 6, 3, 3), f(2, 4, 3), f(2, 6, 6), f(2), 32)
    with pytest.raises(ValueError, match="tile 48"):
        cuda.contract_G_Gw_tile(f(2, 6, 3, 3), f(2, 4, 3), f(2, 6, 6), f(2), 48)
    i32 = torch.int32
    with pytest.raises(ValueError, match="CUDA tensors"):
        cuda.stencil_apply(f(27, 3, 3, 64), f(3, 64), None, (2, 2, 2), 1)
    with pytest.raises(ValueError, match="CUDA tensors"):
        cuda.stencil_assemble(f(5, 6, 4, 3), f(5, 4, 4),
                              torch.zeros(160, 8, dtype=i32),
                              torch.zeros(28, dtype=i32), (2, 2, 2), 5,
                              torch.zeros(200, dtype=i32))
    plan = assembly.build_incidence_plan(T.numpy(), 5, "cpu")
    assembly.segment_sum(plan, f(2, 4, 3))
    smallops.contract_G_Gw(f(2, 6, 3, 3), f(2, 4, 3), f(2, 6, 6), f(2))
    from mixedfem_tpu_torch.ops import stencil
    V, Tg = generators.box_tet_mesh(1, 1, 1)
    sp, _ = stencil.build_stencil_plan(Tg, len(V), (2, 2, 2), device="cpu")
    W = stencil.assemble_W(sp, f(5, 6, 4, 3), f(5, 4, 4))
    stencil.matvec_lat(sp, W, f(3, sp.npad), f(3, sp.npad))
    assert sum(cuda.LAUNCHES.values()) == 0


def test_entry_points_need_a_card_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    V, T, kw, _ = beam_arrays(2, 1, 1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmesh.build_mesh_data(V, T, **kw)
    assert tmesh.build_mesh_data(V, T, device="cpu", **kw).device.type == "cpu"
