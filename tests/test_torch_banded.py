"""The banded windowed scatter of mixedfem_tpu_torch (ops/banded_scatter.py,
kernel K4 on the card) and the banded matvec and Newton step built on it,
against mixedfem_tpu's plan and its Pallas kernel
(ops/pallas_scatter.py:_make_kernel) run in interpret mode, on the same
numpy inputs on the CPU. Also the one TPU kernel no path calls,
ops/brick.py:_matvec_kernel2, held to the port's K1 + K2 matvec.

Tolerances: the plans are host integer arrays and must be equal. The
scatter sums the same rows in another order (the Pallas kernel contracts a
one-hot matrix per chunk): f64 to 1e-13 and f32 to 3e-6 of the output's
scale. The matvec, f64, to 1e-12 of scale; the 3-step f64 trajectory to
1e-8 on positions of order 1, with equal CG and Newton counts. The brick
kernel splits f32 into bf16 hi/lo halves (~1e-6 relative): 3e-6 of scale."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from mixedfem_tpu.config import SimConfig as JConfig
from mixedfem_tpu.mesh import mesh as jmesh
from mixedfem_tpu.ops import brick
from mixedfem_tpu.ops import pallas_scatter as psc
from mixedfem_tpu.optimizer import newton as jnewton
from mixedfem_tpu.solvers import coarse as jcoarse
from mixedfem_tpu.solvers import operator as jop
from mixedfem_tpu.variables import mixed_stretch as jms
from mixedfem_tpu_torch import convert, cuda
from mixedfem_tpu_torch.config import SimConfig as TConfig
from mixedfem_tpu_torch.ops import banded_scatter as bs
from mixedfem_tpu_torch.optimizer import newton as tnewton
from mixedfem_tpu_torch.solvers import operator as top
from mixedfem_tpu_torch.variables import mixed_stretch as tms

from torch_parity import (  # noqa: F401 (one_torch_thread is a fixture)
    beam_arrays, close, one_torch_thread, port, to_numpy,
)


@pytest.fixture(scope="module", autouse=True)
def _one_thread(one_torch_thread):
    """Every test of this module runs on one torch intra-op thread."""


CHUNK = 128  # 900 tets -> 3600 rows, 29 chunks, the last one part padding
STEP_CHUNK = 512  # 360 tets -> 1440 rows, 3 chunks
DT = 0.02


def _shuffled(V, T, seed=0):
    """The mesh with its vertex ids in a seeded random order, as a mesher's
    file looks to the loader (which reorders elements, never vertices)."""
    p = np.random.default_rng(seed).permutation(len(V))
    inv = np.empty_like(p)
    inv[p] = np.arange(len(p))
    T = inv[T].astype(np.int32)
    return V[p], T[top.sort_elements_banded(T)]


def _meshes():
    V, T, _, _ = beam_arrays(15, 4, 3)
    return {"banded": (V, T), "shuffled": _shuffled(V, T)}


@pytest.mark.parametrize("which", ["banded", "shuffled"])
def test_plan_matches_jax(which):
    V, T = _meshes()[which]
    ref = psc.build_banded_scatter_plan(T.reshape(-1), len(V), chunk=CHUNK)
    got = bs.build_banded_scatter_plan(T.reshape(-1), len(V), chunk=CHUNK,
                                       device="cpu")
    np.testing.assert_array_equal(got.lidx.numpy(), np.asarray(ref.lidx))
    np.testing.assert_array_equal(got.win_start.numpy(),
                                  np.asarray(ref.win_start))
    assert (got.W, got.nrows, got.chunk, got.nv) == (
        ref.W, ref.nrows, ref.chunk, ref.nv)
    # unordered vertex ids widen the windows to the whole mesh
    assert got.W == {"banded": 256, "shuffled": 384}[which]


@pytest.mark.parametrize("which", ["banded", "shuffled"])
def test_vertex_csr(which):
    """K4's plan: per vertex, the rows (before padding) that target it, in
    ascending order; every row once, the zero padding rows in no vertex's
    list, and no pieces (no vertex has more than L rows)."""
    V, T = _meshes()[which]
    plan = bs.build_banded_scatter_plan(T.reshape(-1), len(V), chunk=CHUNK,
                                        device="cpu")
    csr = plan.csr
    R = T.size
    assert plan.nrows == R < plan.lidx.shape[0] and csr.nseg == len(V)
    assert csr.piece_ptr is None and csr.npieces == len(V)
    row_ptr, slots = csr.row_ptr.numpy(), csr.slots.numpy()
    assert sorted(slots.tolist()) == list(range(R))
    ids = T.reshape(-1)
    for v in range(len(V)):
        np.testing.assert_array_equal(slots[row_ptr[v]:row_ptr[v + 1]],
                                      np.nonzero(ids == v)[0])
    np.testing.assert_array_equal(csr.seg.numpy(), ids[slots])


@pytest.mark.parametrize("which", ["banded", "shuffled"])
@pytest.mark.parametrize("m", [3, 9])
@pytest.mark.parametrize("dtype,tol", [(np.float64, 1e-13), (np.float32, 3e-6)])
def test_scatter_add_sorted_vs_pallas(which, m, dtype, tol):
    V, T = _meshes()[which]
    R = T.size
    assert R % CHUNK
    ref_plan = psc.build_banded_scatter_plan(T.reshape(-1), len(V), chunk=CHUNK)
    plan = bs.build_banded_scatter_plan(T.reshape(-1), len(V), chunk=CHUNK,
                                        device="cpu")
    Rp = plan.lidx.shape[0]
    rows = np.zeros((Rp, m), dtype)
    rows[:R] = np.random.default_rng(m).standard_normal((R, m))
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(psc.scatter_add_sorted(ref_plan, jnp.asarray(rows)))
    got = bs.scatter_add_sorted(plan, torch.from_numpy(rows))
    assert got.shape == (len(V), m) and got.dtype == torch.from_numpy(rows).dtype
    close(got, ref, rtol=0, atol=tol * np.abs(ref).max())
    # and the plain sum of the same rows
    want = np.zeros((len(V), m))
    np.add.at(want, T.reshape(-1), rows[:R].astype(np.float64))
    close(got.double(), want, rtol=0, atol=tol * np.abs(want).max())


def test_scatter_add_sorted_checks_rows():
    V, T = _meshes()["banded"]
    plan = bs.build_banded_scatter_plan(T.reshape(-1), len(V), chunk=CHUNK,
                                        device="cpu")
    with pytest.raises(ValueError):
        bs.scatter_add_sorted(plan, torch.zeros(T.size, 3))
    with pytest.raises(ValueError):
        bs.pad_rows(plan, torch.zeros(plan.lidx.shape[0] + 1, 3))


@pytest.fixture(scope="module")
def beam():
    V, T, kw, x = beam_arrays(seed=0)
    jm = jmesh.build_mesh_data(V, T, dtype=jnp.float64, **kw)
    tm, _, _ = port(mesh=jm)
    jplan = jop.build_banded_plan(jm, chunk=STEP_CHUNK)
    return dict(V=V, T=T, kw=kw, x=x, jm=jm, tm=tm, jplan=jplan,
                tplan=convert.banded_plan_from_numpy(to_numpy(jplan), "cpu"))


def test_build_banded_plan(beam):
    """The port's own plan of the mesh equals the JAX plan carried across."""
    got = top.build_banded_plan(beam["tm"], chunk=STEP_CHUNK)
    want = beam["tplan"]
    for f in ("lidx", "win_start"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    for f in ("row_ptr", "slots", "seg"):
        assert torch.equal(getattr(got.csr, f), getattr(want.csr, f)), f
    assert got.csr.piece_ptr is None and want.csr.piece_ptr is None
    assert (got.W, got.nrows, got.nv) == (want.W, want.nrows, want.nv)


def test_banded_matvec_vs_pallas(beam):
    """Random Gw (the only coefficient the matvec reads), of the order of
    the mass blocks."""
    jm, tm = beam["jm"], beam["tm"]
    E = jm.nelem
    Gw = np.random.default_rng(7).standard_normal((E, 6, 4, 3))
    z = jnp.zeros((E, 6, 6))
    coeffs = jms.StretchCoeffs(
        G=jnp.zeros((E, 6, 4, 3)), Gw=jnp.asarray(Gw), H=z, Hinv=z,
        g=z[:, 0], Sv=z[:, 0], R=z[:, :3, :3], max_evals=z[:, 0, 0],
    )
    p = np.random.default_rng(4).standard_normal((jm.nv, 3))
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(jop.banded_matvec(jm, beam["jplan"], jnp.asarray(p),
                                           ms_coeffs=coeffs))
    c = tms.StretchCoeffs(G=None, Gw=torch.from_numpy(Gw), H=None, Hinv=None,
                          g=None, Sv=None, R=None, max_evals=None)
    got = top.banded_matvec(tm, beam["tplan"], torch.from_numpy(p), c)
    assert not got[tm.free_mask == 0].any()
    close(got, ref, rtol=0, atol=1e-12 * np.abs(ref).max())
    # the same operator as the incidence-plan matvec
    close(got, top.element_matvec(tm, torch.from_numpy(p), c).numpy(),
          rtol=0, atol=1e-12 * np.abs(ref).max())


@pytest.fixture(scope="module")
def banded_trajectory(beam):
    """3 BDF1 steps of both packages with their banded plans (the JAX one in
    interpret mode) and the two-level preconditioner."""
    V, T, kw, jm = beam["V"], beam["T"], beam["kw"], beam["jm"]
    cfg = dict(h=DT, outer_steps=3, newton_tol=0.0, itr_tol=1e-4,
               mixed_variables=("mixed-stretch",))
    jcfg, tcfg = JConfig(**cfg), TConfig(**cfg)
    jc = jcoarse.build_coarse_space(V, T, kw["is_fixed"], target_size=8,
                                    dtype=jnp.float64)
    st = jnewton.init_state(jm, jcfg, (), jnp.asarray(V),
                            jnp.zeros_like(jnp.asarray(V)))
    tm, ts, tc = port(mesh=jm, state=st, coarse=jc)
    out = []
    for _ in range(3):
        with pltpu.force_tpu_interpret_mode():
            st = jnewton.newton_step(jm, jcfg, (), st, jc, (), beam["jplan"])
        ts = tnewton.newton_step(tm, tcfg, (), ts, tc, (), beam["tplan"])
        out.append((to_numpy(st), ts))
    return out


def test_banded_trajectory(banded_trajectory):
    for js, ts in banded_trajectory:
        close(ts.x, js["x"], rtol=0, atol=1e-8)
        close(ts.s, js["s"], rtol=0, atol=1e-8)
        assert ts.stats.iterations == int(js["stats"]["iterations"])
        np.testing.assert_array_equal(ts.stats.solver_iters.numpy(),
                                      js["stats"]["solver_iters"])


def test_matvec_kernel2_vs_element_matvec():
    """ops/brick.py:_matvec_kernel2 (no caller in the JAX package) computes
    the fused CG matvec, which the port computes with K1 + K2."""
    V, T, kw, _ = beam_arrays()
    jm = jmesh.build_mesh_data(V, T, dtype=jnp.float32, **kw)
    tm, _, _ = port(mesh=jm, dtype=torch.float32)
    E = len(T)
    Gw = np.random.default_rng(7).standard_normal((E, 6, 4, 3)).astype(
        np.float32)
    p = np.random.default_rng(8).standard_normal((jm.nv, 3)).astype(np.float32)
    plan = brick.build_brick_plan(T, jm.nv, ce=128)
    Gw_rows = brick.pad_rows(plan, jnp.asarray(Gw).reshape(E, -1))
    m_rows = brick.pad_rows(plan, jm.mass_coeff.reshape(E, 16))
    pm = jnp.asarray(p) * jm.free_mask[:, None]
    out = brick._matvec_call2(
        plan.hilo_cm, plan.h0, Gw_rows, m_rows, brick.to_brick(pm, plan.Hpad),
        (plan.ce, plan.k, 3, 6, plan.Wh, plan.Hpad), interpret=True,
    )
    ref = np.asarray(brick.from_brick(out, jm.nv, 3) * jm.free_mask[:, None])
    c = tms.StretchCoeffs(G=None, Gw=torch.from_numpy(Gw), H=None, Hinv=None,
                          g=None, Sv=None, R=None, max_evals=None)
    got = top.element_matvec(tm, torch.from_numpy(p), c)
    close(got, ref, rtol=0, atol=3e-6 * np.abs(ref).max())


def test_banded_path_counts_no_launch_on_cpu(beam):
    cuda.LAUNCHES.clear()
    rows = torch.zeros(beam["tplan"].lidx.shape[0], 3, dtype=torch.float64)
    bs.scatter_add_sorted(beam["tplan"], rows)
    assert sum(cuda.LAUNCHES.values()) == 0
