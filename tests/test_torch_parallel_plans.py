"""The sharded paths' host plans of mixedfem_tpu_torch/parallel/ against
mixedfem_tpu/parallel/'s, bit for bit (host numpy, no ranks): the RCM
order and bandwidth of a shuffled beam, build_halo_plan, build_vp_plan
with and without a coarse space (and its refusal of a halo deeper than a
block), build_shard_plan and the slab tables of the sharded stencil step
(build_local_T, build_rest_rows, build_valid_rows, the slab's lattice
fields), the element padding of the element-sharded step (15 tets over 4
ranks, 15 over 3, 20 over 3), and convert.py's hand-over of the JAX
plans."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mixedfem_tpu.mesh import generators as jgen
from mixedfem_tpu.parallel import halo as jhalo
from mixedfem_tpu.parallel import reorder as jreorder
from mixedfem_tpu.parallel import sharding as jsharding
from mixedfem_tpu.parallel import stencil_shard as jss
from mixedfem_tpu.parallel import vp_step as jvp
from mixedfem_tpu.solvers.coarse import build_coarse_space as jbuild_cs
from mixedfem_tpu_torch import convert
from mixedfem_tpu_torch.ops import stencil as stmod
from mixedfem_tpu_torch.parallel import halo, reorder, sharding
from mixedfem_tpu_torch.parallel import stencil_shard as ss
from mixedfem_tpu_torch.parallel import vp_step as vp

from test_newton import small_beam
from test_stencil import _grid_setup
from torch_parity import one_torch_thread, port, to_numpy  # noqa: F401

SHARDS = (2, 3, 4, 8)
VP_FIELDS = ("T_local", "emask", "dphidX", "vols", "mass_coeff", "mu", "lam",
             "model_id", "free_mask", "ext", "agg_v", "r_v", "agg_e")


@pytest.fixture(scope="module", autouse=True)
def _one_thread(one_torch_thread):
    """Every test of this module runs on one torch intra-op thread."""


@pytest.fixture(scope="module")
def beam():
    """small_beam(32, 2, 2) of the JAX sharding tests, both packages, and
    its geometric coarse space (target 24)."""
    jm, V = small_beam(32, 2, 2)
    cs = jbuild_cs(np.asarray(jm.V0), np.asarray(jm.T),
                   ~np.asarray(jm.free_mask, bool), target_size=24,
                   dtype=jnp.float64)
    tm, _, tcs = port(mesh=jm, coarse=cs)
    return jm, cs, tm, tcs


def _fields(plan) -> dict:
    """A JAX NamedTuple plan as the dict of numpy values convert.py takes."""
    return {k: to_numpy(v) for k, v in plan._asdict().items()}


def _equal(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype, (what, a.shape, b.shape,
                                                       a.dtype, b.dtype)
    assert np.array_equal(a, b), what


def test_rcm_order_and_bandwidth_equal_jax():
    V, T = jgen.box_tet_mesh(12, 3, 3)
    rng = np.random.default_rng(0)
    shuffle = rng.permutation(len(V))
    T = shuffle[T]
    V2 = np.empty_like(V)
    V2[shuffle] = V
    o_j = jreorder.banded_vertex_order(len(V2), T)
    o_t = reorder.banded_vertex_order(len(V2), T)
    _equal(o_t, o_j, "old_to_new")
    assert reorder.bandwidth(T) == jreorder.bandwidth(T)
    assert reorder.bandwidth(T, o_t) == jreorder.bandwidth(T, o_j)
    assert reorder.bandwidth(T, o_t) < reorder.bandwidth(T) / 4
    f = rng.standard_normal((len(V2), 3))
    for a, b in zip(reorder.reorder_mesh_arrays(V2, T, f),
                    jreorder.reorder_mesh_arrays(V2, T, f)):
        _equal(a, b, "reorder_mesh_arrays")


@pytest.mark.parametrize("D", SHARDS)
def test_halo_plan_equals_jax(beam, D):
    jm, _, tm, _ = beam
    pj = jhalo.build_halo_plan(jm, D)
    pt = halo.build_halo_plan(tm, D)
    for f in ("T_local", "emask", "eidx"):
        _equal(getattr(pt, f), getattr(pj, f), f)
    assert (pt.nb, pt.Bd, pt.nv_pad, pt.D) == (pj.nb, pj.Bd, pj.nv_pad, pj.D)
    back = convert.halo_plan_from_numpy(_fields(pj))
    for f in ("T_local", "emask", "eidx"):
        _equal(getattr(back, f), getattr(pt, f), f)


@pytest.mark.parametrize("coarse", [False, True])
@pytest.mark.parametrize("D", SHARDS)
def test_vp_plan_equals_jax(beam, D, coarse):
    jm, cs, tm, tcs = beam
    pj = jvp.build_vp_plan(jm, D, coarse=cs if coarse else None)
    pt = vp.build_vp_plan(tm, D, coarse=tcs if coarse else None)
    for f in VP_FIELDS:
        _equal(getattr(pt, f), getattr(pj, f), f)
    for f in ("nb", "Bd", "D", "nv_pad", "dim", "naggr"):
        assert getattr(pt, f) == getattr(pj, f), f
    assert tuple(pt.models) == tuple(pj.models)
    back = convert.vp_plan_from_numpy(_fields(pj))
    for f in VP_FIELDS + (("pair_rows", "pair_cols", "pair_e") if coarse
                          else ()):
        _equal(getattr(back, f), getattr(pt, f), f)
    if coarse:
        # every element corner pair's aggregates, through the pair tables
        for r in range(D):
            real = pt.emask[r] > 0
            ae = pt.agg_e[r][real]
            pe = pt.pair_e[r][real]
            _equal(pt.pair_rows[pe], np.repeat(ae[:, :, None], 4, 2).astype(
                np.int64), "pair rows")
            _equal(pt.pair_cols[pe], np.repeat(ae[:, None, :], 4, 1).astype(
                np.int64), "pair cols")
            assert (pt.pair_e[r][~real] == len(pt.pair_rows)).all()


def test_vp_plan_refuses_a_deep_halo():
    jm, _ = small_beam(4, 2, 2)
    tm, _, _ = port(mesh=jm)
    with pytest.raises(ValueError, match="halo depth") as ej:
        jvp.build_vp_plan(jm, 8)
    with pytest.raises(ValueError, match="halo depth") as et:
        vp.build_vp_plan(tm, 8)
    assert str(et.value) == str(ej.value)
    with pytest.raises(ValueError, match="halo depth"):
        halo.build_halo_plan(tm, 8)


@pytest.mark.parametrize("shape,n", [((3, 1, 1), 4), ((3, 1, 1), 3),
                                     ((4, 1, 1), 3)])
def test_element_padding_equals_jax(shape, n):
    """15 tets over 4 ranks (1 pad), 15 over 3 (none) and 20 over 3 (1 pad):
    the ranks' slices, put end to end, are the JAX package's padded
    arrays, except that a padded element takes element 0's material where
    the JAX package pads zeros (parallel/sharding.py shard_mesh_data says
    why), and the state's s and la pad as its do."""
    from mixedfem_tpu.config import SimConfig
    from mixedfem_tpu.optimizer import newton as jnewton

    jm, V = small_beam(*shape)
    tm, _, _ = port(mesh=jm)
    jmesh = jsharding.make_device_mesh(n)
    jms, pad = jsharding.shard_mesh_data(jm, jmesh)
    assert pad == sharding.element_padding(jm.nelem, n)
    parts = [sharding.shard_mesh_data(tm, r, n)[0] for r in range(n)]
    for f in sharding.ELEM_FIELDS:
        got = np.concatenate([getattr(p, f).numpy() for p in parts])
        want = np.asarray(getattr(jms, f)).astype(got.dtype)
        if f in sharding.MATERIAL_FIELDS and pad:
            want[-pad:] = want[0]
        _equal(got, want, f)
    for p in parts:
        assert p.plan.nseg == tm.nv and p.plan.nrows == p.T.numel()
    config = SimConfig(h=0.01, dtype="float64")
    js = jnewton.init_state(jm, config, (), jnp.asarray(V), jnp.zeros_like(V))
    jss = jsharding.shard_sim_state(js, jmesh, pad)
    _, ts, _ = port(mesh=jm, state=js)
    for f in sharding.STATE_ELEM_FIELDS:
        got = np.concatenate([getattr(sharding.shard_sim_state(
            ts, r, n, pad), f).numpy() for r in range(n)])
        _equal(got, np.asarray(getattr(jss, f)), f)
    assert len(jax.devices("cpu")) >= n


@pytest.fixture(scope="module")
def grid():
    """tests/test_sharding_full_step.py's 9 x 4 x 3 box grid, both
    packages (the port's plan through convert.py)."""
    mesh, plan = _grid_setup(nx=9, ny=4, nz=3, dtype=jnp.float64)
    tm, _, _ = port(mesh=mesh)
    tplan = convert.stencil_plan_from_numpy(to_numpy(plan), "cpu")
    return mesh, plan, tm, tplan


@pytest.mark.parametrize("D", SHARDS)
def test_shard_plan_equals_jax(grid, D):
    mesh, plan, tm, tplan = grid
    sj = jss.build_shard_plan(plan, D)
    st = ss.build_shard_plan(tplan, D)
    for f in ("masks", "emask"):
        _equal(getattr(st, f), getattr(sj, f), f)
    for f in ("NI", "NJ", "NK", "nslots", "D", "Si", "Sc", "plane"):
        assert getattr(st, f) == getattr(sj, f), f
    assert st.terms == tuple(sj.terms)
    back = convert.shard_plan_from_numpy(_fields(sj))
    for f in ("masks", "emask"):
        _equal(getattr(back, f), getattr(st, f), f)
    _equal(ss.build_local_T(st, tm.T.numpy()), jss.build_local_T(sj, mesh.T),
           "build_local_T")
    _equal(ss.build_rest_rows(st, tm.V0.numpy()),
           jss.build_rest_rows(sj, mesh.V0), "build_rest_rows")
    _equal(ss.build_valid_rows(st), jss.build_valid_rows(sj), "valid rows")
    x = np.random.default_rng(D).standard_normal((tm.nv, 3))
    xs = ss.shard_vertex_field(st, torch.tensor(x))
    _equal(xs.numpy(), jss.shard_vertex_field(sj, jnp.asarray(x)), "slabs")
    _equal(ss.unshard_vertex_field(st, xs).numpy(), x, "round trip")
    _equal(ss.shard_vertex_rows_halo(st, torch.tensor(x)).numpy(),
           jss.shard_vertex_rows_halo(sj, jnp.asarray(x)), "halo rows")
    for mode in ("zero", "tile"):
        _equal(ss._pad_elem(st, tm.dphidX, mode).numpy(),
               jss._pad_elem(sj, mesh.dphidX, mode), mode)
    # each slab's own K6 table sees the global parity: its plain W of
    # random blocks equals the whole grid's W on the slab's planes
    Gw = torch.randn((tm.nelem, 6, 4, 3), dtype=torch.float64)
    W = stmod.assemble_W_plain(tplan, Gw, tm.mass_coeff).reshape(
        27, 3, 3, st.NI + 2, -1)
    Gw_sh, M_sh = ss.shard_element_rows(st, Gw), ss.shard_element_rows(
        st, tm.mass_coeff)
    for r in range(D):
        Wr = stmod.assemble_W_plain(ss.slab_plan(st, r, "cpu"), Gw_sh[r],
                                    M_sh[r]).reshape(27, 3, 3, st.Sc + 3, -1)
        # own planes 1..Si of the slab (the first without its left
        # neighbour's spill), inside the box
        lo, hi = r * st.Si, min((r + 1) * st.Si, st.NI)
        for i in range(lo + 1, hi):
            torch.testing.assert_close(Wr[:, :, :, 1 + i - lo], W[:, :, :, 1 + i],
                                       rtol=1e-12, atol=1e-12)

