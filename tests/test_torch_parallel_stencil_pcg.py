"""mixedfem_tpu_torch/parallel/stencil_shard.py's sharded_pcg (2 gloo ranks
on the CPU) against mixedfem_tpu/parallel/stencil_shard.py's on 2 virtual
CPU devices, float64: tests/test_stencil_shard.py's solve on the 9 x 4 x 3
grid (its perturbed coefficients, random rhs and block-Jacobi blocks) with block-Jacobi and
with block-Jacobi, to 1e-8 of scale with iteration counts within 2; and
the slab round trip."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

from mixedfem_tpu.parallel import stencil_shard as jss
from mixedfem_tpu.solvers import coarse as jcm
from mixedfem_tpu_torch import convert
from mixedfem_tpu_torch.parallel import launch, ranks

from parallel_parity import alongside
from test_stencil_shard import _setup
from torch_parity import one_torch_thread, to_numpy  # noqa: F401

D = 2


@pytest.fixture(scope="module", autouse=True)
def _one_thread(one_torch_thread):
    """Every test of this module runs on one torch intra-op thread."""


def _jax_sharded(sp, Gw, mass, b, fm, binv, kw):
    jmesh = Mesh(np.array(jax.devices("cpu")[:D]), ("x",))
    nv, d = b.shape
    b_sh = jss.shard_vertex_field(sp, b)
    fn = jax.jit(lambda *a: jss.sharded_pcg(sp, jmesh, *a, max_iters=400,
                                            tol=1e-10, **kw))
    x_sh, it, rel = fn(
        jss.shard_element_rows(sp, Gw), jss.shard_element_rows(sp, mass),
        b_sh, jnp.zeros_like(b_sh),
        jss.shard_vertex_field(sp, jnp.broadcast_to(fm[:, None], (nv, d))),
        jss.shard_vertex_field(sp, binv.reshape(nv, d * d)).reshape(
            sp.D, d, d, -1))
    return np.asarray(jss.unshard_vertex_field(sp, x_sh)), int(it)


def _binv(mesh, plan, coeffs):
    """tests/test_stencil_shard.py's block-Jacobi inverse blocks (nv, d, d)
    from W's centre plane, pinned rows the identity, masked."""
    from mixedfem_tpu.ops import stencil as jst
    from mixedfem_tpu.solvers import pcg as jpcg

    W = jst.assemble_W(plan, coeffs.Gw, mesh.mass_coeff)
    blocks = jst.diag_blocks(plan, W)
    maskv = mesh.free_mask[:, None, None]
    eye = jnp.eye(mesh.dim, dtype=blocks.dtype)
    return jpcg._small_inv(blocks * maskv + eye * (1.0 - maskv)) * maskv


def check_pcg(kind: str):
    """JAX's sharded_pcg, the single-device solve and the port's ranks with
    one preconditioner, 'bj' or 'two-level'."""
    mesh, plan, coeffs, b = _setup()
    sp = jss.build_shard_plan(plan, D)
    tsp = convert.shard_plan_from_numpy(
        {k: to_numpy(v) for k, v in sp._asdict().items()})
    fm = mesh.free_mask
    nv, d = b.shape
    cs = Aci = None
    kw, tkw = {}, {}
    if kind == "two-level":
        cs = jcm.build_coarse_space_grid(
            np.asarray(mesh.V0), np.asarray(mesh.T),
            ~np.asarray(mesh.free_mask, bool), (plan.NI, plan.NJ, plan.NK),
            block=2, dtype=jnp.float64)
        Aci = jcm.coarse_inverse(jcm.coarse_matrix(mesh, cs, coeffs))
        B = jcm._vert_modes(cs, fm, d)
        kw = dict(coarse_B_sh=jss.shard_vertex_field(
            sp, B.reshape(nv, d * 6)).reshape(sp.D, d, 6, -1),
            coarse_agg_sh=jss.shard_vertex_ints(sp, cs.agg_id, cs.naggr),
            naggr=cs.naggr, Ac_inv=Aci)
        tkw = dict(coarse_np=to_numpy(cs), Ac_inv=np.asarray(Aci))
    binv = _binv(mesh, plan, coeffs)
    out, (xj, itj) = alongside(
        lambda: launch.run_ranks(ranks.stencil_pcg, D, args=(
            tsp, np.asarray(coeffs.Gw), np.asarray(mesh.mass_coeff),
            np.asarray(b), np.asarray(binv), np.asarray(fm), 400, 1e-10),
            kwargs=tkw),
        lambda: _jax_sharded(sp, coeffs.Gw, mesh.mass_coeff, b, fm, binv, kw))
    scale = np.abs(xj).max()
    for x, it, rel in out:
        assert np.abs(x - xj).max() / scale < 1e-8
        assert abs(it - itj) <= 2, (it, itj)
        assert rel < 1e-10


def test_sharded_pcg_matches_jax():
    check_pcg("bj")


def test_slab_round_trip():
    import torch

    from mixedfem_tpu_torch.parallel import stencil_shard as ss

    mesh, plan, _coeffs, b = _setup()
    tplan = convert.stencil_plan_from_numpy(to_numpy(plan), "cpu")
    for n in (2, 3, 8):
        sp = ss.build_shard_plan(tplan, n)
        x = torch.tensor(np.asarray(b))
        assert torch.equal(ss.unshard_vertex_field(
            sp, ss.shard_vertex_field(sp, x)), x)
