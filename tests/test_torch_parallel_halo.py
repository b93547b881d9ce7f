"""The halo-exchange matvec of mixedfem_tpu_torch/parallel/halo.py on 2
gloo ranks on the CPU against mixedfem_tpu/parallel/halo.py on 2 virtual
CPU devices and against the single-device operator (to 1e-12 of scale, in
float64), and the element-sharded step's refusals of what it does not
cover (newton_step with a comm, before any collective)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mixedfem_tpu.config import SimConfig as JConfig
from mixedfem_tpu.integrators import bdf as jbdf
from mixedfem_tpu.parallel import halo as jhalo
from mixedfem_tpu.parallel import sharding as jsharding
from mixedfem_tpu.solvers import operator as jop
from mixedfem_tpu.variables import mixed_stretch as jms
from mixedfem_tpu_torch import convert
from mixedfem_tpu_torch.config import SimConfig as TConfig
from mixedfem_tpu_torch.mesh import mesh as tmesh
from mixedfem_tpu_torch.optimizer import newton as tnewton
from mixedfem_tpu_torch.parallel import launch, ranks

from parallel_parity import alongside
from test_newton import make_state, small_beam
from torch_parity import (  # noqa: F401 (one_torch_thread is a fixture)
    one_torch_thread, port, to_numpy, tri_arrays,
)

CFG = dict(h=0.01, outer_steps=4, itr_tol=1e-10, dtype="float64",
           mixed_variables=("mixed-stretch",))


@pytest.fixture(scope="module", autouse=True)
def _one_thread(one_torch_thread):
    """Every test of this module runs on one torch intra-op thread."""


def test_halo_matvec_matches_jax():
    mesh, V = small_beam(24, 3, 3)
    config = JConfig(h=0.01, outer_steps=1, dtype="float64")
    state = make_state(mesh, config)
    coeffs = jms.update(mesh, state.x, state.s, jbdf.bdf_dt(state.bdf))
    jmesh = jsharding.make_device_mesh(2)
    plan = jhalo.build_halo_plan(mesh, 2)
    rng = np.random.default_rng(0)
    p = np.zeros((plan.nv_pad, 3))
    p[: mesh.nv] = rng.standard_normal((mesh.nv, 3))
    tplan = convert.halo_plan_from_numpy(
        {k: to_numpy(v) for k, v in plan._asdict().items()})
    got, want = alongside(
        lambda: launch.run_ranks(ranks.halo_matvec, 2, args=(
            to_numpy(mesh), tplan, np.asarray(coeffs.Gw), p)),
        lambda: np.asarray(jax.jit(lambda q: jhalo.halo_matvec(
            mesh, plan, coeffs, jmesh, q))(jnp.asarray(p))))
    got = np.concatenate(got)
    ref = np.asarray(jop.element_matvec(mesh, jnp.asarray(p[: mesh.nv]),
                                        ms_coeffs=coeffs))
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12 * scale)
    np.testing.assert_allclose(got[: mesh.nv], ref, rtol=0,
                               atol=1e-12 * scale)


def test_element_sharded_step_refusals():
    """The element-sharded step refuses two things, before any collective:
    a StencilPlan (NotImplementedError pointing at
    parallel/stencil_shard.py) and a per-element field that is not the
    rank's slice (ValueError: the whole mesh's warm-started rotations on a
    rank's slice of the elements). A plan that parallel/sharding.py did
    not make, whose sums are not followed by the psum, raises ValueError.
    What it refused before it covered them (other solvers, a banded plan,
    contact, f64 islands, warm-started rotations, the vanilla stretch, 2D
    meshes, shells and rods) passes its check."""
    from mixedfem_tpu_torch.ops import assembly
    from mixedfem_tpu_torch.ops import stencil as tst
    from mixedfem_tpu_torch.parallel import sharding
    from mixedfem_tpu_torch.solvers import operator as top
    from mixedfem_tpu_torch.variables import mixed_collision as tmc

    mesh, V = small_beam(2, 1, 1)
    tm, ts, _ = port(mesh=mesh, state=make_state(mesh, JConfig(**CFG)))
    no_comm = object()   # the checks run before the comm is used
    plan, _ = tst.build_stencil_plan(tm.T.numpy(), tm.nv, (3, 2, 2),
                                     device="cpu")
    with pytest.raises(NotImplementedError, match="stencil_shard.py"):
        tnewton.newton_step(tm, TConfig(**CFG), (), ts, comm=no_comm,
                            matvec_plan=plan)
    warm = TConfig(**dict(CFG, rotation_warm_start=True))
    tsw = tnewton.init_state(tm, warm, (), tm.V0, torch.zeros_like(tm.V0))
    def psum(t):
        return t

    half, _ = sharding.shard_mesh_data(tm, 0, 2, reduce=psum)
    with pytest.raises(ValueError, match="R holds"):
        tnewton.newton_step(half, warm, (), tsw, comm=no_comm)
    with pytest.raises(ValueError, match="parallel/sharding.py"):
        tnewton.newton_step(tm, TConfig(**CFG), (), ts, comm=no_comm)
    cf = tmc.contact_frames(np.array([[0, 1, 2, 3]]), np.array([0]),
                            np.array([1.0]), tm.nv, torch.float64, "cpu")
    V2, T2, kw2, _ = tri_arrays(4, 2)
    tm2 = tmesh.build_mesh_data(V2, T2, device="cpu", **kw2)
    ts2 = tnewton.init_state(tm2, TConfig(**CFG), (), tm2.V0,
                             torch.zeros_like(tm2.V0))
    whole, _ = sharding.shard_mesh_data(tm, 0, 1, reduce=psum)
    with pytest.raises(ValueError, match="parallel/sharding.py"):
        tnewton.check_sharded(whole, top.build_banded_plan(tm), ts)
    whole2, _ = sharding.shard_mesh_data(tm2, 0, 1, reduce=psum)
    banded = assembly.with_reduce(top.build_banded_plan(tm), psum)
    for m, p, st in ((whole, banded, ts),
                     (whole, None, dataclasses.replace(ts, contact=cf)),
                     (whole, None, tsw), (whole2, None, ts2)):
        tnewton.check_sharded(m, p, st)
    assert len(jax.devices("cpu")) >= 2
