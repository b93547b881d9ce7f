"""Shared helpers of the tests/test_torch_parallel_*.py files: JAX's
sharded steps on virtual CPU devices (one jit each, inputs from host
arrays so that it compiles once), the port's runs as entries of
mixedfem_tpu_torch.parallel.ranks.sequence, and the comparisons. The rank
targets themselves live in the port, so the ranks import no JAX."""

import dataclasses
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import torch
from jax.sharding import Mesh

from mixedfem_tpu.parallel import vp_step as jvp
from mixedfem_tpu_torch import convert
from mixedfem_tpu_torch.config import SimConfig as TConfig
from mixedfem_tpu_torch.mesh import mesh as tmesh
from mixedfem_tpu_torch.optimizer import newton
from mixedfem_tpu_torch.parallel import launch, ranks

from torch_parity import port, to_numpy

# tests/test_sharding_full_step.py's config; its 'exact' coarse inverse is
# the port's 'lu'
def alongside(port, jax_fn):
    """(port(), jax_fn()): the port's ranks (a run_ranks call) start in a
    thread and run while JAX compiles and steps here. The ranks are
    processes of their own, so the two overlap, and a file's time is the
    longer of the two, not their sum."""
    with ThreadPoolExecutor(1) as pool:
        got = pool.submit(port)
        want = jax_fn()
        return got.result(), want


STENCIL_CFG = dict(h=0.01, outer_steps=4, newton_tol=1e-12,
                   max_iterative_solver_iters=300, itr_tol=1e-10,
                   mixed_variables=("mixed-stretch",), dtype="float64",
                   coarse_inverse_method="lu")
VP_CFG = dict(h=0.02, outer_steps=3, itr_tol=1e-11,
              max_iterative_solver_iters=5000,
              mixed_variables=("mixed-stretch",), dtype="float64")


def jax_vp_steps(plan, config, x0, v0, steps, bdf=None, frames=None):
    """`steps` JAX vertex-partitioned steps on D virtual devices, one jit;
    each step's inputs start from host arrays, so the jit compiles once
    (for a given frame capacity). `frames(x_pad)` gives the ContactFrames
    of a step. Per step (x, v, iterations, cg total)."""
    from mixedfem_tpu.integrators import bdf as bdfmod

    jmesh = Mesh(jax.devices("cpu")[:plan.D], axis_names=("e",))
    step = jax.jit(lambda x, v, s, la, b, cf: jvp.vp_newton_step(
        plan, config, jmesh, x, v, s, la, bdf=b, cf=cf))
    x, v = jvp.pad_vertex_field(plan, x0), jvp.pad_vertex_field(plan, v0)
    s, la = jvp.init_vp_state(plan, x)
    b = None if bdf is None else bdfmod.bdf_init(bdf, x, v, config.h)
    out = []
    for _ in range(steps):
        cf = None if frames is None else frames(np.asarray(x))
        x, v, s, la, it, _dec, cg = (np.asarray(a) for a in step(
            jnp.asarray(x), jnp.asarray(v), jnp.asarray(s), jnp.asarray(la), b,
            cf))
        if b is not None:
            b = bdfmod.bdf_update(b, jnp.asarray(x))
        out.append((x, v, int(it), int(cg)))
    return out


def plan_fields(plan) -> dict:
    return {k: to_numpy(v) for k, v in plan._asdict().items()}


def vp_call(plan, config, x0, v0, steps=2, **kw):
    """A (target, args, kwargs) entry of ranks.sequence for the port."""
    xp = np.pad(np.asarray(x0), ((0, plan.nv_pad - len(x0)), (0, 0)))
    vpd = np.pad(np.asarray(v0), ((0, plan.nv_pad - len(v0)), (0, 0)))
    return (ranks.vp_steps, (plan, config, xp, vpd, steps), kw)


def assemble(rank_outs, k, nv, key="x"):
    return np.concatenate([r[k][key] for r in rank_outs])[:nv]


def check(port_runs, jax_runs, nv, tol=1e-8, cg_band=0.02):
    """The port's ranks' runs against JAX's steps: positions to `tol` of
    scale, Newton counts equal, CG totals within `cg_band`, and every rank
    with the same counts."""
    scale = max(np.abs(jax_runs[-1][0][:nv]).max(), 1e-12)
    for k, (xj, _vj, itj, cgj) in enumerate(jax_runs):
        x = assemble(port_runs, k, nv)
        err = np.abs(x - xj[:nv]).max() / scale
        assert err < tol, (k, err)
        assert port_runs[0][k]["iterations"] == itj
        cg = port_runs[0][k]["cg"]
        assert abs(cg - cgj) <= cg_band * cgj, (k, cg, cgj)
        for r in port_runs[1:]:
            assert r[k]["iterations"] == port_runs[0][k]["iterations"]
            assert r[k]["cg"] == cg


def port_small_beam():
    """tests/test_newton.py's small_beam(32, 2, 2), built by the port."""
    from mixedfem_tpu_torch.config import enu_to_lame
    from mixedfem_tpu_torch.mesh import generators

    V, T = generators.box_tet_mesh(32, 2, 2, size=(2.0, 0.5, 0.5))
    la, mu = enu_to_lame(1e6, 0.45)
    mesh = tmesh.build_mesh_data(
        V, T, density=np.full(len(T), 1000.0), mu=np.full(len(T), mu),
        lam=np.full(len(T), la), model_id=np.zeros(len(T), int),
        models=("Stable-Neohookean",), is_fixed=V[:, 0] < 1e-9,
        ext_force=np.tile([0.0, -9.8, 0.0], (len(V), 1)), device="cpu")
    return mesh, V


def port_drop_mesh():
    """tests/test_vp_contact.py's drop mesh, built by the port: a banded
    beam fixed at both ends and a box above its middle; (mesh, V, beam
    vertex count)."""
    from mixedfem_tpu_torch.config import enu_to_lame
    from mixedfem_tpu_torch.mesh import generators

    Vb, Tb = generators.box_tet_mesh(24, 2, 2, size=(2.4, 0.2, 0.2))
    Vx, Tx = generators.box_tet_mesh(1, 1, 1, size=(0.12, 0.12, 0.12))
    V = np.concatenate([Vb, Vx + np.array([1.14, 0.04, 0.225])])
    T = np.concatenate([Tb, Tx + len(Vb)])
    la, mu = enu_to_lame(1e5, 0.45)
    fixed = (V[:, 0] < 1e-9) | (np.abs(V[:, 0] - 2.4) < 1e-9)
    mesh = tmesh.build_mesh_data(
        V, T, density=np.full(len(T), 1000.0), mu=np.full(len(T), mu),
        lam=np.full(len(T), la), model_id=np.zeros(len(T), int),
        models=("Stable-Neohookean",), is_fixed=fixed,
        ext_force=np.tile([0.0, 0.0, -9.8], (len(V), 1)), device="cpu")
    return mesh, V, len(Vb)


def single_device(mesh, config, V, steps=2, v0=None, contact=None):
    """The port's single-device newton_step from V (at rest, or at v0):
    per step (x, Newton count). With `contact` (as ranks.vp_steps takes
    it) the candidates are rebuilt from the positions before each step, as
    the vertex-partitioned ranks rebuild them."""
    from mixedfem_tpu_torch.variables import mixed_collision as mcol

    v0 = np.zeros_like(V) if v0 is None else v0
    st = newton.init_state(mesh, config, (), torch.tensor(V),
                           torch.tensor(v0, dtype=torch.float64))
    out = []
    for _ in range(steps):
        if contact is not None:
            f, t, k = ranks.candidates(st.x.numpy(), contact)
            st = dataclasses.replace(st, contact=mcol.contact_frames(
                f, t, k, mesh.nv, torch.float64, "cpu"))
        st = newton.newton_step(mesh, config, (), st)
        out.append((st.x.numpy(), st.stats.iterations))
    return out


def check_ranks(got, want, nv, tols=(1e-8, 1e-7)):
    """The ranks' runs against single_device's steps: positions to tols[k]
    of scale after step k (by default tests/test_sharding.py's vp
    tolerances, 1e-8 after one step and 1e-7 after two), Newton counts
    equal on every rank."""
    scale = np.abs(want[-1][0]).max()
    for k, (x_ref, it_ref) in enumerate(want):
        err = np.abs(assemble(got, k, nv) - x_ref).max() / scale
        assert err < tols[k], (k, err)
        assert all(g[k]["iterations"] == it_ref for g in got)


def check_steps(got, want, tol, cg_band):
    """Every rank's steps against `want`: positions to `tol` of scale,
    Newton counts equal, CG counts within `cg_band` (a fraction, or a count
    when >= 1) except in the last Newton iteration, whose rhs sits at the
    rounding floor and whose count is summation order's to decide (as
    tests/test_sharding_full_step.py treats it)."""
    scale = max(np.abs(want[-1][0]).max(), 1e-12)
    for k, (x, it, cg) in enumerate(want):
        band = cg_band if cg_band >= 1 else np.ceil(cg_band * cg[:-1])
        for rank_runs in got:
            g = rank_runs[k]
            err = np.abs(g["x"] - x).max() / scale
            assert err < tol, (k, err)
            assert g["iterations"] == it
            assert np.all(np.abs(g["solver_iters"][:-1] - cg[:-1]) <= band), (
                g["solver_iters"], cg)


def jax_stencil_steps(mesh, plan, config, state, coarse, D, steps):
    """`steps` JAX sharded stencil steps (parallel/stencil_shard.py
    sharded_newton_step) on D virtual devices, under one jit whose input
    is a host copy of the state each step: per step (x, s, iterations,
    CG counts)."""
    from mixedfem_tpu.parallel import stencil_shard as jss

    jmesh = Mesh(np.array(jax.devices("cpu")[:D]), ("x",))
    sp = jss.build_shard_plan(plan, D)
    step = jax.jit(lambda st: jss.sharded_newton_step(sp, jmesh, mesh, config,
                                                      st, coarse=coarse))
    out = []
    for _ in range(steps):
        state = jax.tree.map(lambda a: jnp.asarray(np.asarray(a)),
                             step(state))
        it = int(state.stats.iterations)
        out.append((np.asarray(state.x), np.asarray(state.s), it,
                    np.asarray(state.stats.solver_iters)[:it]))
    return out


def check_stencil(got, want, tol, cg_band):
    """check_steps on the sharded stencil runs, and their stretch to `tol`
    (absolute, as tests/test_sharding_full_step.py holds it)."""
    check_steps(got, [(x, it, cg) for x, _s, it, cg in want], tol, cg_band)
    for k, (_x, s, _it, _cg) in enumerate(want):
        for rank_runs in got:
            assert np.abs(rank_runs[k]["s"] - s).max() < tol, k


def stencil_run_both(coarse: bool, D: int = 2):
    """JAX's and the port's 2 sharded stencil steps on D ranks from rest,
    on tests/test_sharding_full_step.py's grid (its _setup)."""
    from test_sharding_full_step import _setup

    mesh, plan, config, state, cs = _setup(coarse=coarse)
    V = np.asarray(mesh.V0)
    return alongside(
        lambda: launch.run_ranks(ranks.stencil_steps, D, args=(
            to_numpy(mesh), to_numpy(plan),
            None if cs is None else to_numpy(cs), TConfig(**STENCIL_CFG), V,
            np.zeros_like(V), 2)),
        lambda: jax_stencil_steps(mesh, plan, config, state, cs, D, 2))


def stencil_vs_single(D: int, coarse: bool):
    """The port's sharded stencil step on D ranks against its single-device
    step with the StencilPlan, 2 steps of
    tests/test_sharding_full_step.py's grid (its _setup)."""
    from mixedfem_tpu_torch.solvers import coarse as tcm
    from test_sharding_full_step import _setup

    mesh, plan, _config, _state, _cs = _setup()
    tm, _, _ = port(mesh=mesh)
    tplan = convert.stencil_plan_from_numpy(to_numpy(plan), "cpu")
    V = tm.V0.numpy()
    cfg = TConfig(**STENCIL_CFG)
    cs = None
    if coarse:
        cs = tcm.build_coarse_space_grid(
            V, tm.T.numpy(), V[:, 0] < 1e-9, (plan.NI, plan.NJ, plan.NK),
            block=2, dtype=torch.float64, device="cpu")
    st = newton.init_state(tm, cfg, (), tm.V0, torch.zeros_like(tm.V0))
    want = []
    for _ in range(2):
        st = newton.newton_step(tm, cfg, (), st, cs, (), tplan)
        it = st.stats.iterations
        want.append((st.x.numpy(), st.s.numpy(), it,
                     st.stats.solver_iters[:it].numpy()))
    got = launch.run_ranks(ranks.stencil_steps, D, args=(
        convert.mesh_to_numpy(tm), convert.stencil_plan_to_numpy(tplan),
        None if cs is None else convert.coarse_to_numpy(cs), cfg, V,
        np.zeros_like(V), 2))
    check_stencil(got, want, 1e-8, 2)


# tests/test_vp_contact.py's config
CONTACT_CFG = dict(h=0.01, outer_steps=4, itr_tol=1e-11,
                   max_iterative_solver_iters=20000,
                   mixed_variables=("mixed-stretch", "mixed-collision"),
                   dtype="float64", dhat=0.05, kappa=100.0)


def vp_contact_vs_single(D: int):
    """The port's vertex-partitioned step with contact on D ranks against
    its single-device step, 2 steps of the drop scene (port_drop_mesh),
    candidates within dhat rebuilt from the positions before each step on
    both sides: check_ranks' tolerances, some frames active, and some
    candidate frame with corners on two ranks at the start."""
    from mixedfem_tpu_torch.parallel import vp_step as vp

    mesh, V, nbeam = port_drop_mesh()
    v0 = np.zeros_like(V)
    v0[nbeam:, 2] = -1.0
    contact = dict(F_srf=mesh.F_srf.numpy(), E_srf=mesh.E_srf.numpy(),
                   margin=CONTACT_CFG["dhat"], nv=mesh.nv)
    cfg = TConfig(**CONTACT_CFG)
    plan = vp.build_vp_plan(mesh, D)
    f, _t, m = ranks.candidates(V, contact)
    owner = f[: int((m > 0).sum())] // plan.nb
    assert (owner.min(1) != owner.max(1)).any(), "no frame spans two ranks"
    got, want = alongside(
        lambda: launch.run_ranks(ranks.sequence, D, args=(
            [vp_call(plan, cfg, V, v0, contact=contact)],)),
        lambda: single_device(mesh, cfg, V, v0=v0, contact=contact))
    got = [o[0] for o in got]
    check_ranks(got, want, mesh.nv)
    assert max(o["frames"] for o in got[0]) > 0

