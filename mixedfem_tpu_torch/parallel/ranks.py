"""Rank targets of the sharded paths: module-level functions that
parallel/launch.py run_ranks starts, one per rank. Each takes host values
(numpy arrays, the dicts of convert.py, the host plans, a SimConfig),
builds its rank's share on its comm's device, runs, and returns numpy
arrays and plain values. The CPU tests, dryrun_multichip and chip_smoke.py
drive the sharded paths through them.

Timed runs synchronize the device around each step; `launches` are the
rank's kernel launches (cuda.LAUNCHES) of the step, `comm_*` its
collectives' host milliseconds, bytes sent and calls, `transport` the
comm's (parallel/comm.py).
"""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from mixedfem_tpu_torch import convert, cuda
from mixedfem_tpu_torch.integrators import bdf as bdfmod
from mixedfem_tpu_torch.optimizer import newton
from mixedfem_tpu_torch.parallel import halo as halomod
from mixedfem_tpu_torch.parallel import sharding
from mixedfem_tpu_torch.parallel import stencil_shard as ss
from mixedfem_tpu_torch.parallel import vp_step as vp

_DTYPES = {"float32": torch.float32, "float64": torch.float64}


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _timed(comm, step):
    """step() with the rank's wall ms, launches and collective stats."""
    _sync(comm.device)
    cuda.clear_launches()
    comm.clear_stats()
    t0 = time.perf_counter()
    out = step()
    _sync(comm.device)
    ms = (time.perf_counter() - t0) * 1e3
    return out, dict(ms=ms, launches=dict(cuda.LAUNCHES),
                     comm_ms=comm.stats["ms"], comm_bytes=comm.stats["bytes"],
                     comm_calls=comm.stats["calls"], transport=comm.transport)


def sequence(comm, calls):
    """Several targets in one process group: [fn(comm, *args, **kw) for
    (fn, args, kw) in calls], each fn a target of this module."""
    return [fn(comm, *args, **kw) for fn, args, kw in calls]


def comm_probe(comm, skip_rank=None):
    """The collectives on rank-seeded values: (the rank's values, psum,
    pmax, shift +1, shift -1, all_gather), numpy; the rank `skip_rank`
    returns at once without taking part."""
    g = torch.Generator().manual_seed(100 + comm.rank)
    t = torch.randn((5, 3), generator=g, dtype=torch.float64).to(comm.device)
    if comm.rank == skip_rank:
        return None
    out = [t, comm.psum(t), comm.pmax(t), comm.shift(t, 1), comm.shift(t, -1),
           torch.stack(comm.all_gather(t))]
    return [o.cpu().numpy() for o in out]


def halo_matvec(comm, mesh_np, plan, Gw, p_pad, dtype="float64"):
    """parallel/halo.py halo_matvec of the padded p: this rank's rows."""
    dt, dev = _DTYPES[dtype], comm.device
    mesh = convert.mesh_from_numpy(mesh_np, dt, dev)
    rh = halomod.rank_halo(plan, comm.rank, dt, dev)
    rows = slice(comm.rank * plan.nb, (comm.rank + 1) * plan.nb)
    fm = vp.pad_vertex_field(plan, mesh.free_mask[:, None])[rows, 0]
    p = torch.tensor(p_pad[rows], dtype=dt, device=dev)
    out = halomod.halo_matvec(comm, rh, mesh.mass_coeff,
                              torch.tensor(Gw, dtype=dt, device=dev), fm, p)
    return out.cpu().numpy()


def element_sharded_steps(comm, mesh_np, coarse_np, config, x0, v0,
                          steps: int, warmup: int = 0):
    """`warmup` then `steps` element-sharded newton_step calls of this
    rank from (x0, v0) (optimizer/newton.py with a comm): per timed step
    the positions, the stretch gathered over the ranks, the Newton and CG
    counts, the energies and the rank's figures (_timed)."""
    dt, dev = _DTYPES[config.dtype], comm.device
    mesh, _, coarse = convert.from_jax_numpy(mesh_np, None, coarse_np,
                                             dtype=dt, device=dev)
    x0 = torch.tensor(x0, dtype=dt, device=dev)
    state = newton.init_state(mesh, config, (), x0,
                              torch.tensor(v0, dtype=dt, device=dev))
    E = mesh.nelem
    lmesh, lstate, lcoarse = sharding.shard_simulation(mesh, state, comm,
                                                       coarse)
    out = []
    for k in range(warmup + steps):
        lstate, fig = _timed(comm, lambda: newton.newton_step(
            lmesh, config, (), lstate, lcoarse, comm=comm))
        if k < warmup:
            continue
        it = lstate.stats.iterations
        out.append(dict(
            x=lstate.x.cpu().numpy(),
            s=sharding.gather_elements(comm, lstate.s, E).cpu().numpy(),
            iterations=it,
            solver_iters=lstate.stats.solver_iters[:it].cpu().numpy(),
            energy=lstate.stats.energy[:it].cpu().numpy(),
            decrement=float(lstate.stats.decrement[it - 1]), **fig))
    return out


def build_simulation(mesh_np, config, x0, v0, dev, coarse_np=None,
                     banded: bool = False, gs: bool = False, press=(),
                     power_v0=None):
    """A Simulation (io/scene.py) of the whole mesh on `dev` from host
    values: the mesh dict (convert.py), a SimConfig, the start (x0, v0),
    and optionally a coarse space dict, a banded plan (`banded`), the
    vertex coloring of 'gauss-seidel' (`gs`), press controllers (pairs of
    convert.py's spec and state dicts) and the Laplacian preconditioner's
    power-iteration start vector."""
    from mixedfem_tpu_torch.io.scene import Simulation
    from mixedfem_tpu_torch.solvers import gauss_seidel as gsmod
    from mixedfem_tpu_torch.solvers import operator as opmod

    dt = _DTYPES[config.dtype]
    mesh, _, coarse = convert.from_jax_numpy(mesh_np, None, coarse_np,
                                             dtype=dt, device=dev)
    specs = tuple(convert.press_spec_from_numpy(p, dt, dev) for p, _ in press)
    pstates = tuple(convert.press_state_from_numpy(st) for _, st in press)
    state = newton.init_state(mesh, config, (),
                              torch.tensor(x0, dtype=dt, device=dev),
                              torch.tensor(v0, dtype=dt, device=dev),
                              press_states=pstates)
    if power_v0 is not None:
        state.power_v0 = convert.power_start_from_numpy(power_v0, dt, dev)
    gs_plan = None
    if gs:
        gs_plan = gsmod.build_gs_plan(mesh.T.cpu().numpy(), mesh.nv, dtype=dt,
                                      device=dev)
    return Simulation(
        mesh=mesh, config=config, bc_specs=(), state=state, dim=mesh.dim,
        obj_slices=[], coarse=coarse, press_specs=specs,
        matvec_plan=opmod.build_banded_plan(mesh) if banded else None,
        gs_plan=gs_plan)


def _frames_np(state) -> np.ndarray:
    """The real candidate frames of a state's contact set, (n, 4) host."""
    return state.contact.real()[0].cpu().numpy()


def step_record(sim, E: int, fig: dict, comm=None) -> dict:
    """One step's record of a Simulation (a rank's with `comm`): the
    positions, the stretch gathered over the ranks, the Newton and solver
    counts, the merit at the base point and the recorded vanilla gradient
    norm of every Newton iteration, the decrement, the most active contact frames of a Newton iteration, the
    candidate frames, the retries and the figures (_timed)."""
    st = sim.state
    it = st.stats.iterations
    s = st.s if comm is None else sharding.gather_elements(comm, st.s, E)
    return dict(x=st.x.cpu().numpy(), s=s.cpu().numpy(), iterations=it,
                solver_iters=st.stats.solver_iters[:it].cpu().numpy(),
                energy=st.stats.energy[:it].cpu().numpy(),
                vanilla_grad=st.stats.vanilla_grad[:it].cpu().numpy(),
                decrement=float(st.stats.decrement[it - 1]),
                active=int(st.stats.active_frames[:it].max()),
                frames=_frames_np(st), retries=sim.retries, **fig)


class LineSearchTrace:
    """Every line search of the on-device steps run inside it
    (newton._line_search wrapped, for a diagnosis): per search the base
    merit E, the acceptance threshold, the CCD bound alpha0, each
    (alpha, merit(alpha)) tried and the (alpha, accepted) it returned.
    The merit values are the ones the search computes; none is added."""

    def __init__(self):
        self.records = []

    def __enter__(self):
        self._search = search = newton._line_search

        def traced(E, eps_E, ls_iters, merit, alpha0=1.0):
            tried = []

            def logged(a):
                m = merit(a)
                tried.append((float(a), float(m)))
                return m

            alpha, accept = search(E, eps_E, ls_iters, logged, alpha0)
            thresh = E + eps_E * E.abs() if eps_E else E
            self.records.append(dict(E=float(E), thresh=float(thresh),
                                     alpha0=float(alpha0), tried=tried,
                                     alpha=float(alpha), accept=accept))
            return alpha, accept

        newton._line_search = traced
        return self

    def __exit__(self, *exc):
        newton._line_search = self._search

    def take(self, sim) -> list:
        """The records since the last take, each with its Newton
        iteration's decrement, CG count and error, active frames and least
        distance from `sim`'s last step."""
        st = sim.state.stats
        # a contact step re-run with a wider margin searched before too
        recs = self.records[len(self.records) - st.iterations:]
        self.records = []
        for i, r in enumerate(recs):
            r.update(decrement=float(st.decrement[i]),
                     cg=int(st.solver_iters[i]),
                     cg_err=float(st.solver_error[i]),
                     active=int(st.active_frames[i]),
                     min_distance=float(st.min_distance[i]))
        return recs


def _sim_steps(comm, sim, steps: int, warmup: int, trace: bool = False):
    """`warmup` then `steps` Simulation.step calls of `sim` (a rank's
    share of it, sharding.shard_scene, with a comm): per timed step
    step_record's dict, its `broadphase_ms` the step's own, and with
    `trace` its LineSearchTrace records under 'line_search'."""
    E = sim.mesh.nelem
    if comm is not None:
        sim = sharding.shard_scene(sim, comm)
    out = []
    with (LineSearchTrace() if trace else contextlib.nullcontext()) as tr:
        for k in range(warmup + steps):
            bp0 = sim.broadphase_ms
            if comm is None:
                t0 = time.perf_counter()
                sim.step()
                _sync(sim.state.x.device)
                fig = dict(ms=(time.perf_counter() - t0) * 1e3)
            else:
                _, fig = _timed(comm, sim.step)
            searches = tr.take(sim) if trace else None
            if k >= warmup:
                rec = step_record(sim, E, fig, comm)
                rec["broadphase_ms"] = sim.broadphase_ms - bp0
                if trace:
                    rec["line_search"] = searches
                out.append(rec)
    return out


def simulation_steps(comm, mesh_np, config, x0, v0, steps: int,
                     warmup: int = 0, trace: bool = False, device=None,
                     **build):
    """`warmup` then `steps` element-sharded Simulation.step calls of this
    rank (parallel/sharding.py shard_scene over build_simulation(...,
    **build)): the step of every solver, with contact (the broadphase
    on every rank over the whole positions), the banded plan, the host
    solvers and press controllers. Per timed step step_record's dict (with
    `trace`, its line searches). With comm=None, the unsharded
    Simulation.step on `device`."""
    dev = comm.device if comm is not None else torch.device(device)
    return _sim_steps(comm, build_simulation(mesh_np, config, x0, v0, dev,
                                             **build), steps, warmup, trace)


def scene_steps(comm, path: str, dim: int, dtype: str, steps: int,
                warmup: int = 0, overrides=None):
    """`warmup` then `steps` element-sharded Simulation.step calls of this
    rank's share of the scene file `path` (io/scene.py load_scene on the
    rank's device: on the card with its banded order, banded plan and
    coarse space). Per timed step step_record's dict."""
    from mixedfem_tpu_torch.io.scene import load_scene

    sim = load_scene(path, dim=dim, dtype=dtype, overrides=overrides,
                     device=comm.device)
    return _sim_steps(comm, sim, steps, warmup)


class _Frames:
    """The frames of one step: frames (C, 4), ftype, fmask on a device."""

    def __init__(self, frames, ftype, fmask, dtype, device):
        self.frames = torch.as_tensor(frames, device=device)
        self.ftype = torch.as_tensor(ftype, device=device)
        self.fmask = torch.tensor(fmask, dtype=dtype, device=device)


def candidates(x, contact):
    """The padded candidate set at positions x (host), as the JAX package's
    vertex-partitioned contact test builds it: candidates_3d over the
    surface with `margin`, padded to the next power of two."""
    from mixedfem_tpu_torch.collision import broadphase as bp

    F_srf, E_srf = contact["F_srf"], contact["E_srf"]
    surf = np.unique(F_srf.reshape(-1))
    frames, types = bp.candidates_3d(x, F_srf, E_srf, surf, contact["margin"])
    cap = 1 << int(np.ceil(np.log2(max(len(frames), 2))))
    return bp.pad_candidates(frames, types, cap)


def vp_steps(comm, plan, config, x0_pad, v0_pad, steps: int, warmup: int = 0,
             bdf_name=None, contact=None, repeat: bool = False):
    """`warmup` then `steps` vertex-partitioned steps of this rank from
    the padded (x0, v0), the stretch at rest (init_vp_state): per timed
    step the rank's rows of x (and of v), the Newton count, the decrement,
    the CG total and the rank's figures. `bdf_name` runs that integrator
    over the rank's rows; `contact` (F_srf, E_srf, margin, nv) rebuilds the
    candidates from the gathered positions before every step. With
    `repeat` the whole run is made twice from the same start and
    'repeat_equal' says whether the second gave the same bits."""
    dt, dev = _DTYPES[config.dtype], comm.device
    rp = vp.rank_vp_plan(plan, comm.rank, dev)
    rows = slice(comm.rank * plan.nb, (comm.rank + 1) * plan.nb)
    s0, la0 = vp.init_vp_state(plan)

    def run():
        x = torch.tensor(x0_pad[rows], dtype=dt, device=dev)
        v = torch.tensor(v0_pad[rows], dtype=dt, device=dev)
        s = torch.tensor(s0[comm.rank], dtype=dt, device=dev)
        la = torch.tensor(la0[comm.rank], dtype=dt, device=dev)
        bdf = None if bdf_name is None else bdfmod.bdf_init(bdf_name, x, v,
                                                            config.h)
        out = []
        for k in range(warmup + steps):
            cf = None
            if contact is not None:
                xg = torch.cat(comm.all_gather(x))[:contact["nv"]]
                cf = _Frames(*candidates(xg.cpu().numpy().astype(np.float64),
                                          contact), dt, dev)
            (x, v, s, la, it, dec, cg), fig = _timed(
                comm, lambda: vp.vp_newton_step(rp, config, comm, x, v, s, la,
                                                bdf=bdf, cf=cf))
            if bdf is not None:
                bdf = bdfmod.bdf_update(bdf, x)
            if k >= warmup:
                out.append(dict(x=x.cpu().numpy(), v=v.cpu().numpy(),
                                iterations=it, decrement=dec, cg=cg,
                                frames=0 if cf is None else
                                int((cf.fmask > 0).sum()), **fig))
        return out

    out = run()
    if repeat:
        again = run()
        same = all(np.array_equal(a["x"], b["x"]) for a, b in zip(out, again))
        for o in out:
            o["repeat_equal"] = same
    return out


def stencil_steps(comm, mesh_np, plan_np, coarse_np, config, x0, v0,
                  steps: int, warmup: int = 0, repeat: bool = False):
    """`warmup` then `steps` sharded stencil steps of this rank (its I-slab
    of the box grid: mesh_np in cell-major order, plan_np the
    StencilPlan's dict, coarse_np a grid coarse space or None) from
    (x0, v0): per timed step the positions, the stretch, the Newton and
    CG counts, the rank's figures and `slab_ms`, the host ms of its
    static slab data (rank_slab, built once before the steps). With
    `repeat`, as in vp_steps."""
    dt, dev = _DTYPES[config.dtype], comm.device
    mesh, _, coarse = convert.from_jax_numpy(mesh_np, None, coarse_np,
                                             dtype=dt, device=dev)
    sp = ss.build_shard_plan(convert.stencil_plan_from_numpy(plan_np, "cpu"),
                             comm.size)
    t0 = time.perf_counter()
    slab = ss.rank_slab(sp, mesh, comm.rank, coarse)
    _sync(dev)
    slab_ms = (time.perf_counter() - t0) * 1e3

    def run():
        state = newton.init_state(mesh, config, (),
                                  torch.tensor(x0, dtype=dt, device=dev),
                                  torch.tensor(v0, dtype=dt, device=dev))
        out = []
        for k in range(warmup + steps):
            state, fig = _timed(comm, lambda: ss.sharded_newton_step(
                sp, comm, slab, mesh, config, state, coarse))
            if k >= warmup:
                it = state.stats.iterations
                out.append(dict(
                    x=state.x.cpu().numpy(), s=state.s.cpu().numpy(),
                    iterations=it,
                    solver_iters=state.stats.solver_iters[:it].cpu().numpy(),
                    decrement=float(state.stats.decrement[it - 1]),
                    slab_ms=slab_ms, **fig))
        return out

    out = run()
    if repeat:
        again = run()
        same = all(np.array_equal(a["x"], b["x"]) for a, b in zip(out, again))
        for o in out:
            o["repeat_equal"] = same
    return out


def stencil_pcg(comm, sp, Gw, mass, b, binv, free_mask, max_iters, tol,
                coarse_np=None, Ac_inv=None, dtype="float64"):
    """parallel/stencil_shard.py sharded_pcg from whole-mesh inputs (Gw,
    mass per element in cell-major order, b (nv, d), the block-Jacobi
    inverse blocks (nv, d, d), the free mask (nv,)): (the solution
    (nv, d) gathered, iterations, rel_residual)."""
    dt, dev = _DTYPES[dtype], comm.device
    r = comm.rank

    def f(a):
        return torch.tensor(np.asarray(a), dtype=dt, device=dev)

    fm_v = f(free_mask)
    nv, d = b.shape
    coarse = None if coarse_np is None else convert.coarse_from_numpy(
        coarse_np, dt, dev)
    b_sl = ss.shard_vertex_field(sp, f(b))[r]
    x, it, rel = ss.sharded_pcg(
        sp, comm, ss.shard_element_rows(sp, f(Gw))[r],
        ss.shard_element_rows(sp, f(mass))[r], b_sl, torch.zeros_like(b_sl),
        ss.shard_vertex_field(sp, fm_v[:, None].expand(nv, d))[r],
        ss.shard_vertex_field(sp, f(binv).reshape(nv, d * d))[r].reshape(
            d, d, -1),
        max_iters, tol, coarse=coarse, free_mask=fm_v,
        Ac_inv=None if Ac_inv is None else f(Ac_inv))
    xs = ss.unshard_vertex_field(sp, torch.stack(comm.all_gather(x)))
    return xs.cpu().numpy(), it, float(rel)

