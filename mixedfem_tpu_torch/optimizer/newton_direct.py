"""The host-solve Newton step (port of
mixedfem_tpu/optimizer/newton_direct.py): the reference's eigen-llt /
eigen-ldlt / eigen-lu / cholmod ('direct'), eigen-pcg-IC ('pcg-ic') and
subspace-amgcl ('amgcl') paths.

Per Newton iteration the device updates the coefficients (K3 in the mixed
stretch's update; K2, or K4 over a banded plan, in the inertia, rhs and
vanilla gradient sums), the host assembles the condensed SPD matrix into
scipy CSR (solvers/direct.py) and factors and solves it exactly, or runs
CG with its IC(0) factor; 'amgcl' assembles the dual Schur complement and
runs CG with smoothed-aggregation AMG (solvers/amg.py) and recovers
(dx, ds, dlam) from it. The line search, BC motion, press controllers and
BDF push follow the JAX host loop step for step, its quirks included:
acceptance is the strict merit(alpha) < E with no rounding band, the CCD
clamp is 0.9 accd_alpha with mixed collision only, `E_prev` is never
updated (so the energy residual is always inf and never stops the loop),
and the returned state carries la = 0.

Variables: mixed-stretch, the vanilla stretch, mixed-collision, nodal
collision and lagged friction (their full frame Hessians join the
matrix). Host time per stage accumulates in HOST_MS ('update': the
device's coefficient update, waited for; 'assemble'; 'factor_solve'; and
'amg_setup' for the hierarchy); LAST_SYSTEM holds the last system's size
(nnz of A or S, the IC shift, the AMG levels). The stages run under
profiler spans `newton.update`, `newton.host_assemble`,
`newton.host_solve` and `newton.line_search`.

With a `comm` this is the element-sharded host step of one rank
(parallel/sharding.py): the device's sums and the merit's element
energies are summed over the ranks as in newton_step, the rank's element
coefficients are gathered in rank order into the whole mesh's (the
padding dropped), and rank 0 alone assembles the host system over the
unsharded mesh (`whole_mesh`, which sharding.shard_scene keeps), which is
then the single-device one bit for bit, and solves it; its solution
reaches the other ranks through comm.psum of (solution, 0, ..., 0), which
adds only zeros and so hands every rank rank 0's bits. One host solve,
not one a rank: the ranks of one card share its host's cores.
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Tuple

import numpy as np
import torch
from torch.profiler import record_function

from mixedfem_tpu_torch.bc import boundary_conditions as bcmod
from mixedfem_tpu_torch.bc import press as pressmod
from mixedfem_tpu_torch.collision import accd as accdmod
from mixedfem_tpu_torch.config import SimConfig
from mixedfem_tpu_torch.integrators import bdf as bdfmod
from mixedfem_tpu_torch.mesh import mesh as meshmod
from mixedfem_tpu_torch.optimizer import newton as newtonmod
from mixedfem_tpu_torch.solvers import amg as amgmod
from mixedfem_tpu_torch.solvers import direct as directmod
from mixedfem_tpu_torch.solvers import factory
from mixedfem_tpu_torch.solvers import minres as mrmod
from mixedfem_tpu_torch.solvers import operator as opmod
from mixedfem_tpu_torch.variables import collision as vcol
from mixedfem_tpu_torch.variables import displacement as disp
from mixedfem_tpu_torch.variables import friction as fric
from mixedfem_tpu_torch.variables import mixed_collision as mc
from mixedfem_tpu_torch.variables import mixed_stretch as ms
from mixedfem_tpu_torch.variables import stretch as vstretch

# host milliseconds per stage, summed over calls; a caller clears it
# before a run and reads it after
HOST_MS: collections.Counter = collections.Counter()
# the last Newton iteration's system: nnz (of A, or of S for 'amgcl'),
# shift (IC(0)), levels (AMG, the coarsest dense level included)
LAST_SYSTEM: dict = {}


# the profiler span each stage runs under
_SPANS = {"update": "newton.update", "assemble": "newton.host_assemble",
          "amg_setup": "newton.host_solve", "factor_solve": "newton.host_solve"}


class _Stage:
    """Runs a `with` block under its stage's profiler span and adds its
    host milliseconds to HOST_MS[key]."""

    def __init__(self, key):
        self.key = key
        self.span = record_function(_SPANS[key])

    def __enter__(self):
        self.span.__enter__()
        self.t0 = time.perf_counter()

    def __exit__(self, *exc):
        HOST_MS[self.key] += (time.perf_counter() - self.t0) * 1e3
        return self.span.__exit__(*exc)


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _amax(t, comm):
    """The largest |t| over an element array (and over the ranks)."""
    m = t.abs().amax()
    return m if comm is None else comm.pmax(m)


def _gather_coeffs(c, gather):
    """The stretch coefficients' element fields of the whole mesh, from
    each rank's (the fields the host systems read)."""
    return dataclasses.replace(c, **{f: gather(getattr(c, f))
                                     for f in ("G", "H", "Hinv", "g")})


def _pack(sol) -> np.ndarray:
    """(dx, ds, dl, iterations) as one float64 vector."""
    dx, ds, dl, it = sol
    return np.concatenate([np.asarray(dx, np.float64).reshape(-1),
                           np.asarray(ds, np.float64).reshape(-1),
                           np.asarray(dl, np.float64).reshape(-1), [it]])


def _unpack(v, xshape, eshape):
    nx, ne = int(np.prod(xshape)), int(np.prod(eshape))
    return (v[:nx].reshape(xshape), v[nx:nx + ne].reshape(eshape),
            v[nx + ne:nx + 2 * ne].reshape(eshape), int(v[-1]))


def newton_step_direct(
    mesh: meshmod.MeshData,
    config: SimConfig,
    bc_specs: Tuple,
    state: newtonmod.SimState,
    press_specs: Tuple[pressmod.PressSpec, ...] = (),
    matvec_plan: opmod.BandedPlan | None = None,
    comm=None,
    whole_mesh: meshmod.MeshData | None = None,
) -> newtonmod.SimState:
    """One implicit BDF timestep with a host sparse solve per Newton
    iteration. `matvec_plan` (a banded plan) sends the device's vertex sums
    through K4 instead of K2. Contact runs over `state.contact`. `comm`
    and the unsharded `whole_mesh` make it the element-sharded step of one
    rank (the module's docstring)."""
    solver = factory.resolve_solver(config.solver)
    if solver not in newtonmod.HOST_SOLVERS:
        raise ValueError(f"'{solver}' is an on-device path (newton_step)")
    cf = state.contact
    C = cf.frames.shape[0]
    if solver == "amgcl" and (
        "mixed-stretch" not in config.mixed_variables
        or config.variables
        or ("mixed-collision" in config.mixed_variables and C > 0)
    ):
        # the dual elimination is lumped-mass-only and defined for the
        # mixed stretch alone (the reference's DualCondensedSystem
        # overwrites its lhs and rhs per mixed variable)
        raise NotImplementedError(
            "subspace-amgcl solves the mixed-stretch dual system only")
    dt = bdfmod.bdf_dt(state.bdf)
    h2 = dt * dt
    dtype, dev = state.x.dtype, state.x.device
    outer = config.outer_steps
    use_mixed = "mixed-stretch" in config.mixed_variables
    use_vanilla = "stretch" in config.variables
    use_contact = "mixed-collision" in config.mixed_variables and C > 0
    use_vcollision = "collision" in config.variables and C > 0
    use_friction = "friction" in config.variables and C > 0
    dhat, kappa = config.dhat, config.kappa
    bdf = state.bdf
    if comm is not None:
        from mixedfem_tpu_torch.parallel import sharding

        newtonmod.check_sharded(mesh, matvec_plan, state)
        if whole_mesh is None:
            raise ValueError("the element-sharded host step assembles over "
                             "the unsharded mesh: pass whole_mesh")
        whole, nelem = whole_mesh, whole_mesh.nelem

        def gather(t):
            return sharding.gather_elements(comm, t, nelem)

        def from_rank0(make, like):
            """make() on rank 0, zeros of `like`'s shape elsewhere, summed
            over the ranks: rank 0's bits on every rank."""
            out = make() if comm.rank == 0 else np.zeros_like(like)
            t = comm.psum(torch.as_tensor(np.ascontiguousarray(out), device=dev))
            return t.cpu().numpy()

    if press_specs:
        press_ext = torch.zeros_like(state.x)
        for spec, pst in zip(press_specs, state.press_states):
            press_ext = press_ext + pressmod.press_force(spec, pst, mesh.nv,
                                                         mesh.dim)
        mesh = dataclasses.replace(mesh, ext_force=mesh.ext_force + press_ext)

    def assemble(contrib):
        return opmod.assemble(mesh, matvec_plan, contrib)

    x, s, la = state.x, state.s, state.la
    n = cf.nreal
    cd, cla, cact = (x.new_zeros((n,)) for _ in range(3))
    frames_real = cf.real()[0]

    # the lagged friction set from the pre-step positions
    if use_friction:
        ffr = fric.build(mesh, cf, x, dhat, kappa)
        epsv_h = config.espv * dt

    stats = newtonmod.empty_stats(outer, dtype, dev)
    # never updated, as in the JAX host loop: res stays inf
    E_prev = np.inf
    dec = res = np.inf
    it = 0
    while it < outer and dec > config.newton_tol and res > 1e-12:
        with _Stage("update"):
            inertia_grad = meshmod.project_free(mesh, assemble(
                disp.gradient_contrib(mesh, bdf, x,
                                      blend=config.inertia_blend_factor)))
            b = -inertia_grad
            coeffs = vcoeffs = cc = None
            if use_mixed:
                coeffs = ms.update(mesh, x, s, dt)
                b = b + meshmod.project_free(
                    mesh, assemble(ms.rhs_contrib(mesh, coeffs, s)))
            if use_vanilla:
                vcoeffs = vstretch.update(mesh, x, dt)
                b = b - vstretch.gradient(mesh, vcoeffs, matvec_plan)
            if use_contact:
                cc = mc.update(mesh, cf, x, cd, cla, cact, dhat, kappa,
                               ee_mollifier=config.ee_mollifier)
                b = b + mc.rhs(mesh, cf, cc)
            frame_hessians = []
            if use_vcollision:
                vcc = vcol.update(cf, x, dhat, kappa)
                b = b - vcol.gradient(mesh, cf, vcc)
                frame_hessians.append((frames_real, vcc.H))
            if use_friction:
                fcc = fric.update(ffr, x, config.contact_mu, epsv_h)
                b = b - fric.gradient(mesh, ffr, fcc)
                frame_hessians.append((ffr.frames, fcc.H))
            if solver == "amgcl":
                rhs_kkt = mrmod.kkt_rhs(mesh, bdf, coeffs, x, s, la,
                                        blend=config.inertia_blend_factor)
            _sync(dev)

        if solver == "amgcl":
            # the dual-condensed flow: S dlam = b by AMG-preconditioned CG
            # on the host, then the dual recovery of (dx, ds)
            def solve_amg(m, c, r):
                return amgmod.solve_dual_amg(
                    m, c, r, config.itr_tol,
                    config.max_iterative_solver_iters, stage=_Stage,
                    system=LAST_SYSTEM)

            if comm is None:
                dx_np, ds_np, dl_np, lin_iters = solve_amg(mesh, coeffs,
                                                           rhs_kkt)
            else:
                gc = _gather_coeffs(coeffs, gather)
                grhs = (rhs_kkt[0],) + tuple(gather(r) for r in rhs_kkt[1:])
                packed = from_rank0(
                    lambda: _pack(solve_amg(whole, gc, grhs)),
                    np.zeros(rhs_kkt[0].numel() + 2 * gc.g.numel() + 1))
                dx_np, ds_np, dl_np, lin_iters = _unpack(
                    packed, rhs_kkt[0].shape, gc.g.shape)
                # the rank's slice of the element solution, padded
                pad = sharding.element_padding(nelem, comm.size)
                ds_np, dl_np = (sharding.slice_rank(
                    torch.as_tensor(a), pad, comm.rank, comm.size).numpy()
                    for a in (ds_np, dl_np))
            dx = meshmod.project_free(
                mesh, torch.tensor(dx_np, dtype=dtype, device=dev))
            ds = torch.tensor(ds_np, dtype=dtype, device=dev)
            la_new = la + torch.tensor(dl_np, dtype=dtype, device=dev)
            dec = max(float(dx.abs().amax()), float(_amax(ds, comm)))
        else:
            contact_blocks = ((frames_real, cc.Gx, cc.H, cc.active)
                              if use_contact else None)
            b_np = directmod.host(b).astype(np.float64).reshape(-1)

            def solve_condensed(m, c, vc):
                with _Stage("assemble"):
                    A = directmod.assemble_condensed(
                        m, c, contact=contact_blocks, v_coeffs=vc,
                        frame_hessians=frame_hessians)
                with _Stage("factor_solve"):
                    if solver == "pcg-ic":
                        M = directmod.ICholPreconditioner(A)
                        dx_np, lin_iters = directmod.solve_ic_pcg(
                            A, b_np, config.itr_tol,
                            config.max_iterative_solver_iters, M=M)
                        shift = M.shift
                    else:
                        dx_np, lin_iters, shift = (
                            directmod.solve_direct(A, b_np), 1, None)
                LAST_SYSTEM.update(nnz=A.nnz, shift=shift, levels=None)
                return dx_np, lin_iters

            if comm is None:
                dx_np, lin_iters = solve_condensed(mesh, coeffs, vcoeffs)
            else:
                gc = None if coeffs is None else _gather_coeffs(coeffs, gather)
                gv = None if vcoeffs is None else dataclasses.replace(
                    vcoeffs, H=gather(vcoeffs.H))
                packed = from_rank0(
                    lambda: np.append(*solve_condensed(whole, gc, gv)),
                    np.zeros(b_np.size + 1))
                dx_np, lin_iters = packed[:-1], int(packed[-1])
            dx = meshmod.project_free(mesh, torch.tensor(
                dx_np.reshape(mesh.nv, mesh.dim), dtype=dtype, device=dev))
            # the local recovery (SystemMatrixPD::post_solve)
            if use_mixed:
                ds, la_new = ms.local_solve(mesh, coeffs, s, dx)
                dec = max(float(dx.abs().amax()), float(_amax(ds, comm)))
            else:
                ds, la_new = torch.zeros_like(s), la
                dec = float(dx.abs().amax())

        with record_function("newton.line_search"):
            if use_contact:
                cdd, cla_new = mc.local_solve(mesh, cf, cc, dx)
                cd_cur, cact_new = cc.d, cc.active
                dec = max(dec, float(cdd.abs().amax()))
            else:
                cdd, cla_new = x.new_zeros((n,)), cla
                cd_cur, cact_new = cd, cact

            def merit(x_t, s_t, cd_t):
                E = newtonmod._total_energy(
                    mesh, bdf, h2, x_t, s_t, la_new, use_mixed=use_mixed,
                    use_vanilla=use_vanilla)
                if comm is not None:
                    E = comm.psum(E)
                if use_contact:
                    E = E + newtonmod.mixed_contact_merit(
                        cf, x_t, cd_t, cact_new, cla_new, dhat, kappa,
                        mesh=mesh, ee_mollifier=config.ee_mollifier)
                if use_vcollision:
                    E = E + h2 * vcol.energy(cf, x_t, dhat, kappa, dt)
                if use_friction:
                    E = E + h2 * fric.energy(ffr, x_t, config.contact_mu,
                                             epsv_h, dt)
                return float(E)

            E = merit(x, s, cd_cur)
            res = (abs((E - E_prev) / (E + 1e-6)) if np.isfinite(E_prev)
                   else np.inf)

            if config.record_vanilla_gradient:
                vg_norm = float(torch.linalg.vector_norm(
                    inertia_grad + vstretch.gradient_at(mesh, x, dt,
                                                        matvec_plan)))
            else:
                vg_norm = 0.0

            alpha = 1.0
            if use_contact and config.enable_ccd:
                alpha = 0.9 * float(accdmod.accd_alpha(
                    cf.frames, cf.ftype, cf.fmask, x, dx))

            # backtracking on the strict decrease merit(alpha) < E
            k = 0
            while k < config.ls_iters:
                if merit(x + alpha * dx, s + alpha * ds,
                         cd_cur + alpha * cdd) < E:
                    break
                alpha *= 0.5
                k += 1
            accept = 1.0 if k < config.ls_iters else 0.0
            x = x + (accept * alpha) * dx
            s = s + (accept * alpha) * ds
            la = la_new
            cd = cd_cur + (accept * alpha) * cdd
            cla, cact = cla_new, cact_new

        stats.energy[it] = E
        stats.energy_res[it] = res
        stats.decrement[it] = dec
        stats.alpha[it] = alpha
        stats.solver_iters[it] = lin_iters
        stats.solver_error[it] = 0.0
        stats.vanilla_grad[it] = vg_norm
        if use_contact:
            stats.active_frames[it] = cact.sum()
            stats.min_distance[it] = torch.where(
                cact > 0, cd, float("inf")).amin()
        it += 1
        stats.iterations = it

    # scripted BC motion, press controllers, BDF push (as in newton_step)
    bc_states = []
    for spec, bcst in zip(bc_specs, state.bc_states):
        x, bcst = bcmod.bc_step(spec, bcst, x, config.h)
        bc_states.append(bcst)
    press_states = tuple(
        pressmod.press_step(spec, pst, x, config.h)
        for spec, pst in zip(press_specs, state.press_states)
    )
    return newtonmod.SimState(
        x=x,
        s=s,
        la=torch.zeros_like(la),
        bdf=bdfmod.bdf_update(bdf, x),
        bc_states=tuple(bc_states),
        contact=state.contact,
        press_states=press_states,
        step_count=state.step_count + 1,
        stats=stats,
        precond=state.precond,
        power_v0=state.power_v0,
        # the JAX host loop leaves the warm-start rotations behind (its
        # SimState takes the default R)
        R=x.new_zeros((0, 3, 3)),
    )
