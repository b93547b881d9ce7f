"""Newton implicit time stepper (port of the generic pcg branch of
mixedfem_tpu/optimizer/newton.py:newton_step).

One call is one implicit BDF step of a 3D tet solid with the mixed-stretch
variable and, when the state carries contact frames, IPC contact (the
mixed-collision variable, the nodal collision barrier, lagged friction):

  press forces -> lagged friction set -> [ update -> assemble -> PCG on
    the condensed operator -> local (ds, la; dd, contact la) -> ACCD clamp
    -> backtracking line search ] x <= outer_steps ->
  scripted BC motion -> press controllers -> BDF history push -> la = 0

Vertex sums go through the mesh's incidence plan (K2, and K1 + K2 for the
CG matvec) or, when a banded plan is given (solvers/operator.py
BandedPlan; the scene loader builds one on the card), through K4 (and
K1 + K4 for the matvec), as the JAX step's `bassemble` and
`banded_matvec` do. With a StencilPlan of a box grid (ops/stencil.py) the
matvec is the lattice stencil K5 on blocks that K6 assembles once per
Newton iteration: with no coarse space or a grid one the whole iteration
follows the JAX step's row body (lattice CG, lattice preconditioner, the
alpha-parametrized merit), with a geometric one, or with contact, the
generic body (the configuration of the JAX package's entry()).

Contact sums go through incidence plans built on the host, K2 on the card,
in a fixed order: frame corners to vertices through the frame plan built
with the candidates (variables/mixed_collision.py), and the coarse
space's contact blocks to aggregate pairs through a pair plan of the
frames active at the coarse refresh (solvers/coarse.py:contact_pairs).

The Newton loop, the CG loop and the line search are host loops; each
convergence test reads one scalar from the device. Each stage runs under a
profiler span (`newton.coarse_refresh`, `newton.update`, `newton.pcg`,
`newton.line_search`, and `newton.contact` around the contact work inside
them: the frame updates, the contact merit terms and ACCD), which costs
nothing unless torch.profiler is on. Paths the JAX step has and this port
does not cover yet (vanilla stretch, f64 islands, warm-started rotations,
other solvers) raise NotImplementedError.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch
from torch.profiler import record_function

from mixedfem_tpu_torch.bc import boundary_conditions as bcmod
from mixedfem_tpu_torch.bc import press as pressmod
from mixedfem_tpu_torch.collision import accd as accdmod
from mixedfem_tpu_torch.collision import distances as cdist
from mixedfem_tpu_torch.config import SimConfig
from mixedfem_tpu_torch.integrators import bdf as bdfmod
from mixedfem_tpu_torch.mesh import mesh as meshmod
from mixedfem_tpu_torch.ops import assembly
from mixedfem_tpu_torch.ops import banded_scatter as bs
from mixedfem_tpu_torch.ops import rotation
from mixedfem_tpu_torch.ops import stencil as stmod
from mixedfem_tpu_torch.ops import sym as symmod
from mixedfem_tpu_torch.solvers import coarse as coarsemod
from mixedfem_tpu_torch.solvers import factory
from mixedfem_tpu_torch.solvers import operator as opmod
from mixedfem_tpu_torch.solvers import pcg as pcgmod
from mixedfem_tpu_torch.variables import collision as vcol
from mixedfem_tpu_torch.variables import displacement as disp
from mixedfem_tpu_torch.variables import friction as fric
from mixedfem_tpu_torch.variables import mixed_collision as mc
from mixedfem_tpu_torch.variables import mixed_stretch as ms
from mixedfem_tpu_torch.variables.mixed_collision import ContactFrames


@dataclasses.dataclass
class StepStats:
    """Per-Newton-iteration diagnostics (outer_steps slots)."""

    energy: torch.Tensor        # (outer,)
    energy_res: torch.Tensor    # (outer,)
    decrement: torch.Tensor     # (outer,)
    alpha: torch.Tensor         # (outer,)
    solver_iters: torch.Tensor  # (outer,) int32
    solver_error: torch.Tensor  # (outer,)
    vanilla_grad: torch.Tensor  # (outer,) zero: not recorded by this port
    iterations: int             # Newton iterations taken
    # mixed contact after each iteration (zero / inf without it): active
    # frames, and the least mixed distance over them
    active_frames: torch.Tensor  # (outer,) int32
    min_distance: torch.Tensor   # (outer,)


@dataclasses.dataclass
class SimState:
    x: torch.Tensor     # (nv, 3) positions (pinned rows follow the BCs)
    s: torch.Tensor     # (E, 6) mixed stretch
    la: torch.Tensor    # (E, 6) multipliers
    bdf: bdfmod.BDFState
    bc_states: Tuple[bcmod.BCState, ...]
    contact: ContactFrames  # padded per-step candidates (capacity may be 0)
    press_states: Tuple[pressmod.PressState, ...]
    step_count: int
    stats: StepStats
    # cached dense coarse inverse (ncd, ncd) when coarse_refresh_every > 1,
    # else (0, 0)
    precond: torch.Tensor


def empty_stats(outer: int, dtype, device) -> StepStats:
    def z():
        return torch.zeros((outer,), dtype=dtype, device=device)

    return StepStats(
        energy=z(), energy_res=z(), decrement=z(), alpha=z(),
        solver_iters=torch.zeros((outer,), dtype=torch.int32, device=device),
        solver_error=z(), vanilla_grad=z(), iterations=0,
        active_frames=torch.zeros((outer,), dtype=torch.int32, device=device),
        min_distance=torch.full((outer,), float("inf"), dtype=dtype,
                                device=device),
    )


def empty_contact(nv: int, dtype, device) -> ContactFrames:
    """The empty candidate set of a state before its first broadphase."""
    return mc.contact_frames(np.zeros((0, 4), np.int32), np.zeros(0, np.int32),
                             np.zeros(0), nv, dtype, device)


def init_state(
    mesh: meshmod.MeshData,
    config: SimConfig,
    bc_states: Tuple[bcmod.BCState, ...],
    x0: torch.Tensor,
    v0: torch.Tensor,
    press_states: Tuple[pressmod.PressState, ...] = (),
) -> SimState:
    s0, la0 = ms.reset(mesh, x0)
    return SimState(
        x=x0,
        s=s0,
        la=la0,
        bdf=bdfmod.bdf_init(config.integrator, x0, v0, config.h),
        bc_states=tuple(bc_states),
        contact=empty_contact(x0.shape[0], x0.dtype, x0.device),
        press_states=tuple(press_states),
        step_count=0,
        stats=empty_stats(config.outer_steps, x0.dtype, x0.device),
        precond=torch.zeros((0, 0), dtype=x0.dtype, device=x0.device),
    )


def _total_energy(mesh, bdf, h2, x, s, la, Sv=None):
    """Line-search merit: inertia + h^2 psi(s) + la . c(x, s). `Sv` skips
    the polar decomposition when S(x) at this x is already known."""
    return (
        disp.energy(mesh, bdf, x)
        + h2 * ms.energy(mesh, s)
        + ms.constraint_value(mesh, x, s, la, Sv=Sv)
    )


def mixed_contact_merit(cf, x_t, cd_t, act_prev_mask, cla, dhat, kappa,
                        mesh=None, ee_mollifier=False):
    """Mixed-IPC contact terms of the merit at a trial point: the barrier on
    the trial mixed distances (candidates newly inside dhat join with
    d = D(x_t)), 1e30 when infeasible, plus the constraint term
    la . (D - d) over the active set. cd_t, act_prev_mask and cla are per
    real frame (n,)."""
    frames, ftype = cf.real()
    verts = x_t[frames]
    D_t = cdist.frame_distance(verts, ftype)
    act_prev = act_prev_mask > 0
    d_eff = torch.where(act_prev, cd_t, D_t)
    act = act_prev | (D_t < dhat)
    m_t = None
    if ee_mollifier:
        from mixedfem_tpu_torch.collision import mollifier as mol

        m_t = mol.mollifier(verts, ftype, mol.eps_x(mesh.V0[frames]))
    e = mc.energy(d_eff, act.to(x_t.dtype), dhat, kappa, m=m_t)
    m = (act_prev & ((D_t <= dhat) | (cd_t <= dhat))).to(x_t.dtype)
    return e + torch.sum(cla * (D_t - cd_t) * m)


_MIXED = ("mixed-stretch", "mixed-collision")
_NODAL = ("collision", "friction")


def check_supported(config: SimConfig) -> str:
    """The solve path of `config`; raises NotImplementedError for what this
    port does not cover."""
    solver = factory.resolve_solver(config.solver)
    if "mixed-stretch" not in config.mixed_variables:
        raise NotImplementedError("this port needs the mixed-stretch variable")
    other = [v for v in config.mixed_variables if v not in _MIXED]
    other += [v for v in config.variables if v not in _NODAL]
    if other:
        raise NotImplementedError(f"variables {other}")
    if config.rotation_warm_start:
        raise NotImplementedError("rotation_warm_start")
    if config.record_vanilla_gradient:
        raise NotImplementedError("record_vanilla_gradient")
    if config.coarse_inverse_method not in ("newton-schulz", "lu"):
        raise ValueError(config.coarse_inverse_method)
    return solver


def _select_body(config: SimConfig, coarse, matvec_plan, contact: bool) -> str:
    """'grid', 'stencil' or 'generic', as the JAX step selects its Newton
    body (mixedfem_tpu/optimizer/newton.py:387-405 and :611-633; contact
    keeps the lattice body out); raises for the stencil branch this port
    does not cover."""
    if not isinstance(matvec_plan, stmod.StencilPlan):
        return "generic"
    if contact or (coarse is not None and coarse.grid is None):
        return "stencil"
    if config.inertia_blend_factor != 1.0:
        # the JAX step runs its element-major lattice-CG branch here
        raise NotImplementedError(
            "a stencil plan with inertia_blend_factor != 1 and no coarse "
            "space or a grid one"
        )
    return "grid"


def _line_search(E, eps_E: float, ls_iters: int, merit, alpha0: float = 1.0):
    """Backtracking from alpha0: accept when merit(alpha) < E + eps_E |E|
    (the rounding band); (alpha, accepted)."""
    E_thresh = E + eps_E * E.abs()
    alpha, ls_k = alpha0, 0
    while ls_k < ls_iters and bool(merit(alpha) >= E_thresh):
        alpha *= 0.5
        ls_k += 1
    return alpha, 1.0 if ls_k < ls_iters else 0.0


def newton_step(
    mesh: meshmod.MeshData,
    config: SimConfig,
    bc_specs: Tuple,
    state: SimState,
    coarse: coarsemod.CoarseSpace | None = None,
    press_specs: Tuple[pressmod.PressSpec, ...] = (),
    matvec_plan: opmod.BandedPlan | stmod.StencilPlan | None = None,
) -> SimState:
    """One implicit BDF timestep. `coarse` enables the two-level
    rigid-body coarse preconditioner (solver 'pcg' only); `matvec_plan`
    (operator.build_banded_plan) sends the CG matvec and the once-per-Newton
    assemblies through the banded sum (K4 on the card), or, a StencilPlan
    (stencil.build_stencil_plan) of a box grid in cell-major element order,
    through the lattice stencil (K5, K6): with no coarse space or a grid
    one (coarse.build_coarse_space_grid) the whole Newton iteration runs on
    the lattice (the JAX step's row body), with a geometric coarse space
    or with contact only the matvec and the assemblies do. Contact runs
    over `state.contact` (Simulation.step builds it with the broadphase)."""
    solver = check_supported(config)
    if config.rhs_precision == "float64" and state.x.dtype != torch.float64:
        raise NotImplementedError("rhs_precision='float64' islands")
    dt = bdfmod.bdf_dt(state.bdf)
    h2 = dt * dt
    dtype, dev = state.x.dtype, state.x.device
    outer = config.outer_steps
    bdf = state.bdf

    # dynamic external forces (MechanicalPress controllers)
    if press_specs:
        press_ext = torch.zeros_like(state.x)
        for spec, pst in zip(press_specs, state.press_states):
            press_ext = press_ext + pressmod.press_force(spec, pst, mesh.nv, 3)
        mesh = dataclasses.replace(mesh, ext_force=mesh.ext_force + press_ext)

    def assemble(contrib):
        """(E, k, ...) corner contributions -> (nv, ...), in a fixed order."""
        if not isinstance(matvec_plan, opmod.BandedPlan):
            return assembly.segment_sum(mesh.plan, contrib)
        trail = tuple(contrib.shape[2:])
        rows = bs.pad_rows(matvec_plan, contrib.reshape(mesh.T.numel(), -1))
        return bs.scatter_add_sorted(matvec_plan, rows).reshape(
            (mesh.nv,) + trail
        )

    target = disp.target(mesh, bdf, blend=config.inertia_blend_factor)

    cf = state.contact
    have_frames = cf.frames.shape[0] > 0
    use_contact = "mixed-collision" in config.mixed_variables and have_frames
    use_vcollision = "collision" in config.variables and have_frames
    use_friction = "friction" in config.variables and have_frames
    any_contact = use_contact or use_vcollision or use_friction
    dhat, kappa = config.dhat, config.kappa

    # the lagged friction set from the pre-step positions
    if use_friction:
        with record_function("newton.contact"):
            ffr = fric.build(mesh, cf, state.x, dhat, kappa)
        epsv_h = config.espv * dt

    if solver != "pcg":
        coarse = None
    body_kind = _select_body(config, coarse, matvec_plan, any_contact)
    precond_out = state.precond
    Ac_inv = None
    if coarse is not None:
        refresh_every = max(config.coarse_refresh_every, 1)
        cached = state.precond.shape[0] == coarse.ncd

        @record_function("newton.coarse_refresh")
        def _build_precond():
            contact0 = None
            if use_contact:
                # the barrier blocks of the frames active at the step's
                # start (every frame new); the inactive ones add zero
                z = state.x.new_zeros((cf.nreal,))
                cc0 = mc.update(mesh, cf, state.x, z, z, z, dhat, kappa,
                                ee_mollifier=config.ee_mollifier)
                act = torch.nonzero(cc0.active).squeeze(1)
                frames = cf.frames[act].long()
                contact0 = (
                    coarsemod.contact_pairs(coarse, frames.cpu().numpy(), dev),
                    frames, cc0.Gx[act], cc0.H[act],
                )
            Ac = coarsemod.coarse_matrix(
                mesh, coarse, ms.update(mesh, state.x, state.s, dt), contact0
            )
            if config.coarse_inverse_method == "newton-schulz":
                return coarsemod.coarse_inverse_ns(
                    Ac, state.precond if cached else None
                )
            return coarsemod.coarse_inverse(Ac)

        if refresh_every > 1 and cached:
            if state.step_count % refresh_every == 0:
                Ac_inv = _build_precond()
            else:
                Ac_inv = state.precond
            precond_out = Ac_inv
        else:
            Ac_inv = _build_precond()
            if refresh_every > 1:
                precond_out = Ac_inv

    eye = torch.eye(3, dtype=dtype, device=dev)
    eps_E = 0.0 if config.ls_strict else 16.0 * torch.finfo(dtype).eps

    def contact_energy(x_t, cd_t, cact, cla):
        """Contact terms of the merit at a trial point."""
        with record_function("newton.contact"):
            e = x_t.new_zeros(())
            if use_contact:
                e = e + mixed_contact_merit(
                    cf, x_t, cd_t, cact, cla, dhat, kappa, mesh=mesh,
                    ee_mollifier=config.ee_mollifier)
            if use_vcollision:
                e = e + h2 * vcol.energy(cf, x_t, dhat, kappa, dt)
            if use_friction:
                e = e + h2 * fric.energy(ffr, x_t, config.contact_mu, epsv_h, dt)
            return e

    def generic_body(x, s, cd, cla, cact):
        with record_function("newton.update"):
            # --- assemble: inertia gradient, rhs, block-Jacobi blocks
            b = -meshmod.project_free(mesh, assemble(disp.gradient_contrib(
                mesh, bdf, x, blend=config.inertia_blend_factor
            )))
            coeffs = ms.update(mesh, x, s, dt)
            b = b + meshmod.project_free(
                mesh, assemble(ms.rhs_contrib(mesh, coeffs, s))
            )
            if body_kind == "stencil":
                # the offset-form blocks (K6); their o=0 plane is the exact
                # block-Jacobi diagonal
                W = stmod.assemble_W(matvec_plan, coeffs.Gw, mesh.mass_coeff)
                blocks = stmod.diag_blocks(matvec_plan, W)
            else:
                blocks = mesh.mass_diag[:, None, None] * eye + assemble(
                    ms.diag_blocks_contrib(mesh, coeffs)
                )
            with record_function("newton.contact"):
                if use_contact:
                    cc = mc.update(mesh, cf, x, cd, cla, cact, dhat, kappa,
                                   ee_mollifier=config.ee_mollifier)
                    b = b + mc.rhs(mesh, cf, cc)
                    blocks = blocks + mc.diag_blocks(mesh, cf, cc)
                if use_vcollision:
                    vcc = vcol.update(cf, x, dhat, kappa)
                    b = b - vcol.gradient(mesh, cf, vcc)
                    blocks = blocks + vcol.diag_blocks(mesh, cf, vcc)
                if use_friction:
                    fcc = fric.update(ffr, x, config.contact_mu, epsv_h)
                    b = b - fric.gradient(mesh, ffr, fcc)
                    blocks = blocks + fric.diag_blocks(mesh, ffr, fcc)

        with record_function("newton.pcg"):
            # --- condensed SPD solve (K1 + K2, K1 + K4, or K5 matvec)
            bj = pcgmod.block_jacobi_inv(blocks, mesh.free_mask)
            if coarse is not None:
                tl = coarsemod.two_level_preconditioner(coarse, mesh.free_mask, bj)

                def Minv(r):
                    return tl(r, Ac_inv)
            else:
                Minv = bj

            def A_elem(p):
                if body_kind == "stencil":
                    return stmod.stencil_matvec(matvec_plan, W, p) * \
                        mesh.free_mask[:, None]
                if matvec_plan is None:
                    return opmod.element_matvec(mesh, p, coeffs)
                return opmod.banded_matvec(mesh, matvec_plan, p, coeffs)

            def A(p):
                out = A_elem(p)
                if any_contact:
                    y = mc.matvec(mesh, cf, cc, p) if use_contact else 0.0
                    if use_vcollision:
                        y = y + vcol.matvec(mesh, cf, vcc, p)
                    if use_friction:
                        y = y + fric.matvec(mesh, ffr, fcc, p)
                    out = out + y
                return out

            dx0 = meshmod.project_free(mesh, target - x)
            dx, cg_iters, cg_err = pcgmod.pcg(
                A, b, dx0, Minv,
                max_iters=config.max_iterative_solver_iters,
                tol=config.itr_tol,
            )

        with record_function("newton.line_search"):
            # --- local recovery of (ds, la) and of the contact (dd, la)
            ds, la_new = ms.local_solve(mesh, coeffs, s, dx)
            dec_t = torch.maximum(dx.abs().amax(), ds.abs().amax())
            if use_contact:
                cdd, cla = mc.local_solve(mesh, cf, cc, dx)
                cd, cact = cc.d, cc.active
                dec_t = torch.maximum(dec_t, cdd.abs().amax())
            else:
                cdd = torch.zeros_like(cd)
            # --- merit at the base point (reuses S(x) from the update)
            E = _total_energy(mesh, bdf, h2, x, s, la_new, Sv=coeffs.Sv)
            if any_contact:
                E = E + contact_energy(x, cd, cact, cla)
            # --- the CCD step-size clamp
            alpha0 = 1.0
            if (use_contact or use_vcollision) and config.enable_ccd:
                with record_function("newton.contact"):
                    alpha0 = float(0.9 * accdmod.accd_alpha(
                        cf.frames, cf.ftype, cf.fmask, x, dx))

            def merit(a):
                e = _total_energy(mesh, bdf, h2, x + a * dx, s + a * ds, la_new)
                if any_contact:
                    e = e + contact_energy(x + a * dx, cd + a * cdd, cact, cla)
                return e

            alpha, accept = _line_search(E, eps_E, config.ls_iters, merit,
                                         alpha0)
            x = x + (accept * alpha) * dx
            s = s + (accept * alpha) * ds
            cd = cd + (accept * alpha) * cdd
        return x, s, la_new, (cd, cla, cact), (E, dec_t, alpha, cg_iters, cg_err)

    if body_kind == "grid":
        # per-step hoists of the lattice body
        plan = matvec_plan
        fm_l = stmod.to_lat(
            plan, mesh.free_mask[:, None].expand(mesh.nv, 3).to(dtype))
        target_l = stmod.to_lat(plan, target)

    def grid_body(x, s, *contact):
        """The JAX step's lattice (row) body, element-major: lattice CG on
        (3, npad) vectors with the stencil matvec (K5), W assembled by K6,
        block-Jacobi from its o=0 plane, and the alpha-parametrized merit
        with dF hoisted out of the line search."""
        with record_function("newton.update"):
            coeffs = ms.update(mesh, x, s, dt)                  # K3
            W = stmod.assemble_W(plan, coeffs.Gw, mesh.mass_coeff)   # K6
            blocks = stmod.diag_blocks(plan, W)
            # M (x - target) and the stretch rhs, assembled (K2)
            Min_l = stmod.to_lat(
                plan, assemble(disp.gradient_contrib(mesh, bdf, x)))
            rhs_l = stmod.to_lat(plan, assemble(ms.rhs_contrib(mesh, coeffs, s)))
            b_l = (rhs_l - Min_l) * fm_l

        with record_function("newton.pcg"):
            maskv = mesh.free_mask[:, None, None]
            binv = pcgmod._small_inv(blocks * maskv + eye * (1.0 - maskv)) * maskv
            Minv_lat = stmod.lattice_two_level_preconditioner(
                plan, coarse, mesh.free_mask, binv, 3)

            def Minv_l(rl):
                return Minv_lat(rl, Ac_inv)

            def A_l(pl_):
                return stmod.matvec_lat(plan, W, pl_, fm_l)      # K5

            x_l = stmod.to_lat(plan, x)
            dx_l, cg_iters, cg_err = pcgmod.pcg(
                A_l, b_l, (target_l - x_l) * fm_l, Minv_l,
                max_iters=config.max_iterative_solver_iters,
                tol=config.itr_tol,
            )

        with record_function("newton.line_search"):
            dx = stmod.from_lat(plan, dx_l)
            ds, la_new = ms.local_solve(mesh, coeffs, s, dx)
            dec_t = torch.maximum(dx_l.abs().amax(), ds.abs().amax())
            # the inertia term is an exact quadratic in alpha, and def_grad
            # is linear in x: F(x + a dx) = F + a dF. Its coefficients are
            # dot products of lattice vectors, as in the JAX body.
            E_in0 = 0.5 * torch.sum((x_l - target_l) * Min_l)
            gin = torch.sum(Min_l * dx_l)
            dxMdx = torch.sum(dx_l * stmod.to_lat(
                plan, meshmod.mass_matvec(mesh, dx)))
            Fx = meshmod.def_grad(mesh, x)
            dF = meshmod.def_grad(mesh, dx)

            def merit(a):
                s_a = s + a * ds
                Sva = symmod.pack(rotation.polar33(Fx + a * dF)[1])
                return (E_in0 + a * gin + (0.5 * a * a) * dxMdx
                        + h2 * ms.energy(mesh, s_a)
                        + ms.constraint_value(mesh, None, s_a, la_new, Sv=Sva))

            # base-point merit: reuses S(x) from the update
            E = (E_in0 + h2 * ms.energy(mesh, s)
                 + ms.constraint_value(mesh, None, s, la_new, Sv=coeffs.Sv))
            alpha, accept = _line_search(E, eps_E, config.ls_iters, merit)
            x = x + (accept * alpha) * dx
            s = s + (accept * alpha) * ds
        return x, s, la_new, contact, (E, dec_t, alpha, cg_iters, cg_err)

    body = grid_body if body_kind == "grid" else generic_body
    stats = empty_stats(outer, dtype, dev)
    x, s, la = state.x, state.s, state.la
    # mixed contact distances, multipliers and active mask of the real
    # frames: fresh every step (frames are detected inside the Newton loop)
    contact = tuple(x.new_zeros((cf.nreal,)) for _ in range(3))
    it = 0
    E_prev = torch.zeros((), dtype=dtype, device=dev)
    dec = res = float("inf")
    while it < outer and dec > config.newton_tol and res > 1e-12:
        x, s, la, contact, (E, dec_t, alpha, cg_iters, cg_err) = body(
            x, s, *contact)
        res_t = torch.abs((E - E_prev) / (E + 1e-6))
        stats.energy[it] = E
        stats.energy_res[it] = res_t
        stats.decrement[it] = dec_t
        stats.alpha[it] = alpha
        stats.solver_iters[it] = cg_iters
        stats.solver_error[it] = cg_err
        if use_contact:
            cd, cact = contact[0], contact[2]
            stats.active_frames[it] = cact.sum()
            stats.min_distance[it] = torch.where(
                cact > 0, cd, float("inf")).amin()
        it += 1
        stats.iterations = it
        E_prev = E
        dec, res = float(dec_t), float(res_t)

    # --- scripted Dirichlet BC motion, then the press controllers
    bc_states = []
    for spec, bcst in zip(bc_specs, state.bc_states):
        x, bcst = bcmod.bc_step(spec, bcst, x, config.h)
        bc_states.append(bcst)
    press_states = tuple(
        pressmod.press_step(spec, pst, x, config.h)
        for spec, pst in zip(press_specs, state.press_states)
    )

    # --- BDF history push with the BC-moved positions, clear la
    return SimState(
        x=x,
        s=s,
        la=torch.zeros_like(la),
        bdf=bdfmod.bdf_update(bdf, x),
        bc_states=tuple(bc_states),
        contact=state.contact,
        press_states=press_states,
        step_count=state.step_count + 1,
        stats=stats,
        precond=precond_out,
    )
