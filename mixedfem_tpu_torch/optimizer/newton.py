"""Newton implicit time stepper (port of
mixedfem_tpu/optimizer/newton.py:newton_step and its on-device solve
paths).

One call is one implicit BDF step of a 3D tet or 2D triangle solid, a
shell (3D triangles) or rods (3D segments) with the mixed-stretch
variable, the vanilla (F-space) stretch variable or both and, when the
state carries contact frames, IPC contact (the
mixed-collision variable, the nodal collision barrier, lagged friction):

  press forces -> Laplacian setup -> lagged friction set -> [ update ->
    assemble -> linear solve -> local (ds, la; dd, contact la) -> ACCD
    clamp -> backtracking line search ] x <= outer_steps ->
  scripted BC motion -> press controllers -> BDF history push -> la = 0

The linear solve is one of the JAX step's ten on-device paths
(solvers/factory.py). The condensed family solves the SPD system in dx and
recovers (ds, la) per element: CG preconditioned by block-Jacobi (with the
two-level coarse space for 'pcg'), by the scalar diagonal ('pcg-diag'), by
the Chebyshev (M + kL)^{-1} ('pcg-laplacian', solvers/laplacian.py) or its
dual-ascent contact loop ('pcg-dualascent'), or multicolor Gauss-Seidel
sweeps as the solver ('gauss-seidel', which needs a GSPlan). The
full-system family solves for (dx, ds, dlam[, dd, dlc]) together: MINRES
on the indefinite KKT system with a block-diagonal ('minres-kkt') or an
ADMM ('minres-kkt-admm') preconditioner (solvers/minres.py,
solvers/admm.py), CG on the dual Schur complement ('dual-cg',
solvers/dual.py), or ADMM itself ('admm').

Vertex sums go through the mesh's incidence plan (K2, and K1 + K2 for the
condensed matvec and the Laplacian preconditioner's) or, when a banded
plan is given (solvers/operator.py BandedPlan; the scene loader builds one
on the card), through K4 (and K1 + K4 for those), as the JAX step's
`bassemble` and `banded_matvec` do. With a StencilPlan of a box grid
(ops/stencil.py) the matvec is the lattice stencil K5 on blocks that K6
assembles once per Newton iteration: with no coarse space or a grid one,
and 'pcg' or 'pcg-block-jacobi', the whole iteration
follows the JAX step's row body (lattice CG, lattice preconditioner, the
alpha-parametrized merit), or, where the JAX step refuses that body (an
inertia blend other than 1, a recorded vanilla gradient), the generic body
with the same lattice-resident CG ('lattice_cg', one lattice round trip
per solve); with a geometric one, with contact, or with a
solver other than 'pcg' and 'pcg-block-jacobi', the generic body with the
stencil matvec (the configuration of the JAX package's entry()). Stencil
plans are 3D only, as in the JAX package; 2D meshes run the generic body.
Shells ignore every plan, as in the JAX step. The full-system
paths sum their x rows over the mesh's incidence plan whatever plan is
given, as the JAX package's segment sums do.

Contact sums go through incidence plans built on the host, K2 on the card,
in a fixed order: frame corners to vertices through the frame plan built
with the candidates (variables/mixed_collision.py), and the coarse
space's contact blocks to aggregate pairs through a pair plan of the
frames active at the coarse refresh (solvers/coarse.py:contact_pairs).

The Newton loop, the solver loops (CG, MINRES, GS sweeps, ADMM sweeps)
and the line search are host loops; each convergence test reads one scalar
from the device. The Chebyshev, dual-ascent and ADMM-inner loops have
fixed lengths and read nothing. Each stage runs under a profiler span
(`newton.coarse_refresh`, `newton.update`, `newton.pcg` around every
linear solve, `newton.line_search`, and `newton.contact` around the
contact work inside them: the frame updates, the contact merit terms and
ACCD), which costs nothing unless torch.profiler is on. The host solvers
'direct', 'pcg-ic' and 'amgcl' are optimizer/newton_direct.py's; this step
refuses them with the JAX step's ValueError.

With `config.rhs_precision == 'float64'` on a float32 state (f64
islands), the cancellation-limited pieces run in float64 on f64 copies of
the mesh and the BDF state: the inertia gradient, the one coefficient
update of each Newton iteration (its float32 cast is what the CG uses),
the rhs, the mixed-contact update and rhs, the local solves and the merit,
whose acceptance is then strict. The assemblies of an island step sum over
the mesh's incidence plan (K2) whatever plan is given, as the JAX step
turns its banded assembly off there; the CG, its blocks and its
preconditioner stay in float32. With `config.rotation_warm_start` the
polar decomposition of each 3D update is seeded with the previous Newton
iterate's rotations (SimState.R, carried from step to step).

With the vanilla stretch variable (variables/stretch.py) the condensed
paths add its gradient, diagonal blocks and Hessian rows (summed with the
mass rows and, with the mixed variable, K1's before the one K2/K4 sum), and
'minres-kkt' adds its product to the x-row; `record_vanilla_gradient`
records the vanilla gradient norm at every Newton iterate (the
convergence harness, apps/convergence.py).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

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
from mixedfem_tpu_torch.ops import rotation
from mixedfem_tpu_torch.ops import stencil as stmod
from mixedfem_tpu_torch.ops import sym as symmod
from mixedfem_tpu_torch.solvers import admm as admmmod
from mixedfem_tpu_torch.solvers import coarse as coarsemod
from mixedfem_tpu_torch.solvers import dual as dualmod
from mixedfem_tpu_torch.solvers import factory
from mixedfem_tpu_torch.solvers import gauss_seidel as gsmod
from mixedfem_tpu_torch.solvers import laplacian as lapmod
from mixedfem_tpu_torch.solvers import minres as mrmod
from mixedfem_tpu_torch.solvers import operator as opmod
from mixedfem_tpu_torch.solvers import pcg as pcgmod
from mixedfem_tpu_torch.variables import collision as vcol
from mixedfem_tpu_torch.variables import displacement as disp
from mixedfem_tpu_torch.variables import friction as fric
from mixedfem_tpu_torch.variables import mixed_collision as mc
from mixedfem_tpu_torch.variables import mixed_stretch as ms
from mixedfem_tpu_torch.variables import stretch as vstretch
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
    vanilla_grad: torch.Tensor  # (outer,) |vanilla gradient| at each iterate
    #                             (zero unless config.record_vanilla_gradient)
    iterations: int             # Newton iterations taken
    # mixed contact after each iteration (zero / inf without it): active
    # frames, and the least mixed distance over them
    active_frames: torch.Tensor  # (outer,) int32
    min_distance: torch.Tensor   # (outer,)


@dataclasses.dataclass
class SimState:
    x: torch.Tensor     # (nv, d) positions (pinned rows follow the BCs)
    s: torch.Tensor     # (E, N) mixed stretch (N = 6 in 3D, 3 in 2D)
    la: torch.Tensor    # (E, N) multipliers
    bdf: bdfmod.BDFState
    bc_states: Tuple[bcmod.BCState, ...]
    contact: ContactFrames  # padded per-step candidates (capacity may be 0)
    press_states: Tuple[pressmod.PressState, ...]
    step_count: int
    stats: StepStats
    # cached dense coarse inverse (ncd, ncd) when coarse_refresh_every > 1,
    # else (0, 0)
    precond: torch.Tensor
    # the Laplacian preconditioner's power-iteration start vector (nv, d),
    # drawn by the first step that needs it (laplacian.default_power_start)
    # unless given, and carried from step to step
    power_v0: Optional[torch.Tensor] = None
    # per-element rotations (E, 3, 3), the polar seed of the next update,
    # when config.rotation_warm_start; (0, 3, 3) otherwise
    R: torch.Tensor = dataclasses.field(
        default_factory=lambda: torch.zeros((0, 3, 3)))


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
    R0 = x0.new_zeros((0, 3, 3))
    if (config.rotation_warm_start and mesh.dim == 3
            and "mixed-stretch" in config.mixed_variables):
        _, R0 = ms.stretch_of_x(mesh, x0)
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
        R=R0,
    )


def _total_energy(mesh, bdf, h2, x, s, la, Sv=None, use_mixed=True,
                  use_vanilla=False):
    """Line-search merit: inertia + h^2 psi(s) + la . c(x, s) with the
    mixed variable, + h^2 psi(F(x)) with the vanilla one. `Sv` skips the
    polar decomposition when S(x) at this x is already known. With
    warm-started rotations the update's Sv is the warm branch's, and a
    trial point's (Sv None) the stateless polar's; the two differ on
    inverted elements, as in the JAX step."""
    E = disp.energy(mesh, bdf, x)
    if use_mixed:
        E = E + h2 * ms.energy(mesh, s) + ms.constraint_value(
            mesh, x, s, la, Sv=Sv)
    if use_vanilla:
        E = E + h2 * vstretch.energy(mesh, x)
    return E


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
    if ee_mollifier and mesh.dim == 3:
        from mixedfem_tpu_torch.collision import mollifier as mol

        m_t = mol.mollifier(verts, ftype, mol.eps_x(mesh.V0[frames]))
    e = mc.energy(d_eff, act.to(x_t.dtype), dhat, kappa, m=m_t)
    m = (act_prev & ((D_t <= dhat) | (cd_t <= dhat))).to(x_t.dtype)
    return e + torch.sum(cla * (D_t - cd_t) * m)


_MIXED = ("mixed-stretch", "mixed-collision")
_NODAL = ("collision", "friction")


# the paths that solve for (dx, ds, dlam[, dd, dlc]) together
FULL_SYSTEM = ("minres-kkt", "minres-kkt-admm", "dual-cg", "admm")
# the host paths (optimizer/newton_direct.py)
HOST_SOLVERS = ("direct", "pcg-ic", "amgcl")
# the paths with f64 islands (config.rhs_precision = 'float64')
ISLAND_SOLVERS = ("pcg", "pcg-block-jacobi", "pcg-diag", "pcg-laplacian",
                  "pcg-dualascent")


def _cast(obj, dtype):
    """A copy of the dataclass `obj` with every floating tensor field cast
    to `dtype`; index tables, plans and other fields are shared."""
    return dataclasses.replace(obj, **{
        f.name: v.to(dtype) for f in dataclasses.fields(obj)
        if torch.is_tensor(v := getattr(obj, f.name)) and v.is_floating_point()
    })


def island_update(mesh_hp, bdf_hp, x, s, dt, *, blend: float = 1.0,
                  use_mixed: bool = True, R_prev=None, cf=None, contact=None,
                  dhat: float = 0.0, kappa: float = 0.0,
                  ee_mollifier: bool = False):
    """The f64 islands' update at a float32 iterate (x, s), in float64 on
    the f64 copies mesh_hp and bdf_hp (the JAX step's :667-745): the
    inertia gradient, the coefficient update (warm-started from R_prev when
    given) and, with the frames `cf` and their mixed contact state
    `contact` = (d, la, active), the mixed-contact update. Returns
    (inertia gradient, rhs b = -inertia + stretch rhs + contact rhs,
    stretch coefficients, contact coefficients), all float64; the sums run
    over the mesh's and the frames' incidence plans (K2)."""
    x64 = x.double()
    g = disp.gradient(mesh_hp, bdf_hp, x64, blend=blend)
    b = -g
    coeffs = cc = None
    if use_mixed:
        s64 = s.double()
        coeffs = ms.update(mesh_hp, x64, s64, dt,
                           R_prev=None if R_prev is None else R_prev.double())
        b = b + ms.rhs(mesh_hp, coeffs, s64)
    if cf is not None:
        with record_function("newton.contact"):
            d, la, act = (t.double() for t in contact)
            cc = mc.update(mesh_hp, cf, x64, d, la, act, dhat, kappa,
                           ee_mollifier=ee_mollifier)
            b = b + mc.rhs(mesh_hp, cf, cc)
    return g, b, coeffs, cc


def island_local_solve(mesh_hp, cf, coeffs, cc, s, la, dx):
    """The f64 islands' local solves from the float32 dx: (ds, la) of the
    stretch (zero and `la` without `coeffs`) and, with `cc`, (dd, la) of
    the mixed contact, all float64."""
    dx64 = dx.double()
    if coeffs is not None:
        ds, la = ms.local_solve(mesh_hp, coeffs, s.double(), dx64)
    else:
        ds, la = torch.zeros_like(s, dtype=torch.float64), la.double()
    dd = cla = None
    if cc is not None:
        dd, cla = mc.local_solve(mesh_hp, cf, cc, dx64)
    return ds, la, dd, cla


def island_merit(mesh_hp, bdf_hp, h2, x, s, dx, ds, la, *,
                 use_mixed: bool = True, use_vanilla: bool = False, cf=None,
                 cc=None, dd=None, cla=None, cact=None, dhat: float = 0.0,
                 kappa: float = 0.0, ee_mollifier: bool = False, reduce=None):
    """The f64 islands' merit: a function of alpha giving, in float64, the
    merit at x + alpha dx, s + alpha ds with the multipliers la (the
    stateless polar at every alpha, 0 included), plus with `cc` the mixed
    contact terms at the mixed distances cc.d + alpha dd with the
    multipliers cla over the active mask cact (the JAX step's merit64).
    `reduce` (the element-sharded step's comm.psum) sums the element
    energies over the ranks before the contact terms join."""
    x64, s64, dx64 = x.double(), s.double(), dx.double()

    def merit(a):
        e = _total_energy(mesh_hp, bdf_hp, h2, x64 + a * dx64, s64 + a * ds,
                          la, use_mixed=use_mixed, use_vanilla=use_vanilla)
        if reduce is not None:
            e = reduce(e)
        if cc is not None:
            with record_function("newton.contact"):
                e = e + mixed_contact_merit(
                    cf, x64 + a * dx64, cc.d + a * dd, cact, cla, dhat,
                    kappa, mesh=mesh_hp, ee_mollifier=ee_mollifier)
        return e

    return merit


def check_supported(config: SimConfig) -> str:
    """The solve path of `config`; raises NotImplementedError for what this
    port does not cover and for the JAX step's refusals that depend on the
    configuration alone: a full-system or Laplacian path without the
    mixed-stretch variable. The host paths keep the JAX host loop's own
    checks (newton_direct.newton_step_direct)."""
    solver = factory.resolve_solver(config.solver)
    other = [v for v in config.mixed_variables if v not in _MIXED]
    other += [v for v in config.variables if v not in _NODAL + ("stretch",)]
    if other:
        raise NotImplementedError(f"variables {other}")
    if config.coarse_inverse_method not in ("newton-schulz", "lu"):
        raise ValueError(config.coarse_inverse_method)
    if solver in HOST_SOLVERS:
        return solver
    if "mixed-stretch" not in config.mixed_variables and (
            solver in FULL_SYSTEM
            or solver in ("pcg-laplacian", "pcg-dualascent")):
        raise NotImplementedError(f"{solver} requires mixed-stretch")
    return solver


def check_state(solver: str, config: SimConfig, have_frames: bool,
                gs_plan, hp: bool = False) -> None:
    """The JAX step's refusals that depend on the state or the arguments:
    nodal Hessians (collision, friction; they act only where the state has
    frames) on the ADMM and dual-Schur paths and with f64 islands (`hp`),
    Gauss-Seidel without its coloring, and f64 islands on a path other than
    the condensed pcg family."""
    nodal = have_frames and any(v in config.variables for v in _NODAL)
    vanilla = "stretch" in config.variables
    if solver in ("admm", "minres-kkt-admm") and (nodal or vanilla):
        # the reference asserts that no nodal variable is present
        raise NotImplementedError(
            "the ADMM iteration handles mixed variables only")
    if solver == "gauss-seidel" and gs_plan is None:
        raise ValueError(
            "solver 'gauss-seidel' needs a vertex coloring: pass "
            "gs_plan=gauss_seidel.build_gs_plan(T, nv, ...)")
    if solver == "dual-cg" and (nodal or vanilla):
        raise NotImplementedError(
            "dual-cg eliminates dx via the lumped mass; nodal-Hessian "
            "variables (stretch/collision/friction) need 'pcg' or "
            "'minres-kkt'")
    if hp:
        if nodal:
            raise NotImplementedError(
                "rhs_precision='float64' covers the mixed variables "
                "(stretch + mixed contact); nodal collision/friction "
                "variables run f32 — use dtype='float64' for those")
        if solver not in ISLAND_SOLVERS:
            raise NotImplementedError(
                "rhs_precision='float64' is implemented for the condensed "
                "pcg paths (use dtype='float64' for the full-KKT paths)")


def _select_body(config: SimConfig, solver: str, coarse, matvec_plan,
                 contact: bool, dim: int, *, shell: bool = False,
                 rod: bool = False, hp: bool = False,
                 warm: Optional[bool] = None) -> str:
    """'grid', 'lattice_cg', 'stencil' or 'generic', as the JAX step selects
    its Newton body and linear solve (mixedfem_tpu/optimizer/newton.py:
    387-405 `use_stencil_rows`, :773-783 `use_stencil`, :858-863
    `use_stencil_cg`). A stencil plan with 'pcg' or 'pcg-block-jacobi', no
    contact and no coarse space or a grid one runs on the lattice: the row
    body ('grid') where the JAX step allows it, else the generic body with
    the lattice-resident CG ('lattice_cg': an inertia blend other than 1,
    f64 islands (`hp`), warm-started rotations (`warm`, the step's warm_R;
    None reads config.rotation_warm_start), a recorded vanilla gradient,
    rods). Any other solver, contact or a geometric coarse space
    takes the generic body with the stencil matvec ('stencil'). A shell
    ignores every plan, as in the JAX step ('generic'). Raises for a
    stencil plan of a 2D mesh, which the JAX package's build_stencil_plan
    would not make, and for a stencil plan without the mixed variable or
    with the vanilla one (the JAX step then hands the plan to its gather
    matvec, which does not take it)."""
    if not isinstance(matvec_plan, stmod.StencilPlan) or shell:
        return "generic"
    if dim != 3:
        raise ValueError("a stencil plan of a 2D mesh: stencil plans are 3D")
    if ("mixed-stretch" not in config.mixed_variables
            or "stretch" in config.variables):
        raise NotImplementedError(
            "a stencil plan without the mixed-stretch variable or with the "
            "vanilla stretch variable")
    if (contact or solver not in ("pcg", "pcg-block-jacobi")
            or (coarse is not None and coarse.grid is None)):
        return "stencil"
    if warm is None:
        warm = config.rotation_warm_start
    rows = (not rod and not hp and not warm
            and not config.record_vanilla_gradient
            and config.inertia_blend_factor == 1.0)
    return "grid" if rows else "lattice_cg"


def _line_search(E, eps_E: float, ls_iters: int, merit, alpha0: float = 1.0):
    """Backtracking from alpha0: accept when merit(alpha) < E + eps_E |E|
    (the rounding band; eps_E = 0 is the strict rule merit(alpha) < E);
    (alpha, accepted)."""
    E_thresh = E + eps_E * E.abs() if eps_E else E
    alpha, ls_k = alpha0, 0
    while ls_k < ls_iters and bool(merit(alpha) >= E_thresh):
        alpha *= 0.5
        ls_k += 1
    return alpha, 1.0 if ls_k < ls_iters else 0.0


def check_sharded(mesh, matvec_plan, state) -> None:
    """What the element-sharded step (newton_step with a `comm`) refuses;
    it runs everything else that the single-device step runs, as the JAX
    package's shard_simulation + newton_step does.

    A StencilPlan raises NotImplementedError: the JAX package shards the
    mesh and leaves the plan whole, so its sharded lattice body is the
    single-device step on every device; the port's sharded grid step is
    the I-slab step of parallel/stencil_shard.py. A shell's rest normals,
    a rod's rest frames and lengths and warm-started rotations are per
    element but not padded by the JAX package (its sharded step then fails
    on broadcasting); parallel/sharding.py raises ValueError when their
    element count does not divide by the ranks, so they reach this step
    only whole. The mesh's incidence plan and the banded plan must be the
    rank's from parallel/sharding.py, whose sums are followed by the
    comm's psum (their `reduce`); ValueError otherwise."""
    if isinstance(matvec_plan, stmod.StencilPlan):
        raise NotImplementedError(
            "a StencilPlan with a comm: the element-sharded step shards the "
            "mesh and would hold the whole lattice on every rank; the grid's "
            "sharded step is parallel/stencil_shard.py")
    if mesh.plan.reduce is None or (matvec_plan is not None
                                    and matvec_plan.reduce is None):
        raise ValueError("a plan whose sums are not summed over the ranks: "
                         "shard the mesh and the banded plan with "
                         "parallel/sharding.py")
    per_elem = {"rest_normal": mesh.rest_normal,
                "rod_frames": mesh.rod_frames, "rod_L": mesh.rod_L,
                "R": state.R if state.R.shape[0] else None}
    for name, t in per_elem.items():
        if t is not None and t.shape[0] != mesh.nelem:
            raise ValueError(
                f"{name} holds {t.shape[0]} rows for {mesh.nelem} elements: "
                "shard it with parallel/sharding.py")


def newton_step(
    mesh: meshmod.MeshData,
    config: SimConfig,
    bc_specs: Tuple,
    state: SimState,
    coarse: coarsemod.CoarseSpace | None = None,
    press_specs: Tuple[pressmod.PressSpec, ...] = (),
    matvec_plan: opmod.BandedPlan | stmod.StencilPlan | None = None,
    gs_plan: gsmod.GSPlan | None = None,
    comm=None,
) -> SimState:
    """One implicit BDF timestep. `coarse` enables the two-level
    rigid-body coarse preconditioner (solver 'pcg' only); `matvec_plan`
    (operator.build_banded_plan) sends the condensed matvec and the
    once-per-Newton assemblies through the banded sum (K4 on the card),
    or, a StencilPlan (stencil.build_stencil_plan) of a box grid in
    cell-major element order, through the lattice stencil (K5, K6): for
    'pcg' and 'pcg-block-jacobi' with no coarse space or a grid one
    (coarse.build_coarse_space_grid) the whole Newton iteration runs on
    the lattice (the JAX step's row body) or, where that body is refused,
    the whole CG solve does (_select_body), otherwise only the matvec and
    the assemblies do; a shell ignores the plan. `gs_plan`
    (gauss_seidel.build_gs_plan) is required by 'gauss-seidel'. Contact
    runs over `state.contact` (Simulation.step builds it with the
    broadphase).

    `comm` (parallel/comm.py) makes this the element-sharded step of one
    rank (parallel/sharding.py): `mesh`, `state` and a banded plan hold the
    rank's slice of the elements and the whole vertex arrays. Every
    element-to-vertex sum (over the mesh's incidence plan or the banded
    plan, which this step gives comm.psum as their `reduce`), the merit's
    element energies, the coarse space's pair sums and the element blocks
    of the full-system paths' dot products are followed by comm.psum, the
    element maxima (the Newton decrement's ds part, the Laplacian scale)
    by comm.pmax. The terms over vertices and contact frames (the mass
    diagonal, press forces, every contact term, the broadphase's frames,
    the coarse contact blocks) are every rank's whole and are added once,
    after the sum. check_sharded says what it refuses."""
    solver = check_supported(config)
    if solver in HOST_SOLVERS:
        raise ValueError(
            f"config.solver='{solver}' is a host path "
            "(optimizer/newton_direct.py; Simulation.step routes there); "
            "newton_step runs only the on-device paths")
    cf = state.contact
    have_frames = cf.frames.shape[0] > 0
    dtype, dev = state.x.dtype, state.x.device
    # f64 islands for the cancellation-limited pieces
    hp = config.rhs_precision == "float64" and dtype != torch.float64
    check_state(solver, config, have_frames, gs_plan, hp)
    reduce = None
    if comm is not None:
        check_sharded(mesh, matvec_plan, state)
        reduce = comm.psum
    dt = bdfmod.bdf_dt(state.bdf)
    h2 = dt * dt
    outer = config.outer_steps
    bdf = state.bdf
    if hp:
        # taken before the press forces are added, as in the JAX step
        # (mixedfem_tpu/optimizer/newton.py:292-301): the islands' inertia
        # terms leave a press controller's force out
        mesh_hp, bdf_hp = _cast(mesh, torch.float64), _cast(bdf, torch.float64)

    # dynamic external forces (MechanicalPress controllers)
    if press_specs:
        press_ext = torch.zeros_like(state.x)
        for spec, pst in zip(press_specs, state.press_states):
            press_ext = press_ext + pressmod.press_force(spec, pst, mesh.nv,
                                                         mesh.dim)
        mesh = dataclasses.replace(mesh, ext_force=mesh.ext_force + press_ext)

    def assemble(contrib):
        """(E, k, ...) corner contributions -> (nv, ...), in a fixed order
        (and over the ranks, in rank order, with a comm: the plans'
        `reduce`)."""
        return opmod.assemble(mesh, matvec_plan, contrib)

    def total_energy(*args, **kw):
        """_total_energy, summed over the ranks with a comm."""
        e = _total_energy(*args, **kw)
        return e if reduce is None else reduce(e)

    target = disp.target(mesh, bdf, blend=config.inertia_blend_factor)

    # the Laplacian preconditioner's rest rows and power-iteration
    # estimates of lmax(M) and lmax(L), once per step as in the JAX step
    power_v0 = state.power_v0
    if solver in ("pcg-laplacian", "pcg-dualascent"):
        with record_function("newton.update"):
            GwL = lapmod.laplacian_rows(mesh)
            if power_v0 is None:
                power_v0 = lapmod.default_power_start(state.x.shape, dtype, dev)
            lap_lmax_m = lapmod.power_lmax(
                lapmod.ml_operator(mesh, GwL, 0.0, plan=matvec_plan), power_v0)
            lap_lmax_l = lapmod.power_lmax(
                lapmod.ml_operator(mesh, GwL, 1.0, mass_scale=0.0,
                                   plan=matvec_plan), power_v0)

    use_mixed = "mixed-stretch" in config.mixed_variables
    use_vanilla = "stretch" in config.variables
    record_vg = config.record_vanilla_gradient
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
    warm_R = (config.rotation_warm_start and use_mixed and mesh.dim == 3
              and state.R.shape[0] == mesh.nelem)
    body_kind = _select_body(config, solver, coarse, matvec_plan, any_contact,
                             mesh.dim, shell=mesh.shell, rod=mesh.rod, hp=hp,
                             warm=warm_R)
    if mesh.shell:
        # the JAX step keeps shells off every plan: the assemblies sum over
        # the mesh's incidence plan and the matvec is element_matvec
        matvec_plan = None
    condensed = solver not in FULL_SYSTEM
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
                mesh, coarse,
                ms.update(mesh, state.x, state.s, dt) if use_mixed else None,
                contact0, reduce=reduce)
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

    eye = torch.eye(mesh.dim, dtype=dtype, device=dev)
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

    def inertia_gradient(x):
        """The masked inertia gradient, assembled (K2 or K4)."""
        return meshmod.project_free(mesh, assemble(disp.gradient_contrib(
            mesh, bdf, x, blend=config.inertia_blend_factor)))

    def generic_body(x, s, la, contact, Rcur):
        cd, cla, cact = contact
        inertia_grad = None
        R_prev = Rcur if warm_R else None
        with record_function("newton.update"):
            if hp:
                # the islands: one f64 coefficient update, whose f32 cast
                # the CG uses, and the rhs in f64
                inertia_grad, b, coeffs_hp, cc_hp = island_update(
                    mesh_hp, bdf_hp, x, s, dt,
                    blend=config.inertia_blend_factor, use_mixed=use_mixed,
                    R_prev=R_prev, cf=cf if use_contact else None,
                    contact=contact, dhat=dhat, kappa=kappa,
                    ee_mollifier=config.ee_mollifier)
                inertia_grad, b = inertia_grad.to(dtype), b.to(dtype)
                coeffs = None if coeffs_hp is None else _cast(coeffs_hp, dtype)
                if use_contact:
                    cc = _cast(cc_hp, dtype)
            else:
                coeffs = (ms.update(mesh, x, s, dt, R_prev=R_prev)
                          if use_mixed else None)
            vcc = vstretch.update(mesh, x, dt) if use_vanilla else None
            if condensed:
                # --- assemble: inertia gradient, rhs, block-Jacobi blocks
                if not hp:
                    inertia_grad = inertia_gradient(x)
                    b = -inertia_grad
                    if use_mixed:
                        b = b + meshmod.project_free(
                            mesh, assemble(ms.rhs_contrib(mesh, coeffs, s)))
                if body_kind in ("stencil", "lattice_cg"):
                    # the offset-form blocks (K6); without islands their
                    # o=0 plane is the exact block-Jacobi diagonal
                    W = stmod.assemble_W(matvec_plan, coeffs.Gw,
                                         mesh.mass_coeff)
                if body_kind in ("stencil", "lattice_cg") and not hp:
                    blocks = stmod.diag_blocks(matvec_plan, W)
                else:
                    blocks = mesh.mass_diag[:, None, None] * eye
                    if use_mixed:
                        blocks = blocks + (
                            ms.diag_blocks(mesh, coeffs) if hp else assemble(
                                ms.diag_blocks_contrib(mesh, coeffs)))
            if condensed and use_vanilla:
                b = b - vstretch.gradient(mesh, vcc, matvec_plan)
                blocks = blocks + vstretch.diag_blocks(mesh, vcc, matvec_plan)
            with record_function("newton.contact"):
                if use_contact and not hp:
                    cc = mc.update(mesh, cf, x, cd, cla, cact, dhat, kappa,
                                   ee_mollifier=config.ee_mollifier)
                if use_vcollision:
                    vccol = vcol.update(cf, x, dhat, kappa)
                if use_friction:
                    fcc = fric.update(ffr, x, config.contact_mu, epsv_h)
                if condensed:
                    if use_contact:
                        if not hp:
                            b = b + mc.rhs(mesh, cf, cc)
                        blocks = blocks + mc.diag_blocks(mesh, cf, cc)
                    if use_vcollision:
                        b = b - vcol.gradient(mesh, cf, vccol)
                        blocks = blocks + vcol.diag_blocks(mesh, cf, vccol)
                    if use_friction:
                        b = b - fric.gradient(mesh, ffr, fcc)
                        blocks = blocks + fric.diag_blocks(mesh, ffr, fcc)

        def contact_matvec(p, mixed=True, vanilla=False):
            """The contact Hessians' products summed in the JAX step's
            order: mixed collision (unless `mixed` is false), the vanilla
            stretch (when `vanilla`), nodal collision, friction."""
            y = mc.matvec(mesh, cf, cc, p) if use_contact and mixed else 0.0
            if vanilla:
                y = y + vstretch.matvec(mesh, vcc, p, matvec_plan)
            if use_vcollision:
                y = y + vcol.matvec(mesh, cf, vccol, p)
            if use_friction:
                y = y + fric.matvec(mesh, ffr, fcc, p)
            return y

        def nodal_matvec(p):
            """The x-row products of the full-system paths: the vanilla
            stretch and the nodal contact Hessians."""
            return contact_matvec(p, mixed=False, vanilla=use_vanilla)

        if condensed:
            with record_function("newton.pcg"):
                dx, cg_iters, cg_err = condensed_solve(
                    x, b, blocks, coeffs, vcc, cc if use_contact else None,
                    contact_matvec if any_contact else None,
                    W if body_kind in ("stencil", "lattice_cg") else None)
            with record_function("newton.line_search"):
                # --- local recovery of (ds, la) and of the contact (dd, la)
                if hp:
                    ds64, la64, cdd64, cla64 = island_local_solve(
                        mesh_hp, cf, coeffs_hp, cc_hp if use_contact else None,
                        s, la, dx)
                    ds, la_new = ds64.to(dtype), la64.to(dtype)
                    if use_contact:
                        cdd, cla = cdd64.to(dtype), cla64.to(dtype)
                else:
                    if use_mixed:
                        ds, la_new = ms.local_solve(mesh, coeffs, s, dx)
                    else:
                        ds, la_new = torch.zeros_like(s), la
                    if use_contact:
                        cdd, cla = mc.local_solve(mesh, cf, cc, dx)
        else:
            with record_function("newton.pcg"):
                sol, cg_iters, cg_err = full_system_solve(
                    x, s, la, coeffs, cc if use_contact else None,
                    nodal_matvec, vcc, vccol if use_vcollision else None,
                    fcc if use_friction else None)
            with record_function("newton.line_search"):
                if use_contact:
                    dx, ds, dl, kkt_dd, kkt_dlc = sol
                    # the unknowns (dd, dlc) come with the solution
                    cdd = kkt_dd * cc.active
                    cla = (cc.la + kkt_dlc) * cc.active
                else:
                    dx, ds, dl = sol
                la_new = la + dl

        with record_function("newton.line_search"):
            ds_max = ds.abs().amax()
            if comm is not None:
                ds_max = comm.pmax(ds_max)
            dec_t = torch.maximum(dx.abs().amax(), ds_max)
            if use_contact:
                cd, cact = cc.d, cc.active
                dec_t = torch.maximum(dec_t, cdd.abs().amax())
            else:
                cdd = torch.zeros_like(cd)
            if hp:
                merit = island_merit(
                    mesh_hp, bdf_hp, h2, x, s, dx, ds64, la64,
                    use_mixed=use_mixed, use_vanilla=use_vanilla, cf=cf,
                    cc=cc_hp if use_contact else None, dd=cdd64, cla=cla64,
                    cact=cact, dhat=dhat, kappa=kappa,
                    ee_mollifier=config.ee_mollifier, reduce=reduce)
                # --- merit at the base point (the stateless polar)
                E64 = merit(0.0)
                E = E64.to(dtype)
            else:
                # --- merit at the base point (reuses S(x) from the update)
                E = total_energy(mesh, bdf, h2, x, s, la_new,
                                 Sv=coeffs.Sv if use_mixed else None,
                                 use_mixed=use_mixed, use_vanilla=use_vanilla)
                if any_contact:
                    E = E + contact_energy(x, cd, cact, cla)

                def merit(a):
                    e = total_energy(mesh, bdf, h2, x + a * dx, s + a * ds,
                                     la_new, use_mixed=use_mixed,
                                     use_vanilla=use_vanilla)
                    if any_contact:
                        e = e + contact_energy(x + a * dx, cd + a * cdd, cact,
                                               cla)
                    return e
            # --- the vanilla gradient norm at the iterate
            vg = None
            if record_vg:
                if inertia_grad is None:
                    inertia_grad = inertia_gradient(x)
                vg = torch.linalg.vector_norm(
                    inertia_grad + vstretch.gradient_at(mesh, x, dt,
                                                        matvec_plan))
            # --- the CCD step-size clamp
            alpha0 = 1.0
            if (use_contact or use_vcollision) and config.enable_ccd:
                with record_function("newton.contact"):
                    alpha0 = float(0.9 * accdmod.accd_alpha(
                        cf.frames, cf.ftype, cf.fmask, x, dx))

            if hp:
                # f64 merit: strict acceptance, merit(alpha) < E64
                alpha, accept = _line_search(E64, 0.0, config.ls_iters, merit,
                                             alpha0)
            else:
                alpha, accept = _line_search(E, eps_E, config.ls_iters, merit,
                                             alpha0)
            x = x + (accept * alpha) * dx
            s = s + (accept * alpha) * ds
            cd = cd + (accept * alpha) * cdd
        if warm_R:
            Rcur = coeffs.R
        return (x, s, la_new, (cd, cla, cact), Rcur,
                (E, dec_t, alpha, cg_iters, cg_err, vg))

    def condensed_solve(x, b, blocks, coeffs, vcc, cc, contact_matvec, W):
        """dx of the condensed SPD system (K1 + K2, K1 + K4, or the K5
        matvec, plus the contact Hessians' products): (dx, iterations,
        error). The lattice-CG body solves on the lattice with one round
        trip (the JAX step's `use_stencil_cg` branch)."""
        # warm start: the explicit-Euler prediction
        dx0 = meshmod.project_free(mesh, target - x)
        if body_kind == "lattice_cg":
            dx_l, cg_iters, cg_err = lattice_pcg(
                stmod.to_lat(matvec_plan, b), stmod.to_lat(matvec_plan, dx0),
                blocks, W)
            return stmod.from_lat(matvec_plan, dx_l), cg_iters, cg_err
        if solver in ("pcg-laplacian", "pcg-dualascent"):
            # (M + kL)^{-1} by Chebyshev, k = h^2 * the largest stretch
            # eigenvalue (coeffs.max_evals carry the h^2)
            k_lap = torch.max(coeffs.max_evals)
            if comm is not None:
                k_lap = comm.pmax(k_lap)
            ml_inv = lapmod.build_ml_preconditioner(
                mesh, GwL, k_lap, lap_lmax_m, lap_lmax_l,
                degree=config.lap_cheby_degree, plan=matvec_plan)
            if solver == "pcg-dualascent" and use_contact:
                bj = lapmod.da_apply(ml_inv, mesh, cf, cc,
                                     iters=config.da_iters)
            else:
                # with no frames the dual-ascent solve is the Laplacian's
                bj = ml_inv
        elif solver == "pcg-diag":
            dvec = torch.diagonal(blocks, dim1=-2, dim2=-1)
            dinv = torch.where(dvec > 0, 1.0 / dvec, 1.0)

            def bj(r):
                return r * dinv * mesh.free_mask[:, None]
        else:
            bj = pcgmod.block_jacobi_inv(blocks, mesh.free_mask)
        if coarse is not None:
            tl = coarsemod.two_level_preconditioner(
                coarse, mesh.free_mask, bj, mesh.dim)

            def Minv(r):
                return tl(r, Ac_inv)
        else:
            Minv = bj

        def A(p):
            if W is not None:
                out = stmod.stencil_matvec(matvec_plan, W, p) * \
                    mesh.free_mask[:, None]
            elif matvec_plan is None:
                out = opmod.element_matvec(mesh, p, coeffs, vcc)
            else:
                out = opmod.banded_matvec(mesh, matvec_plan, p, coeffs, vcc)
            if contact_matvec is not None:
                out = out + contact_matvec(p)
            return out

        if solver == "gauss-seidel":
            return gsmod.gs_solve(
                A, b, dx0, bj, gs_plan,
                max_iters=config.max_iterative_solver_iters,
                tol=config.itr_tol)
        return pcgmod.pcg(A, b, dx0, Minv,
                          max_iters=config.max_iterative_solver_iters,
                          tol=config.itr_tol)

    def full_system_solve(x, s, la, coeffs, cc, nodal_matvec, vcc, vccol,
                          fcc):
        """(dx, ds, dl[, dd, dlc]) of the KKT system together: (solution,
        iterations, error)."""
        extra_gx = extra_mv = None
        if vcc is not None or vccol is not None or fcc is not None:
            extra_gx = None
            if vcc is not None:
                extra_gx = vstretch.gradient(mesh, vcc, matvec_plan)
            if vccol is not None:
                gc = vcol.gradient(mesh, cf, vccol)
                extra_gx = gc if extra_gx is None else extra_gx + gc
            if fcc is not None:
                gf = fric.gradient(mesh, ffr, fcc)
                extra_gx = gf if extra_gx is None else extra_gx + gf
            extra_mv = nodal_matvec
        kkt_cf = cf if cc is not None else None
        rhs = mrmod.kkt_rhs(mesh, bdf, coeffs, x, s, la,
                            blend=config.inertia_blend_factor, cf=kkt_cf,
                            cc=cc, extra_grad_x=extra_gx)
        if solver in ("minres-kkt", "minres-kkt-admm"):
            Aop = mrmod.kkt_operator(mesh, coeffs, cf=kkt_cf, cc=cc,
                                     extra_x_matvec=extra_mv)
            if solver == "minres-kkt-admm":
                Mk = admmmod.admm_preconditioner(
                    mesh, coeffs, rho_scale=config.admm_rho_scale,
                    sweeps=config.admm_precond_sweeps,
                    inner_iters=config.admm_inner_iters, cf=kkt_cf, cc=cc,
                    reduce=reduce)
            else:
                Mk = mrmod.kkt_block_diag_preconditioner(mesh, coeffs,
                                                         cf=kkt_cf, cc=cc)
            return mrmod.minres(Aop, rhs, tuple(torch.zeros_like(r) for r in rhs),
                                max_iters=config.max_iterative_solver_iters,
                                tol=config.itr_tol, Minv=Mk,
                                dot=mrmod.kkt_dot(reduce))
        if solver == "admm":
            return admmmod.solve_admm(
                mesh, coeffs, rhs, rho_scale=config.admm_rho_scale,
                max_iters=config.max_iterative_solver_iters,
                tol=config.itr_tol, inner_iters=config.admm_inner_iters,
                cf=kkt_cf, cc=cc, reduce=reduce)
        out = dualmod.solve_dual(mesh, coeffs, rhs,
                                 max_iters=config.max_iterative_solver_iters,
                                 tol=config.itr_tol, cf=kkt_cf, cc=cc,
                                 reduce=reduce)
        return out[:-2], out[-2], out[-1]

    if body_kind in ("grid", "lattice_cg"):
        # per-step hoists of the lattice solve
        plan = matvec_plan
        fm_l = stmod.to_lat(
            plan, mesh.free_mask[:, None].expand(mesh.nv, 3).to(dtype))
        if body_kind == "grid":
            target_l = stmod.to_lat(plan, target)

    def lattice_pcg(b_l, dx0_l, blocks, W):
        """PCG on (3, npad) lattice vectors (the row body's and the
        lattice-CG body's solve): the stencil matvec K5 with the free mask,
        block-Jacobi from the regularized inverse blocks, and the grid
        coarse space through the lattice two-level preconditioner."""
        maskv = mesh.free_mask[:, None, None]
        binv = pcgmod._small_inv(blocks * maskv + eye * (1.0 - maskv)) * maskv
        Minv_lat = stmod.lattice_two_level_preconditioner(
            plan, coarse, mesh.free_mask, binv, 3)

        def Minv_l(rl):
            return Minv_lat(rl, Ac_inv)

        def A_l(pl_):
            return stmod.matvec_lat(plan, W, pl_, fm_l)         # K5

        return pcgmod.pcg(A_l, b_l, dx0_l, Minv_l,
                          max_iters=config.max_iterative_solver_iters,
                          tol=config.itr_tol)

    def grid_body(x, s, la, contact, Rcur):
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
            x_l = stmod.to_lat(plan, x)
            dx_l, cg_iters, cg_err = lattice_pcg(
                b_l, (target_l - x_l) * fm_l, blocks, W)

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
        return (x, s, la_new, contact, Rcur,
                (E, dec_t, alpha, cg_iters, cg_err, None))

    body = grid_body if body_kind == "grid" else generic_body
    stats = empty_stats(outer, dtype, dev)
    x, s, la = state.x, state.s, state.la
    # mixed contact distances, multipliers and active mask of the real
    # frames: fresh every step (frames are detected inside the Newton loop)
    contact = tuple(x.new_zeros((cf.nreal,)) for _ in range(3))
    it = 0
    E_prev = torch.zeros((), dtype=dtype, device=dev)
    dec = res = float("inf")
    Rcur = state.R
    while it < outer and dec > config.newton_tol and res > 1e-12:
        x, s, la, contact, Rcur, (E, dec_t, alpha, cg_iters, cg_err,
                                  vg) = body(x, s, la, contact, Rcur)
        res_t = torch.abs((E - E_prev) / (E + 1e-6))
        stats.energy[it] = E
        stats.energy_res[it] = res_t
        stats.decrement[it] = dec_t
        stats.alpha[it] = alpha
        stats.solver_iters[it] = cg_iters
        stats.solver_error[it] = cg_err
        if vg is not None:
            stats.vanilla_grad[it] = vg
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
        power_v0=power_v0,
        R=Rcur,
    )
