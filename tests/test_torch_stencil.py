"""Parity of mixedfem_tpu_torch's structured-grid stencil path with
mixedfem_tpu's, in float64 on the CPU (the plain versions of kernels K5
stencil_apply and K6 stencil_assemble, and the step's grid and stencil
bodies).

Meshes are box grids of 4x3x2 and 6x4x3 cells (120 and 360 tets) in the
stencil plan's cell-major element order, the bench's cantilever (x=0 face
pinned, gravity). Single functions agree to 1e-12 of their output's scale
(the same f64 algorithms summed in other orders); the 3-step trajectories
are held to 1e-8 on positions of order 1 with equal CG counts, Newton
counts and line-search alphas, over 3 Newton iterations a step. Past 2 of
them the lattice (row) body's merit changes by less than the rounding of
its sums: in the first step's 3rd iteration alpha = 1 lies 3.9e-16
(block-Jacobi) and 5.4e-15 (grid coarse space) under the acceptance
threshold in the port, on a merit of 3.1e-3, and JAX's sums put it above
(ROADMAP Queue C). That alpha alone is exempt, when its margin is within
the merit's rounding scale; the same cases also run 2 Newton iterations
with no exemption."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mixedfem_tpu.config import SimConfig as JConfig
from mixedfem_tpu.mesh import mesh as jmesh
from mixedfem_tpu.ops import stencil as jst
from mixedfem_tpu.optimizer import newton as jnewton
from mixedfem_tpu.solvers import coarse as jcoarse
from mixedfem_tpu.solvers import pcg as jpcg
from mixedfem_tpu.variables import mixed_stretch as jms
from mixedfem_tpu_torch import convert, cuda
from mixedfem_tpu_torch.config import SimConfig as TConfig
from mixedfem_tpu_torch.config import enu_to_lame
from mixedfem_tpu_torch.mesh import generators
from mixedfem_tpu_torch.ops import assembly
from mixedfem_tpu_torch.ops import stencil as tst
from mixedfem_tpu_torch.optimizer import newton as tnewton
from mixedfem_tpu_torch.solvers import coarse as tcoarse
from mixedfem_tpu_torch.solvers import operator as top
from mixedfem_tpu_torch.solvers import pcg as tpcg
from mixedfem_tpu_torch.variables import mixed_stretch as tms

from torch_parity import (  # noqa: F401 (one_torch_thread is a fixture)
    CPU, close, one_torch_thread, port, t64, to_numpy,
)


@pytest.fixture(scope="module", autouse=True)
def _one_thread(one_torch_thread):
    """Every test of this module runs on one torch intra-op thread."""


DT = 0.02
STEP = dict(
    h=DT, outer_steps=3, newton_tol=0.0, itr_tol=1e-4,
    max_iterative_solver_iters=500, coarse_refresh_every=10,
)


def _grid(nx, ny, nz, two_materials=False):
    """Host arrays of a box grid in the plan's element order, and both
    packages' plans and meshes. `two_materials`: the free half of the beam
    (x > 2) is a softer Neo-Hookean solid."""
    V, T0 = generators.box_tet_mesh(nx, ny, nz, size=(4.0, 1.0, 1.0))
    dims = (nx + 1, ny + 1, nz + 1)
    jplan, jperm = jst.build_stencil_plan(T0, len(V), dims)
    tplan, tperm = tst.build_stencil_plan(T0, len(V), dims, device="cpu")
    T = T0[jperm]
    la, mu = enu_to_lame(1e6, 0.45)
    fixed = V[:, 0] < 1e-9
    second = np.zeros(len(T), bool)
    if two_materials:
        second = V[T].mean(axis=1)[:, 0] > 2.0
    kw = dict(
        density=np.full(len(T), 1000.0),
        mu=np.where(second, 0.5 * mu, mu), lam=np.where(second, 0.5 * la, la),
        model_id=second.astype(int),
        models=("Stable-Neohookean", "Neohookean")[:1 + two_materials],
        is_fixed=fixed,
        ext_force=np.tile(np.array([0.0, -9.8, 0.0]), (len(V), 1)),
    )
    jm = jmesh.build_mesh_data(V, T, dtype=jnp.float64, **kw)
    tm, _, _ = port(mesh=jm)
    return dict(V=V, T0=T0, T=T, dims=dims, fixed=fixed, jplan=jplan,
                jperm=jperm, tplan=tplan, tperm=tperm, jm=jm, tm=tm)


@pytest.fixture(scope="module")
def small():
    return _grid(4, 3, 2)


@pytest.fixture(scope="module")
def beam():
    return _grid(6, 4, 3)


@pytest.fixture(scope="module")
def beam_two_materials():
    return _grid(6, 4, 3, two_materials=True)


@pytest.fixture(scope="module")
def coeffs(small):
    """StretchCoeffs of the JAX package at a perturbed state, and the same
    coefficients in the port's type."""
    rng = np.random.default_rng(0)
    jm = small["jm"]
    x = small["V"] + 0.03 * rng.standard_normal(small["V"].shape)
    s = np.asarray(jms.reset(jm, jnp.asarray(x))[0])
    s = s + 0.01 * rng.standard_normal(s.shape)
    j = jms.update(jm, jnp.asarray(x), jnp.asarray(s), DT)
    t = tms.StretchCoeffs(**{k: t64(v) for k, v in to_numpy(j).items()})
    return j, t


def _scale_close(got, ref, tol=1e-12):
    ref = np.asarray(ref)
    close(got, ref, rtol=0, atol=tol * max(np.abs(ref).max(), 1e-300))


@pytest.mark.parametrize("cells", [(4, 3, 2), (6, 4, 3), (3, 2, 4)])
def test_build_stencil_plan(cells):
    """The same permutation, terms, vector terms and masks as the JAX
    build_stencil_plan; 19 of the 27 offsets occur."""
    nx, ny, nz = cells
    V, T = generators.box_tet_mesh(nx, ny, nz)
    dims = (nx + 1, ny + 1, nz + 1)
    jp, jperm = jst.build_stencil_plan(T, len(V), dims)
    tp, tperm = tst.build_stencil_plan(T, len(V), dims, device="cpu")
    np.testing.assert_array_equal(tperm, jperm)
    assert tp.terms == jp.terms and tp.vec_terms == jp.vec_terms
    assert (tp.NI, tp.NJ, tp.NK, tp.nslots) == (jp.NI, jp.NJ, jp.NK, jp.nslots)
    np.testing.assert_array_equal(tp.masks.numpy(), np.asarray(jp.masks))
    assert len(tp.terms) == 2 * 5 * 16 and len(tp.used) == 19
    # the corner table is the mesh's element table in lattice ids
    Tp = T[tperm]
    lat = tst.to_lat(tp, torch.arange(len(V), dtype=torch.float64)[:, None])
    np.testing.assert_array_equal(lat[0, tp.corner_lat].numpy(), Tp)


def test_build_stencil_plan_rejects_non_grids():
    """Both rejections that the JAX package tests: permuted lattice dims,
    and a missing element."""
    V, T = generators.box_tet_mesh(3, 2, 2)
    for T_, dims in ((T, (3, 4, 3)), (T[: len(T) - 2], (4, 3, 3))):
        assert jst.build_stencil_plan(T_, len(V), dims) == (None, None)
        assert tst.build_stencil_plan(T_, len(V), dims, device="cpu") == (
            None, None)
    assert tst.build_stencil_plan(T, len(V), None, device="cpu") == (None, None)


def test_convert_stencil_plan(small):
    """The JAX plan carried across as numpy equals the port's own build."""
    got = convert.stencil_plan_from_numpy(to_numpy(small["jplan"]), CPU)
    tp = small["tplan"]
    assert got.terms == tp.terms and got.used == tp.used
    for f in ("corner_lat", "term_table", "plane_ptr", "masks"):
        assert torch.equal(getattr(got, f), getattr(tp, f)), f


@pytest.mark.parametrize("cells,per_job", [((3, 2, 2), 32), ((1, 1, 1), 16)])
def test_k6_schedule(cells, per_job):
    """K6's host schedule: at every vertex of the padded lattice, each plane
    the terms use is one record in one job of the vertex's parity, and its
    terms, where their cell exists, are the plan's terms of that plane and
    cell parity in the plan's order; the planes no term uses have no record.
    On the 5-tet split the 5 jobs of a pair of vertices hold as many terms
    each: 32, or 16 on a single cell, whose plan has terms of parity 0
    only."""
    V, T = generators.box_tet_mesh(*cells)
    dims = tuple(c + 1 for c in cells)
    plan, _ = tst.build_stencil_plan(T, len(V), dims, device="cpu")
    s = plan.schedule.numpy()
    J0, J = s[0], s[0] + s[1]
    job_ptr = s[4:5 + J]
    recs = s[5 + J:5 + J + 3 * s[2]].reshape(-1, 3)
    ents = s[5 + J + 3 * s[2]:]
    assert len(ents) == s[3]
    rows = plan.term_table.numpy()
    jobs = [[tuple(recs[r]) for r in range(job_ptr[j], job_ptr[j + 1])]
            for j in range(J)]
    assert (J0, J) == (4, 5)
    assert all(sum(e - b for _, b, e in job) == per_job for job in jobs)
    NI, NJ, NK = dims
    by_plane = {o: [t for t in plan.terms if t[5] == o] for o in range(27)}

    def cell_ok(i, j, k, ca):
        c = (i - 1 - ca[0], j - 1 - ca[1], k - 1 - ca[2])
        inside = all(0 <= x < n - 1 for x, n in zip(c, dims))
        return inside, sum(c) % 2

    for i, j, k in np.ndindex(NI + 2, NJ + 2, NK + 2):
        q = (i + j + k) % 2
        mine = [rec for job in (jobs[:J0] if q == 0 else jobs[J0:])
                for rec in job]
        planes = [o for o, _, _ in mine]
        assert sorted(planes) == list(plan.used)
        for o, b, e in mine:
            got = []
            for r in ents[b:e]:
                t, a, bb, p, ca = (rows[r, 0], rows[r, 1], rows[r, 2],
                                   rows[r, 3], tuple(rows[r, 4:7]))
                if cell_ok(i, j, k, ca)[0]:
                    got.append((p, t, a, bb, ca))
            want = [(p, t, a, bb, ca) for (p, t, a, bb, ca, _o) in by_plane[o]
                    if cell_ok(i, j, k, ca) == (True, p)]
            assert got == want, ((i, j, k), o)


def test_assemble_W_and_diag_blocks(small, coeffs):
    j, t = coeffs
    jm, tm, jp, tp = small["jm"], small["tm"], small["jplan"], small["tplan"]
    Wj = jst.assemble_W(jp, j.Gw, jm.mass_coeff)
    Wt = tst.assemble_W(tp, t.Gw, tm.mass_coeff)
    _scale_close(Wt, Wj)
    unused = [o for o in range(27) if o not in tp.used]
    assert len(unused) == 8 and not Wt[unused].any()
    _scale_close(tst.diag_blocks(tp, Wt), jst.diag_blocks(jp, Wj))


def test_assemble_W_checks_element_count(small, coeffs):
    _, t = coeffs
    with pytest.raises(ValueError, match="elements for"):
        tst.assemble_W(small["tplan"], t.Gw[:-5], small["tm"].mass_coeff[:-5])


def test_matvec_lat_and_stencil_matvec(small, coeffs):
    """Against the JAX stencil, and against the port's element matvec
    (K1 + K2's function) on the same coefficients."""
    j, t = coeffs
    jm, tm, jp, tp = small["jm"], small["tm"], small["jplan"], small["tplan"]
    Wj = jst.assemble_W(jp, j.Gw, jm.mass_coeff)
    Wt = tst.assemble_W(tp, t.Gw, tm.mass_coeff)
    rng = np.random.default_rng(1)
    p = rng.standard_normal((tm.nv, 3)) * np.asarray(jm.free_mask)[:, None]
    ref = jst.stencil_matvec(jp, Wj, jnp.asarray(p))
    got = tst.stencil_matvec(tp, Wt, t64(p))
    _scale_close(got, ref)
    elem = top.element_matvec(tm, t64(p), t)
    _scale_close(got * tm.free_mask[:, None], elem)
    # on lattice vectors, with the CG's free mask fused
    xl = jst.to_lat(jp, jnp.asarray(p))
    fm = jst.to_lat(jp, jnp.broadcast_to(jm.free_mask[:, None], (jm.nv, 3)))
    ref_l = jst.matvec_lat(jp, Wj, xl) * fm
    got_l = tst.matvec_lat(tp, Wt, tst.to_lat(tp, t64(p)), t64(fm))
    _scale_close(got_l, ref_l)
    close(tst.to_lat(tp, t64(p)), xl, rtol=0, atol=0)
    close(tst.from_lat(tp, got_l), jst.from_lat(jp, ref_l), rtol=0,
          atol=1e-12 * float(jnp.abs(ref_l).max()))


def test_stencil_apply_plain_zeroes_ghosts(small):
    """K5's function writes zeros at the ghost vertices even where W has
    rows there (the kernel never reads a ghost's shifts)."""
    tp = small["tplan"]
    rng = np.random.default_rng(2)
    W = t64(rng.standard_normal((27, 3, 3, tp.npad)))
    x = t64(rng.standard_normal((3, tp.npad)))
    y = tst.stencil_apply_plain(tp, W, x)
    ghost = tst.to_lat(tp, torch.ones(tp.nv, 1, dtype=torch.float64))[0] == 0
    assert not y[:, ghost].any() and y[:, ~ghost].abs().min() > 0


def test_gather_and_scatter(small):
    """The corner gather; the JAX scatter_vec against K2's function over
    the mesh's incidence plan, and scatter_rows_lat."""
    jp, tp, jm, tm = small["jplan"], small["tplan"], small["jm"], small["tm"]
    rng = np.random.default_rng(3)
    E = jm.T.shape[0]
    xl = jst.to_lat(jp, jnp.asarray(rng.standard_normal((jm.nv, 3))))
    close(tst.gather_corners_lat(tp, t64(xl)), jst.gather_corners_lat(jp, xl),
          rtol=0, atol=0)
    rows = rng.standard_normal((E, 4, 3))
    _scale_close(assembly.segment_sum(tm.plan, t64(rows)),
                 jst.scatter_vec(jp, jnp.asarray(rows)))
    rows9 = rng.standard_normal((E, 4, 9))
    _scale_close(assembly.segment_sum(tm.plan, t64(rows9)),
                 jst.scatter_vec(jp, jnp.asarray(rows9)))
    feat = rng.standard_normal((12, E))
    _scale_close(tst.scatter_rows_lat(tp, tm.plan, t64(feat), 3),
                 jst.scatter_rows_lat(jp, jnp.asarray(feat), 3))


@pytest.fixture(scope="module")
def grid_coarse(beam):
    args = (beam["V"], beam["T"], beam["fixed"], beam["dims"])
    jc = jcoarse.build_coarse_space_grid(*args, dtype=jnp.float64)
    tc = tcoarse.build_coarse_space_grid(*args, dtype=torch.float64,
                                         device="cpu")
    return jc, tc


@pytest.mark.parametrize("block", [None, (2, 2, 3)])
def test_build_coarse_space_grid(beam, block):
    args = (beam["V"], beam["T"], beam["fixed"], beam["dims"])
    jc = jcoarse.build_coarse_space_grid(*args, block=block, dtype=jnp.float64)
    tc = tcoarse.build_coarse_space_grid(*args, block=block,
                                         dtype=torch.float64, device="cpu")
    assert tc.grid == jc.grid and tc.naggr == jc.naggr and tc.naggr > 1
    for f in ("agg_id", "pair_id", "pair_rows", "pair_cols"):
        np.testing.assert_array_equal(getattr(tc, f).numpy(),
                                      np.asarray(getattr(jc, f)))
    close(tc.r, jc.r, rtol=0, atol=1e-15)
    # carried across from JAX, the marker and the plans come along
    _, _, cc = port(coarse=jc)
    assert cc.grid == jc.grid and cc.pair_plan.nrows == tc.pair_plan.nrows


def _spd_blocks(nv, seed):
    A = np.random.default_rng(seed).standard_normal((nv, 3, 3))
    return np.einsum("nij,nkj->nik", A, A) + np.eye(3)


def _ac_inv(naggr, seed):
    A = np.random.default_rng(seed).standard_normal((6 * naggr, 6 * naggr))
    return np.linalg.inv(A @ A.T + 6 * naggr * np.eye(6 * naggr))


def test_lattice_two_level_preconditioner(beam, grid_coarse):
    jc, tc = grid_coarse
    jm, tm, jp, tp = beam["jm"], beam["tm"], beam["jplan"], beam["tplan"]
    blocks = _spd_blocks(jm.nv, 4)
    fm = np.asarray(jm.free_mask)
    binv = np.linalg.inv(blocks) * fm[:, None, None]
    rl = jst.to_lat(jp, jnp.asarray(np.random.default_rng(5).standard_normal(
        (jm.nv, 3))))
    Ac_inv = _ac_inv(jc.naggr, 6)
    for cj, ct in ((jc, tc), (None, None)):
        ref = jst.lattice_two_level_preconditioner(
            jp, cj, jm.free_mask, jnp.asarray(binv), 3)(rl, jnp.asarray(Ac_inv))
        got = tst.lattice_two_level_preconditioner(
            tp, ct, tm.free_mask, t64(binv), 3)(t64(rl), t64(Ac_inv))
        _scale_close(got, ref)
    with pytest.raises(ValueError, match="grid coarse space"):
        geo = tcoarse.build_coarse_space(beam["V"], beam["T"], beam["fixed"],
                                         target_size=8, dtype=torch.float64,
                                         device="cpu")
        tst.lattice_two_level_preconditioner(tp, geo, tm.free_mask, t64(binv))


def test_two_level_preconditioner_grid_branch(beam, grid_coarse):
    """The (nv, 3) two-level preconditioner of a grid coarse space: lattice
    reshape-sums instead of the aggregate segment sum."""
    jc, tc = grid_coarse
    jm, tm = beam["jm"], beam["tm"]
    blocks = _spd_blocks(jm.nv, 7)
    r = np.random.default_rng(8).standard_normal((jm.nv, 3))
    Ac_inv = _ac_inv(jc.naggr, 9)
    ref = jcoarse.two_level_preconditioner(
        jc, jm.free_mask, jpcg.block_jacobi_inv(jnp.asarray(blocks),
                                                jm.free_mask), 3
    )(jnp.asarray(r), jnp.asarray(Ac_inv))
    got = tcoarse.two_level_preconditioner(
        tc, tm.free_mask, tpcg.block_jacobi_inv(t64(blocks), tm.free_mask)
    )(t64(r), t64(Ac_inv))
    _scale_close(got, ref)


CASES = {
    # (a) the bench's configuration: grid body, grid coarse space
    "grid_coarse": dict(solver="pcg", coarse="grid", newton=3),
    # (b) grid body, block-Jacobi alone
    "grid_block_jacobi": dict(solver="pcg-block-jacobi", coarse=None,
                              newton=3),
    # (a) and (b) stopped before the 3rd Newton iteration, whose
    # accept/reject decision in the first step is rounding: no exemption
    "grid_coarse_2newton": dict(solver="pcg", coarse="grid", newton=2),
    "grid_block_jacobi_2newton": dict(solver="pcg-block-jacobi", coarse=None,
                                      newton=2),
    # (c) entry()'s configuration: stencil matvec in the generic body with
    # a geometric coarse space
    "stencil_geometric": dict(solver="pcg", coarse="geometric", newton=3),
    # (a) on a beam of two materials (per-element model dispatch)
    "grid_two_materials": dict(solver="pcg", coarse="grid", newton=3,
                               mesh="beam_two_materials"),
}


@pytest.fixture(scope="module", params=list(CASES))
def trajectory(request):
    """Both packages' 3 steps, and the port's line-search margins: for each
    Newton iteration, merit(1) minus the acceptance threshold and E."""
    case = CASES[request.param]
    beam = request.getfixturevalue(case.get("mesh", "beam"))
    V, T, jm, jp = beam["V"], beam["T"], beam["jm"], beam["jplan"]
    cfg = dict(STEP, solver=case["solver"], outer_steps=case["newton"])
    jcfg, tcfg = JConfig(**cfg), TConfig(**cfg)
    if case["coarse"] == "grid":
        jc = jcoarse.build_coarse_space_grid(V, T, beam["fixed"], beam["dims"],
                                             dtype=jnp.float64)
    elif case["coarse"] == "geometric":
        jc = jcoarse.build_coarse_space(V, T, beam["fixed"], target_size=8,
                                        dtype=jnp.float64)
    else:
        jc = None
    x0 = jnp.asarray(V)
    st = jnewton.init_state(jm, jcfg, (), x0, jnp.zeros_like(x0))
    if jc is not None:
        st = st.replace(precond=jnp.zeros((jc.ncd, jc.ncd)))
    tm, ts, tc = port(mesh=jm, state=st, coarse=jc)
    tp = convert.stencil_plan_from_numpy(to_numpy(jp), CPU)
    margins = []
    line_search = tnewton._line_search

    def recording(E, eps_E, ls_iters, merit, alpha0=1.0):
        thresh = E + eps_E * E.abs()
        margins.append((float(merit(1.0) - thresh), float(E)))
        return line_search(E, eps_E, ls_iters, merit, alpha0)

    out = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tnewton, "_line_search", recording)
        for _ in range(3):
            st = jnewton.newton_step(jm, jcfg, (), st, jc, (), jp)
            ts = tnewton.newton_step(tm, tcfg, (), ts, tc, (), tp)
            out.append((to_numpy(st), ts))
    n = case["newton"]
    # the rounding scale of the merit: each element's elastic energy is
    # O(mu + lam) terms that cancel to a small psi, weighted by h^2 vol
    ulp = (torch.finfo(torch.float64).eps * DT ** 2
           * float((tm.vols * (tm.mu + tm.lam)).sum()))
    return (request.param, out,
            [margins[i * n:(i + 1) * n] for i in range(3)], ulp)


def test_trajectory(trajectory):
    """3 steps: positions and stretches to 1e-8, equal CG and Newton
    counts, energies to 1e-10 relative, decrements to 1e-6, and equal
    line-search alphas, except in an iteration where alpha = 1 lies within
    the merit's rounding scale of the acceptance threshold in the port.
    There the decision is rounding; the margin is printed,
    and the energies and decrements of the iterations after it (which start
    from states a rounding-level step apart) are not compared."""
    name, out, margins, ulp = trajectory
    flipped = False
    for step, ((js, ts), marg) in enumerate(zip(out, margins)):
        close(ts.x, js["x"], rtol=0, atol=1e-8)
        close(ts.s, js["s"], rtol=0, atol=1e-8)
        assert not ts.la.any()
        st = js["stats"]
        assert ts.stats.iterations == int(st["iterations"]) == \
            CASES[name]["newton"]
        np.testing.assert_array_equal(ts.stats.solver_iters.numpy(),
                                      st["solver_iters"])
        for it, (a_t, a_j) in enumerate(zip(ts.stats.alpha.tolist(),
                                            st["alpha"])):
            if not flipped:
                close(ts.stats.energy[it], st["energy"][it], rtol=1e-10)
                close(ts.stats.decrement[it], st["decrement"][it],
                      rtol=1e-6, atol=1e-12)
            if a_t != a_j:
                margin, E = marg[it]
                print(f"{name} step {step} Newton {it}: alpha {a_t} in the "
                      f"port, {a_j} in JAX; merit(1) - threshold = "
                      f"{margin:.3e} on E = {E:.6e}, rounding scale "
                      f"{ulp:.3e}")
                assert abs(margin) <= ulp, (name, step, it)
                flipped = True
        if name == "grid_coarse":
            close(ts.precond, js["precond"], rtol=1e-8,
                  atol=1e-10 * np.abs(js["precond"]).max())


def test_stencil_step_goes_through_no_kernel_on_the_cpu(beam):
    """On the CPU the stencil step runs the plain versions: no launch is
    counted, and the element-major state comes back."""
    tm, tp = beam["tm"], beam["tplan"]
    cfg = TConfig(**dict(STEP, outer_steps=1, solver="pcg-block-jacobi"))
    x0 = t64(beam["V"])
    st = tnewton.init_state(tm, cfg, (), x0, torch.zeros_like(x0))
    cuda.LAUNCHES.clear()
    st = tnewton.newton_step(tm, cfg, (), st, None, (), tp)
    assert sum(cuda.LAUNCHES.values()) == 0
    assert st.s.shape == (tm.nelem, 6) and st.x.shape == (tm.nv, 3)
    assert st.stats.iterations == 1 and torch.isfinite(st.x).all()


def test_stencil_step_rejects_uncovered_branch(beam):
    """The JAX step's element-major lattice-CG branch (a stencil plan whose
    inertia blend differs from 1) no longer raises: the port takes it as
    the 'lattice_cg' body (held to the JAX step in
    tests/test_torch_lattice_cg.py), and no other body."""
    tm, tp = beam["tm"], beam["tplan"]
    cfg = TConfig(**dict(STEP, outer_steps=1, inertia_blend_factor=0.5))
    assert tnewton._select_body(cfg, cfg.solver, None, tp, False,
                                3) == "lattice_cg"
    x0 = t64(beam["V"])
    st = tnewton.init_state(tm, cfg, (), x0, torch.zeros_like(x0))
    st = tnewton.newton_step(tm, cfg, (), st, None, (), tp)
    assert st.stats.iterations == 1 and torch.isfinite(st.x).all()
