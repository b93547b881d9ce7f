#!/usr/bin/env python3
"""Drive mixedfem_tpu_torch on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py [--profile DIR]

Run from the root of a checkout. Phases, none of which catches its own
failure:

1. card: exit non-zero when torch.cuda.is_available() is false; print the
   card's name and power limit (nvidia-smi).
2. build: compile mixedfem_tpu_torch/csrc/kernels.cu with nvcc for sm_90a.
3. kernels: hold K1 (element_apply), K2 (segment_sum at the widths the step
   uses: 3, 9, the coarse restriction's 6 and the coarse Galerkin sums'
   36, whose plan splits long segments into pieces), K3 (contract_G_Gw)
   and K4 (banded_sum at 3 and 9, on the banded beam's plan, W=896, and on
   the scene's plan of phase 6, whose vertex ids are unordered, W=22,400)
   to their plain PyTorch versions at the 100k-tet shapes, in float32 (to
   1e-5 of the output's scale: the plain versions run index_add_, which
   adds in another order on the card) and float64 (to 1e-12); time each
   kernel (the whole wrapper call: K2 with pieces launches twice), its
   plain version and the one PyTorch call that computes the same function
   where there is one, and K4's rows also through K2 over the mesh's
   incidence plan (the same vertex sum); time K2 at m=36 over the pair
   plan split at several piece lengths L, the sweep that chose L; time K3
   in float64 too, and at each tile size TE (elements per block) in both
   types, the sweep that chose TE. K5 (stencil_apply) and K6
   (stencil_assemble) are held to theirs on the bench's 100k-tet box grid
   of phase 8 in both types and timed in both; K5 cold (W copies larger
   than L2, as every other kernel is timed) and hot (the same W, fresh x,
   as the CG loop reads it). K2 is also held to its plain version and
   timed at the contact shapes of phase 11's scene: the frame plan of its
   first candidate set at m=3 (contact rhs and matvec) and m=9 (contact
   diagonal blocks), and the coarse contact pair plan of its first
   refresh (the frames active at the start) at m=36.
4. main path: the bench's 100k-tet beam (bench.py:build(40, 25, 20),
   banded element order, x=0 face pinned, gravity; Stable-Neo-Hookean,
   BDF1, h=0.02, 5 Newton iterations, itr_tol 1e-4, two-level coarse space
   of target size 48 refreshed every 10 steps) in float32 through
   newton_step: one warm-up step and three timed steps, host clock around
   work that ends in torch.cuda.synchronize(). Every launch counter is set
   to 0 just before and read just after; each kernel must have run.
5. trajectory: a 1000-tet beam, 3 float64 steps, on the card with the
   kernels and on the CPU with the plain versions: positions agree to 1e-9
   relative and the CG counts are equal.
6. scene path: the same 100k-tet beam with its vertex ids in a seeded
   random order, written as a .mesh with a scene JSON (twist BC, gravity,
   SNH, BDF1, dt 0.02, 5 Newton iterations, itr_tol 1e-4, default solver:
   pcg with the two-level coarse space refreshed every step) into a
   temporary directory, loaded with load_scene on the card (banded element
   order and plan: every assembly and CG matvec goes through K4) and
   stepped through Simulation.step in float32: one warm-up step and three
   timed steps, counters set to 0 just before and read just after.
7. scene trajectory: a 2000-tet scene (load_scene builds the banded plan
   and the coarse space), 3 float64 steps of 3 Newton iterations, on the
   card and on the CPU (the same loaded objects moved there, so the plain
   versions run over the same element order and plan): positions agree to
   1e-9 of scale, CG and Newton counts are equal.
8. grid path: the bench's headline configuration (bench.py:build(40, 25,
   20) with its stencil plan and element permutation, value_stencil_100k):
   the same beam in cell-major element order with the lattice-block coarse
   space of build_coarse_space_grid, refreshed every 10 steps, in float32
   through newton_step with the StencilPlan (the lattice body: K3, K6,
   K5, K2): one warm-up step and three timed steps, counters set to 0
   just before and read just after; then one float64 step of the same
   beam.
9. grid trajectory: a 1500-tet box grid, 3 float64 steps of 3 Newton
   iterations with a grid coarse space, on the card and on the CPU:
   positions agree to 1e-9 of scale, CG and Newton counts are equal.
10. grid float64 step: one float64 step of phase 8's 100k-tet grid, whose
   CG counts stand beside the float32 ones.
11. contact scene: a slab box_tet_mesh(60, 4, 60) over (2.0, 0.1, 2.0)
   held at its far x end by a hangends BC, and on it a free
   box_tet_mesh(16, 16, 16) over (0.5, 0.5, 0.5) whose bottom lies half
   of dhat above the slab (92,480 tets, 23,518 vertices), as .mesh files
   and a scene JSON that omits mixed_variables, so the loader's default
   adds mixed-collision: SNH (E=1e6, nu=0.4, rho=1000), gravity, BDF1,
   dt 0.01, CCD on, dhat 1e-2, kappa 1e5, 5 Newton iterations, pcg with
   the two-level coarse space; loaded on the card in float32 and stepped
   through Simulation.step (broadphase, ACCD, the retry): one warm-up
   step and three timed steps, counters set to 0 just before and read
   just after. It prints ms per step and per Newton iteration, CG per
   Newton, candidate and active frame counts, retries, the broadphase's
   host ms per step and the least mixed distance, which must be > 0.
12. contact trajectory: the drop scene of tests/test_collision.py (a
   pinned slab and a box 2 dhat above it, dhat 3e-2) written as a scene,
   3 float64 steps of 3 Newton iterations on the card and on the CPU:
   positions agree to 1e-9 of scale; Newton counts, CG counts and active
   frames per iteration are equal.
13. one JSON line of kernel results, then the device line last.

--profile DIR additionally traces one more step of each main path with
torch.profiler, logs the device time of each hand kernel in it, and writes
the per-kernel tables to DIR/profile_step.txt (phase 4),
DIR/profile_scene_step.txt (phase 6), DIR/profile_grid_step.txt
(phase 8) and DIR/profile_contact_step.txt (phase 11).
"""

from __future__ import annotations

import argparse
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

# published H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, and FLOP/s
# outside the tensor cores for float32 and float64
PEAK_BYTES = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.float64: 34e12}
L2_BYTES = 50 * 2**20


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# phase 1: the card
# ---------------------------------------------------------------------------

def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# the bench's beam
# ---------------------------------------------------------------------------

def _sim(V, T, dtype, device):
    """bench.py:build's mesh, config and initial state on the port."""
    from mixedfem_tpu_torch.config import SimConfig, enu_to_lame
    from mixedfem_tpu_torch.mesh import mesh as meshmod
    from mixedfem_tpu_torch.optimizer import newton

    la, mu = enu_to_lame(1e6, 0.45)
    mesh = meshmod.build_mesh_data(
        V, T,
        density=np.full(len(T), 1000.0), mu=np.full(len(T), mu),
        lam=np.full(len(T), la), model_id=np.zeros(len(T), int),
        models=("Stable-Neohookean",), is_fixed=V[:, 0] < 1e-9,
        ext_force=np.tile(np.array([0.0, -9.8, 0.0]), (len(V), 1)),
        dtype=dtype, device=device,
    )
    config = SimConfig(
        h=0.02, outer_steps=5, newton_tol=0.0, max_iterative_solver_iters=500,
        itr_tol=1e-4, coarse_refresh_every=10,
        dtype="float64" if dtype == torch.float64 else "float32",
    )
    x0 = torch.tensor(V, dtype=dtype, device=device)
    return mesh, config, newton.init_state(mesh, config, (), x0,
                                           torch.zeros_like(x0))


def beam(nx, ny, nz, dtype, device):
    """bench.py:build on the port, banded element order: mesh, config,
    initial state, geometric coarse space."""
    from mixedfem_tpu_torch.mesh import generators
    from mixedfem_tpu_torch.solvers import coarse as coarsemod
    from mixedfem_tpu_torch.solvers.operator import sort_elements_banded

    V, T = generators.box_tet_mesh(nx, ny, nz, size=(4.0, 1.0, 1.0))
    T = T[sort_elements_banded(T)]
    mesh, config, state = _sim(V, T, dtype, device)
    cs = coarsemod.build_coarse_space(
        V, T, V[:, 0] < 1e-9, target_size=48, dtype=dtype, device=device
    )
    return mesh, config, state, cs


def grid_beam(nx, ny, nz, dtype, device):
    """bench.py:build on the port with its stencil plan: the element
    permutation of build_stencil_plan, the lattice-block coarse space of
    build_coarse_space_grid and a zero coarse cache (bench.py:339-360).
    Mesh, config, initial state, coarse space, plan."""
    from mixedfem_tpu_torch.mesh import generators
    from mixedfem_tpu_torch.ops import stencil as stmod
    from mixedfem_tpu_torch.solvers import coarse as coarsemod

    V, T = generators.box_tet_mesh(nx, ny, nz, size=(4.0, 1.0, 1.0))
    dims = (nx + 1, ny + 1, nz + 1)
    plan, perm = stmod.build_stencil_plan(T, len(V), dims, device=device)
    if plan is None:
        raise AssertionError("the box grid was not recognised as one")
    T = T[perm]
    mesh, config, state = _sim(V, T, dtype, device)
    cs = coarsemod.build_coarse_space_grid(V, T, V[:, 0] < 1e-9, dims,
                                           dtype=dtype, device=device)
    state.precond = torch.zeros((cs.ncd, cs.ncd), dtype=dtype, device=device)
    return mesh, config, state, cs, plan


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def device_ms(fn, arg_sets, reps=30) -> float:
    """Device time of one call, from CUDA events around `reps` calls that
    cycle through `arg_sets` (copies of the inputs, together larger than the
    L2 cache, so every call reads its inputs from device memory). A sleep
    kernel ahead of the window keeps the stream busy while the host
    enqueues, so the window holds device time, not launch overhead."""
    for args in arg_sets:
        fn(*args)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(reps):
        fn(*arg_sets[i % len(arg_sets)])
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(2e9 * (2.0 * host_s + 1e-3)))  # ~2 GHz clock
    start.record()
    for i in range(reps):
        fn(*arg_sets[i % len(arg_sets)])
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def copies(make, bytes_per_set):
    n = min(16, max(2, math.ceil(2 * L2_BYTES / max(bytes_per_set, 1)) + 1))
    return [make() for _ in range(n)]


def step_inputs(mesh, state, dt):
    """What the main path hands the kernels: D, Hs, Gw at a perturbed state
    of `mesh`, a vector p, and the corner rows of the matvec (m=3) and of
    the diagonal blocks (m=9)."""
    from mixedfem_tpu_torch.materials import models as mat
    from mixedfem_tpu_torch.mesh import mesh as meshmod
    from mixedfem_tpu_torch.ops import psd, rotation, smallops
    from mixedfem_tpu_torch.solvers import operator as opmod
    from mixedfem_tpu_torch.variables import mixed_stretch as ms

    g = torch.Generator(device=mesh.device).manual_seed(0)
    dev, dtype = mesh.device, mesh.vols.dtype
    x = state.x + 0.01 * torch.randn(state.x.shape, generator=g, device=dev,
                                     dtype=dtype) * mesh.free_mask[:, None]
    s = ms.reset(mesh, x)[0]
    R, S = rotation.polar33(meshmod.def_grad(mesh, x))
    D = rotation.dsdF33(R, S).contiguous()
    Hs = psd.psd_fix_sqrt(dt * dt * mat.hess_s_all(
        s, mesh.mu, mesh.lam, mesh.model_id, mesh.models), tol=1e-8)[2]
    Hs = Hs.contiguous()
    Gw = smallops.contract_G_Gw_plain(D, mesh.dphidX, Hs, mesh.vols)[1]
    Gw = Gw.contiguous()
    p = torch.randn((mesh.nv, 3), generator=g, device=dev, dtype=dtype)
    rows3 = opmod.element_apply_plain(
        mesh.T, Gw, mesh.mass_coeff, mesh.free_mask, p).reshape(-1, 3)
    rows3 = rows3.contiguous()
    rows9 = torch.einsum("eikr,eiks->ekrs", Gw, Gw).reshape(-1, 9).contiguous()
    return dict(D=D, Hs=Hs, Gw=Gw, p=p, rows3=rows3, rows9=rows9, g=g)


def kernel_cases(mesh, cs, state, dt):
    """K1, K2 and K3 on the inputs the main path gives them: the
    coefficients at a perturbed state of the 100k-tet beam."""
    from mixedfem_tpu_torch import cuda
    from mixedfem_tpu_torch.ops import assembly, smallops
    from mixedfem_tpu_torch.solvers import operator as opmod

    dev, dtype = mesh.device, mesh.vols.dtype
    ins = step_inputs(mesh, state, dt)
    D, Hs, Gw, p, g = ins["D"], ins["Hs"], ins["Gw"], ins["p"], ins["g"]
    rows3, rows9 = ins["rows3"], ins["rows9"]
    rows6 = torch.randn((mesh.nv, 6), generator=g, device=dev, dtype=dtype)
    rows36 = torch.randn((cs.pair_plan.slots.shape[0], 36), generator=g,
                         device=dev, dtype=dtype)
    E = mesh.nelem
    seg_v = mesh.T.reshape(-1).long()

    def k2_case(name, plan, rows, seg):
        base = torch.zeros((plan.nseg, rows.shape[1]), dtype=dtype, device=dev)
        ins = (plan.row_ptr, plan.slots, rows)
        return dict(
            name=name, replaces="mixedfem_tpu/ops/brick.py:442",
            kernel=k2, plain=assembly.segment_sum_plain,
            library=lambda pl, r: torch.index_add(base, 0, seg, r),
            make=lambda: (clone(plan), rows.clone()),
            # what the function must move: rows, slots, row_ptr, out (the
            # plan's piece arrays are not counted)
            bytes=nbytes(*ins) + plan.nseg * rows.shape[1] * rows.element_size(),
            flops=rows.numel(),
            npieces=plan.npieces,
        )

    k1_ins = (mesh.T, Gw, mesh.mass_coeff, mesh.free_mask, p)
    k3_ins = (D, mesh.dphidX, Hs, mesh.vols)
    sq = torch.sqrt(mesh.vols)

    def k3_library(D_, dphi, Hs_, vols):
        G = torch.einsum("eirc,ekc->eikr", D_, dphi)
        return G, torch.einsum("e,eij,ejkr->eikr", sq, Hs_, G)

    return [
        dict(
            name="element_apply", replaces="mixedfem_tpu/ops/brick.py:176",
            kernel=cuda.element_apply, plain=opmod.element_apply_plain,
            library=None, make=lambda: tuple(t.clone() for t in k1_ins),
            bytes=nbytes(*k1_ins) + E * 12 * p.element_size(),
            # per element: 12 mask products, Gw pe and Gw^T q (2 x 72 FMA),
            # mass (48 FMA)
            flops=E * (12 + 2 * 144 + 96),
        ),
        k2_case("segment_sum_m3", mesh.plan, rows3, seg_v),
        k2_case("segment_sum_m9", mesh.plan, rows9, seg_v),
        k2_case("segment_sum_m6", cs.agg_plan, rows6, cs.agg_id),
        k2_case("segment_sum_m36", cs.pair_plan, rows36, cs.pair_id.reshape(-1)),
        dict(
            name="contract_G_Gw", replaces="mixedfem_tpu/ops/smallops.py:22",
            kernel=cuda.contract_G_Gw, plain=smallops.contract_G_Gw_plain,
            library=k3_library,
            make=lambda: tuple(t.clone() for t in k3_ins),
            bytes=nbytes(*k3_ins) + 2 * E * 72 * D.element_size(),
            # per element: G (72 x 3 FMA), Hs G (72 x 6 FMA), scale (72)
            flops=E * (2 * 216 + 2 * 432 + 72),
        ),
    ]


def clone(obj):
    """A copy of a plan dataclass with every tensor field cloned, nested
    plans included."""
    import dataclasses

    def c(v):
        if torch.is_tensor(v):
            return v.clone()
        return clone(v) if dataclasses.is_dataclass(v) else v

    return dataclasses.replace(obj, **{
        f.name: c(getattr(obj, f.name)) for f in dataclasses.fields(obj)})


def k2(pl, rows):
    """K2's launcher over incidence plan `pl`, pieces included."""
    from mixedfem_tpu_torch import cuda

    return cuda.segment_sum(pl.row_ptr, pl.slots, rows, pl.nseg, pl.piece_ptr,
                            pl.seg_pieces)


def plan_line(name, pl) -> str:
    from mixedfem_tpu_torch.ops import assembly

    longest = int(pl.row_ptr.diff().max()) if pl.nseg else 0
    return (f"{name}: {pl.nseg} segments, {pl.nrows} rows, longest {longest}, "
            f"L {assembly.PIECE_ROWS}, "
            f"pieces {pl.npieces if pl.piece_ptr is not None else 0}")


def piece_sweep(cs, rows36, Ls=(64, 128, 256, 512, 1024, 2**30)):
    """K2 at m=36 (whole wrapper call) over the coarse pair plan split at
    each piece length L (2**30: no pieces), device us per call."""
    from mixedfem_tpu_torch.ops import assembly

    seg = cs.pair_id.reshape(-1).cpu().numpy()
    sets = [rows36, rows36.clone()]
    out = {}
    for L in Ls:
        pl = assembly.build_incidence_plan(seg, cs.pair_plan.nseg,
                                           rows36.device, piece_rows=L)
        out[L] = device_ms(lambda r: k2(pl, r), [(r,) for r in sets]) * 1e3
        log(f"  K2 m=36, L {L}: {pl.npieces if pl.piece_ptr is not None else 0} "
            f"pieces, {out[L]:9.2f} us")
    return out


def tile_sweep(case):
    """K3 (whole wrapper call) in tiles of each of CONTRACT_TILES elements
    on the copies of `case`, device us per call."""
    from mixedfem_tpu_torch import cuda

    sets = copies(case["make"], case["bytes"])
    out = {}
    for tile in cuda.CONTRACT_TILES:
        out[str(tile)] = device_ms(
            lambda *a: cuda.contract_G_Gw_tile(*a, tile), sets) * 1e3
        log(f"  K3 {sets[0][0].dtype}, TE {tile}: {out[str(tile)]:9.2f} us")
    return out


def k4_cases(plan, inc, rows3, rows9, label):
    """K4 at m=3 (matvec, rhs, inertia gradient) and m=9 (diagonal blocks)
    on `plan`, with the corner rows in element order padded to its Rp; K2
    over the mesh's incidence plan `inc` on the same rows is timed beside
    it (the same function, another design)."""
    from mixedfem_tpu_torch import cuda
    from mixedfem_tpu_torch.ops import banded_scatter as bs

    Rp = plan.lidx.shape[0]
    R = inc.slots.shape[0]
    dev = rows3.device
    # the vertex of every row, from K4's CSR (the zero padding rows: 0)
    seg = torch.zeros(Rp, dtype=torch.int64, device=dev)
    seg[plan.csr.slots.long()] = plan.csr.seg

    def case(rows):
        m = rows.shape[1]
        rows = bs.pad_rows(plan, rows)
        base = torch.zeros((plan.nv, m), dtype=rows.dtype, device=dev)
        return dict(
            name=f"banded_sum_m{m}", label=label, W=plan.W,
            replaces="mixedfem_tpu/ops/pallas_scatter.py:100",
            kernel=lambda pl, r, _: cuda.banded_sum(
                pl.csr.row_ptr, pl.csr.slots, r, pl.nv, pl.csr.piece_ptr,
                pl.csr.seg_pieces),
            plain=lambda pl, r, _: bs.banded_sum_plain(pl, r),
            library=lambda pl, r, _: torch.index_add(base, 0, seg, r),
            k2=lambda _, r, ip: k2(ip, r[:R]),
            make=lambda: (clone(plan), rows.clone(), clone(inc)),
            # what the function must move: the rows, one int32 vertex id per
            # row and the output (the measure of K2's bound)
            bytes=nbytes(rows) + Rp * 4 + plan.nv * m * rows.element_size(),
            flops=Rp * m,
        )

    return [case(rows3), case(rows9)]


def stencil_cases(mesh, plan, state, dt, dtype):
    """K5 and K6 on what the grid path gives them: Gw at a perturbed state
    of the 100k-tet box grid, its mass blocks, W assembled from them by
    the plain version, a lattice vector x and the lattice free mask, all
    cast to `dtype`."""
    from mixedfem_tpu_torch.ops import stencil as stmod

    ins = step_inputs(mesh, state, dt)
    Gw, mass = ins["Gw"].to(dtype), mesh.mass_coeff.to(dtype)
    W = stmod.assemble_W_plain(plan, Gw, mass)
    x = stmod.to_lat(plan, torch.randn((mesh.nv, 3), generator=ins["g"],
                                       device=mesh.device).to(dtype))
    fm = stmod.to_lat(plan, mesh.free_mask[:, None].expand(-1, 3).to(dtype))
    npad, es, E = plan.npad, x.element_size(), mesh.nelem
    nused = len(plan.used)
    # K6 adds 16 blocks a element: 6 x 9 products and sums, 3 mass adds
    # and 9 adds into the plane
    k6_flops = 16 * E * (2 * 54 + 3 + 9)
    return [
        dict(
            name="stencil_apply", replaces="mixedfem_tpu/ops/stencil.py:378",
            kernel=lambda W_, x_, f_: stmod.matvec_lat(plan, W_, x_, f_),
            plain=lambda W_, x_, f_: stmod.stencil_apply_plain(plan, W_, x_, f_),
            library=None, make=lambda: (W.clone(), x.clone(), fm.clone()),
            # the CG loop's view: one W, a new x each iteration
            hot=lambda: (W, x.clone(), fm),
            # the planes the plan uses, x and fm read once, y written once
            bytes=nused * 9 * npad * es + 3 * 3 * npad * es,
            flops=mesh.nv * (nused * 9 * 2 + 3),
        ),
        dict(
            name="stencil_assemble", replaces="mixedfem_tpu/ops/stencil.py:187",
            kernel=lambda Gw_, m_: stmod.assemble_W(plan, Gw_, m_),
            plain=lambda Gw_, m_: stmod.assemble_W_plain(plan, Gw_, m_),
            library=None, make=lambda: (Gw.clone(), mass.clone()),
            # Gw and mass read once, the planes the plan uses written once
            # (the 8 planes no term touches are zeros the kernel need not
            # store)
            bytes=nbytes(Gw, mass) + nused * 9 * npad * es,
            flops=k6_flops,
        ),
    ]


def max_err(a, b) -> tuple[float, float]:
    a = a if isinstance(a, tuple) else (a,)
    b = b if isinstance(b, tuple) else (b,)
    err = max((x - y).abs().max().item() for x, y in zip(a, b))
    scale = max(y.abs().max().item() for y in b)
    return err, scale


def case_key(c) -> str:
    return c["name"] + (f" ({c['label']})" if "label" in c else "")


def check_kernels(cases, dtype, tol, cast=None):
    """Each kernel against its plain version on the same inputs; `cast`
    converts the inputs first (float64 copies of float32 cases)."""
    results = {}
    for c in cases:
        args = c["make"]()
        if cast is not None:
            args = tuple(cast(a) for a in args)
        got = c["kernel"](*args)
        ref = c["plain"](*args)
        torch.cuda.synchronize()
        err, scale = max_err(got, ref)
        log(f"  {case_key(c):28s} {str(dtype):14s} max_abs_err {err:.3e} "
            f"(scale {scale:.3e}, tolerance {tol:g} x scale)")
        if not err <= tol * scale:
            raise AssertionError(f"{case_key(c)} disagrees with its plain version")
        results[case_key(c)] = err
    return results


def time_kernels(cases, dtype):
    out = []
    for c in cases:
        sets = copies(c["make"], c["bytes"])
        ms = device_ms(c["kernel"], sets)
        plain_ms = device_ms(c["plain"], sets)
        lib_ms = None if c["library"] is None else device_ms(c["library"], sets)
        k2_ms = device_ms(c["k2"], sets) if "k2" in c else None
        hot_ms = (device_ms(c["kernel"], [c["hot"]() for _ in range(4)])
                  if "hot" in c else None)
        bytes_ms = c["bytes"] / PEAK_BYTES * 1e3
        ops_ms = c["flops"] / PEAK_FLOPS[dtype] * 1e3
        out.append(dict(
            name=c["name"], key=case_key(c), ms=ms, plain_ms=plain_ms,
            library_ms=lib_ms, bound_ms=max(bytes_ms, ops_ms),
            bound_by="bytes" if bytes_ms >= ops_ms else "operations",
            k2_same_rows_ms=k2_ms, hot_ms=hot_ms,
        ))
        log(f"  {case_key(c):28s} kernel {ms * 1e3:9.2f} us  plain "
            f"{plain_ms * 1e3:9.2f} us  library "
            f"{'-' if lib_ms is None else f'{lib_ms * 1e3:9.2f}'} us  bound "
            f"{max(bytes_ms, ops_ms) * 1e3:7.2f} us ({c['bytes'] / 1e6:.2f} MB)"
            + ("" if k2_ms is None else f"  K2 on these rows {k2_ms * 1e3:9.2f} us")
            + ("" if hot_ms is None else f"  hot (W in L2) {hot_ms * 1e3:9.2f} us"))
    return out


# ---------------------------------------------------------------------------
# phases 4 and 5: the step
# ---------------------------------------------------------------------------

def run_steps(mesh, config, state, cs, n, plan=None):
    from mixedfem_tpu_torch.optimizer import newton

    states = []
    for _ in range(n):
        state = newton.newton_step(mesh, config, (), state, cs, (), plan)
        states.append(state)
    return states


def describe(st) -> str:
    it = st.stats.iterations
    return (f"newton {it} cg {st.stats.solver_iters[:it].tolist()} alpha "
            f"{st.stats.alpha[:it].tolist()} energy "
            f"{[float(f'{e:.9g}') for e in st.stats.energy[:it].tolist()]}")


def main_path(mesh, config, state, cs, plan=None, what="100k-tet"):
    from mixedfem_tpu_torch import cuda

    cuda.LAUNCHES.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    (state,) = run_steps(mesh, config, state, cs, 1, plan)
    torch.cuda.synchronize()
    warm_ms = (time.perf_counter() - t0) * 1e3
    log(f"  warm-up step {warm_ms:.1f} ms: {describe(state)}")
    check_energies(state)
    states, times = [], []
    for _ in range(3):
        t0 = time.perf_counter()
        (state,) = run_steps(mesh, config, state, cs, 1, plan)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        states.append(state)
    step_ms = sum(times) / 3
    launches = dict(cuda.LAUNCHES)
    for k, (st, ms) in enumerate(zip(states, times)):
        log(f"  step {k + 1}: {ms:.3f} ms, {describe(st)}")
    cg = [st.stats.solver_iters[:st.stats.iterations].tolist() for st in states]
    newton_its = sum(st.stats.iterations for st in states)
    log(f"  ms_per_step {step_ms:.3f} (3 timed steps), ms per Newton "
        f"iteration {sum(times) / newton_its:.3f}, CG iterations per "
        f"Newton {sum(map(sum, cg)) / newton_its:.2f}, launches over 4 "
        f"steps {launches}")
    final = states[-1]
    if final.x.shape != (mesh.nv, 3) or not torch.isfinite(final.x).all():
        raise AssertionError(f"the {what} step produced non-finite positions")
    for st in states:
        check_energies(st)
    return final, step_ms, launches


def check_energies(st):
    """Finite Newton energies whose last is below the first, up to the line
    search's rounding band."""
    e = st.stats.energy[:st.stats.iterations]
    eps = torch.finfo(e.dtype).eps
    if not (torch.isfinite(e).all() and e[-1] <= e[0] + 16 * eps * abs(e[0])):
        raise AssertionError(f"energies do not decrease: {e.tolist()}")


def trajectory():
    """3 float64 steps of a 1000-tet beam on the card and on the CPU."""
    import dataclasses

    out = {}
    for dev in ("cuda", "cpu"):
        mesh, config, state, cs = beam(10, 5, 4, torch.float64, dev)
        config = dataclasses.replace(config, outer_steps=3,
                                     coarse_refresh_every=2)
        out[dev] = run_steps(mesh, config, state, cs, 3)
    for k, (g, c) in enumerate(zip(out["cuda"], out["cpu"])):
        scale = c.x.abs().max().item()
        err = (g.x.cpu() - c.x).abs().max().item()
        cg_g = g.stats.solver_iters.tolist()
        cg_c = c.stats.solver_iters.tolist()
        log(f"  step {k}: max |x_card - x_cpu| {err:.3e} (scale {scale:.3f}), "
            f"CG card {cg_g} cpu {cg_c}")
        if not err <= 1e-9 * scale:
            raise AssertionError("the card's trajectory leaves the CPU's")
        if cg_g != cg_c or g.stats.iterations != c.stats.iterations:
            raise AssertionError("CG or Newton counts differ")


def grid_float64_step():
    """One float64 step of the 100k-tet grid path on the card: its CG
    counts per Newton iteration beside the float32 ones."""
    mesh, config, state, cs, plan = grid_beam(40, 25, 20, torch.float64, "cuda")
    t0 = time.perf_counter()
    (st,) = run_steps(mesh, config, state, cs, 1, plan)
    torch.cuda.synchronize()
    log(f"  float64 step {(time.perf_counter() - t0) * 1e3:.1f} ms: {describe(st)}")
    check_energies(st)


def grid_trajectory():
    """3 float64 steps of a 1500-tet box grid with a grid coarse space on
    the card (K3, K5, K6, K2) and on the CPU (plain versions)."""
    import dataclasses

    out = {}
    for dev in ("cuda", "cpu"):
        mesh, config, state, cs, plan = grid_beam(10, 6, 5, torch.float64, dev)
        config = dataclasses.replace(config, outer_steps=3,
                                     coarse_refresh_every=2)
        out[dev] = run_steps(mesh, config, state, cs, 3, plan)
    log(f"  E {mesh.nelem} nv {mesh.nv} aggregates {cs.naggr} block "
        f"{cs.grid[1]}")
    for k, (g, c) in enumerate(zip(out["cuda"], out["cpu"])):
        scale = c.x.abs().max().item()
        err = (g.x.cpu() - c.x).abs().max().item()
        cg_g = g.stats.solver_iters.tolist()
        cg_c = c.stats.solver_iters.tolist()
        log(f"  step {k}: max |x_card - x_cpu| {err:.3e} (scale {scale:.3f}), "
            f"CG card {cg_g} cpu {cg_c}, alpha card {g.stats.alpha.tolist()} "
            f"cpu {c.stats.alpha.tolist()}")
        if not err <= 1e-9 * scale:
            raise AssertionError("the card's grid trajectory leaves the CPU's")
        if cg_g != cg_c or g.stats.iterations != c.stats.iterations:
            raise AssertionError("CG or Newton counts differ")


# ---------------------------------------------------------------------------
# phases 6 and 7: the scene path
# ---------------------------------------------------------------------------

def write_scene(d, nx, ny, nz, newton, seed):
    """The bench's beam, box (4, 1, 1), with its vertex ids in a seeded
    random order (as a mesher's file looks to the loader), as beam.mesh and
    a scene JSON in the reference vocabulary in directory `d`."""
    from mixedfem_tpu_torch.io import mesh_io
    from mixedfem_tpu_torch.mesh import generators

    V, T = generators.box_tet_mesh(nx, ny, nz, size=(4.0, 1.0, 1.0))
    perm = np.random.default_rng(seed).permutation(len(V))
    inv = np.empty_like(perm)
    inv[perm] = np.arange(len(perm))
    mesh_io.write_mesh(os.path.join(d, "beam.mesh"), V[perm], inv[T])
    scene = {
        "time_integrator": "BDF1", "dt": 0.02,
        "max_newton_iterations": newton, "iterative_solver_tolerance": 1e-4,
        "mixed_variables": ["mixed-stretch"],
        "material_models": [{
            "energy": "Stable-Neohookean", "youngs_modulus": 1e6,
            "poissons_ratio": 0.45, "density": 1000.0,
        }],
        "objects": [{
            "path": "beam.mesh", "normalize": False,
            "boundary_condition": {"type": "twist", "ratio": 0.1, "axis": 0},
        }],
    }
    path = os.path.join(d, "scene.json")
    with open(path, "w") as f:
        json.dump(scene, f)
    return path


def scene_main_path(sim):
    """One warm-up Simulation.step and three timed ones; launch counts over
    the four steps."""
    from mixedfem_tpu_torch import cuda

    x0 = sim.state.x.clone()
    cuda.LAUNCHES.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sim.step()
    torch.cuda.synchronize()
    log(f"  warm-up step {(time.perf_counter() - t0) * 1e3:.1f} ms: "
        f"{describe(sim.state)}")
    check_energies(sim.state)
    states, times = [], []
    for _ in range(3):
        t0 = time.perf_counter()
        sim.step()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        states.append(sim.state)
    launches = dict(cuda.LAUNCHES)
    for k, (st, ms) in enumerate(zip(states, times)):
        log(f"  step {k + 1}: {ms:.3f} ms, {describe(st)}")
        check_energies(st)
    newton_its = sum(st.stats.iterations for st in states)
    cg = sum(sum(st.stats.solver_iters[:st.stats.iterations].tolist())
             for st in states)
    step_ms = sum(times) / 3
    log(f"  ms_per_step {step_ms:.3f} (3 timed steps), ms per Newton "
        f"iteration {sum(times) / newton_its:.3f}, CG iterations per Newton "
        f"{cg / newton_its:.2f}, launches over 4 steps {launches}")
    x = sim.state.x
    if x.shape != (sim.mesh.nv, 3) or not torch.isfinite(x).all():
        raise AssertionError("the scene step produced non-finite positions")
    pinned = sim.mesh.free_mask == 0
    moved = (x - x0)[pinned].abs().max().item()
    log(f"  the twisted ends moved {moved:.4e}")
    if not moved > 1e-3:
        raise AssertionError("the twist BC did not move the pinned ends")
    return step_ms, launches


def scene_trajectory(d):
    """3 float64 steps of a 2000-tet scene on the card (K4 over the banded
    plan) and on the CPU (the same objects moved there: the plain versions
    over the same element order and plan)."""
    from mixedfem_tpu_torch.device import to_device
    from mixedfem_tpu_torch.io.scene import load_scene

    path = write_scene(d, 20, 5, 4, newton=3, seed=1)
    card = load_scene(path, dim=3, dtype="float64", device="cuda")
    if card.matvec_plan is None or card.coarse is None:
        raise AssertionError("a 2000-tet scene loads without the banded plan")
    cpu = to_device(card, "cpu")
    log(f"  E {card.mesh.nelem} nv {card.mesh.nv} W {card.matvec_plan.W}")
    for k in range(3):
        g, c = card.step(), cpu.step()
        scale = c.x.abs().max().item()
        err = (g.x.cpu() - c.x).abs().max().item()
        cg_g = g.stats.solver_iters.tolist()
        cg_c = c.stats.solver_iters.tolist()
        log(f"  step {k}: max |x_card - x_cpu| {err:.3e} (scale {scale:.3f}), "
            f"CG card {cg_g} cpu {cg_c}")
        if not err <= 1e-9 * scale:
            raise AssertionError("the card's scene trajectory leaves the CPU's")
        if cg_g != cg_c or g.stats.iterations != c.stats.iterations:
            raise AssertionError("CG or Newton counts differ")


# ---------------------------------------------------------------------------
# phases 11 and 12: the contact scene
# ---------------------------------------------------------------------------

CONTACT_DHAT = 1e-2
SNH_04 = {"energy": "Stable-Neohookean", "youngs_modulus": 1e6,
          "poissons_ratio": 0.4, "density": 1000.0}


def write_contact_scene(d):
    """Phase 11's slab and box as slab.mesh, box.mesh and a scene JSON
    without mixed_variables in directory `d`."""
    from mixedfem_tpu_torch.io import mesh_io
    from mixedfem_tpu_torch.mesh import generators

    Vs, Ts = generators.box_tet_mesh(60, 4, 60, size=(2.0, 0.1, 2.0))
    Vb, Tb = generators.box_tet_mesh(16, 16, 16, size=(0.5, 0.5, 0.5))
    mesh_io.write_mesh(os.path.join(d, "slab.mesh"), Vs, Ts)
    mesh_io.write_mesh(os.path.join(d, "box.mesh"), Vb, Tb)
    scene = {
        "time_integrator": "BDF1", "dt": 0.01, "enable_ccd": True,
        "dhat": CONTACT_DHAT, "kappa": 1e5, "max_newton_iterations": 5,
        "material_models": [SNH_04],
        "objects": [
            {"path": "slab.mesh", "normalize": False,
             "boundary_condition": {"type": "hangends", "axis": 0}},
            {"path": "box.mesh", "normalize": False,
             "offset": [0.75, 0.1 + 0.5 * CONTACT_DHAT, 0.75]},
        ],
    }
    path = os.path.join(d, "contact.json")
    with open(path, "w") as f:
        json.dump(scene, f)
    return path


def write_drop_scene(d, dhat=3e-2):
    """The drop scene of tests/test_collision.py (drop_scene): a slab
    box_tet_mesh(2, 1, 2) over (1, 0.25, 1), pinned whole (hangends along
    y with ratio 2), and a box_tet_mesh(2, 1, 2) over (0.4, 0.2, 0.4) at
    (0.3, 0.27, 0.3); float64 contact at `dhat`, 3 Newton iterations."""
    from mixedfem_tpu_torch.io import mesh_io
    from mixedfem_tpu_torch.mesh import generators

    V1, T1 = generators.box_tet_mesh(2, 1, 2, size=(1.0, 0.25, 1.0))
    V2, T2 = generators.box_tet_mesh(2, 1, 2, size=(0.4, 0.2, 0.4))
    mesh_io.write_mesh(os.path.join(d, "slab.mesh"), V1, T1)
    mesh_io.write_mesh(os.path.join(d, "box.mesh"), V2, T2)
    scene = {
        "dt": 0.01, "enable_ccd": True, "dhat": dhat, "kappa": 1e5,
        "max_newton_iterations": 3, "iterative_solver_tolerance": 1e-8,
        "material_models": [SNH_04],
        "objects": [
            {"path": "slab.mesh", "normalize": False, "boundary_condition":
             {"type": "hangends", "axis": 1, "ratio": 2.0}},
            {"path": "box.mesh", "normalize": False,
             "offset": [0.3, 0.27, 0.3]},
        ],
    }
    path = os.path.join(d, "drop.json")
    with open(path, "w") as f:
        json.dump(scene, f)
    return path


def first_contact_pairs(sim):
    """The coarse contact pair plan of the scene's first coarse refresh:
    the frames active at the initial positions (optimizer/newton.py)."""
    from mixedfem_tpu_torch.solvers import coarse as coarsemod
    from mixedfem_tpu_torch.variables import mixed_collision as mc

    cf, x, c = sim.state.contact, sim.state.x, sim.config
    z = x.new_zeros((cf.nreal,))
    cc0 = mc.update(sim.mesh, cf, x, z, z, z, c.dhat, c.kappa)
    act = torch.nonzero(cc0.active).squeeze(1)
    return coarsemod.contact_pairs(sim.coarse, cf.frames[act].cpu().numpy(),
                                   x.device)


def contact_k2_cases(cf, pairs):
    """K2 over the contact frame plan of candidate set `cf` (m=3, 9) and
    the coarse contact pair plan `pairs` (m=36), on seeded rows of those
    shapes."""
    from mixedfem_tpu_torch.ops import assembly

    g = torch.Generator(device="cuda").manual_seed(1)

    def case(m, label, plan):
        rows = torch.randn((plan.nrows, m), generator=g, device="cuda")
        seg = torch.empty(plan.nrows, dtype=torch.int64, device="cuda")
        seg[plan.slots.long()] = plan.seg
        base = torch.zeros((plan.nseg, m), device="cuda")
        ins = (plan.row_ptr, plan.slots, rows)
        return dict(
            name=f"segment_sum_m{m}", label=label,
            replaces="mixedfem_tpu/ops/brick.py:442",
            kernel=k2, plain=assembly.segment_sum_plain,
            library=lambda pl, r: torch.index_add(base, 0, seg, r),
            make=lambda: (clone(plan), rows.clone()),
            bytes=nbytes(*ins) + plan.nseg * m * rows.element_size(),
            flops=rows.numel(), npieces=plan.npieces,
        )

    return [case(3, "contact frames", cf.plan),
            case(9, "contact frames", cf.plan),
            case(36, "contact pairs", pairs.plan)]


def contact_main_path(sim):
    """One warm-up Simulation.step and three timed ones of the contact
    scene; the broadphase's host time is read around each candidate
    build. Launch counts over the four steps."""
    from mixedfem_tpu_torch import cuda

    build = sim._update_contact_candidates
    builds = []

    def timed_build(*a, **k):
        t0 = time.perf_counter()
        out = build(*a, **k)
        builds.append((len(times), time.perf_counter() - t0))
        return out

    sim._update_contact_candidates = timed_build
    times, states, cands = [], [], []
    cuda.LAUNCHES.clear()
    torch.cuda.synchronize()
    for k in range(4):
        t0 = time.perf_counter()
        sim.step()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        states.append(sim.state)
        cands.append(sim.state.contact.nreal)
    launches = dict(cuda.LAUNCHES)
    del sim._update_contact_candidates
    bp_ms = [1e3 * sum(t for i, t in builds if i == k) for k in range(4)]
    for k, (st, ms) in enumerate(zip(states, times)):
        it = st.stats.iterations
        log(f"  {'warm-up step' if k == 0 else f'step {k}'}: {ms:.3f} ms "
            f"(broadphase {bp_ms[k]:.3f} ms), candidates {cands[k]}, active "
            f"frames {st.stats.active_frames[:it].tolist()}, min mixed "
            f"distance {st.stats.min_distance[:it].min().item():.6e}, "
            f"{describe(st)}")
        check_energies(st)
    timed = states[1:]
    newton_its = sum(st.stats.iterations for st in timed)
    cg = sum(sum(st.stats.solver_iters[:st.stats.iterations].tolist())
             for st in timed)
    step_ms = sum(times[1:]) / 3
    dmin = min(st.stats.min_distance[:st.stats.iterations].min().item()
               for st in states)
    active = max(int(st.stats.active_frames[:st.stats.iterations].max())
                 for st in states)
    log(f"  ms_per_step {step_ms:.3f} (3 timed steps), ms per Newton "
        f"iteration {sum(times[1:]) / newton_its:.3f}, CG iterations per "
        f"Newton {cg / newton_its:.2f}, broadphase ms per step "
        f"{sum(bp_ms[1:]) / 3:.3f}, retries {sim.retries}, min mixed "
        f"distance {dmin:.6e}, most active frames {active}, launches over "
        f"4 steps {launches}")
    x = sim.state.x
    if x.shape != (sim.mesh.nv, 3) or not torch.isfinite(x).all():
        raise AssertionError("the contact step produced non-finite positions")
    if not (active > 0 and 0 < dmin < math.inf):
        raise AssertionError(f"no feasible contact: {active} active frames, "
                             f"min mixed distance {dmin}")
    return step_ms, launches


def contact_trajectory(d):
    """3 float64 steps of the drop scene on the card and on the CPU (the
    same loaded objects moved there)."""
    from mixedfem_tpu_torch.device import to_device
    from mixedfem_tpu_torch.io.scene import load_scene

    card = load_scene(write_drop_scene(d), dim=3, dtype="float64",
                      device="cuda")
    cpu = to_device(card, "cpu")
    log(f"  E {card.mesh.nelem} nv {card.mesh.nv} variables "
        f"{card.config.mixed_variables}")
    for k in range(3):
        g, c = card.step(), cpu.step()
        scale = c.x.abs().max().item()
        err = (g.x.cpu() - c.x).abs().max().item()
        it = c.stats.iterations
        counts = {dev: (st.stats.iterations, st.stats.solver_iters.tolist(),
                        st.stats.active_frames.tolist())
                  for dev, st in (("card", g), ("cpu", c))}
        log(f"  step {k}: max |x_card - x_cpu| {err:.3e} (scale {scale:.3f}), "
            f"candidates {c.contact.nreal}, (newton, CG, active) card "
            f"{counts['card']} cpu {counts['cpu']}, alpha {c.stats.alpha.tolist()}")
        if not err <= 1e-9 * scale:
            raise AssertionError("the card's contact trajectory leaves the CPU's")
        if counts["card"] != counts["cpu"]:
            raise AssertionError("Newton, CG or active-frame counts differ")
        if not int(c.stats.active_frames[:it].max()) > 0:
            raise AssertionError("the drop scene has no active contact")


def profile_step(step, out_dir, name, untraced_ms):
    """Trace one more step (`step()` runs it) with torch.profiler: device
    busy time against the step's wall time, host and device time per span,
    and the per-kernel table in out_dir/profile_<name>.txt."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(out_dir, exist_ok=True)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    avgs = prof.key_averages()
    # device time of the kernels themselves (as the table's footer sums it)
    busy_ms = sum(
        a.self_device_time_total for a in avgs
        if a.device_type == torch.autograd.DeviceType.CUDA
        and not a.is_user_annotation
    ) / 1e3
    spans = [
        f"  span {a.key:22s} {str(a.device_type):16s} calls {a.count:4d} "
        f"host {a.cpu_time_total / 1e3:9.3f} ms device {a.device_time_total / 1e3:9.3f} ms"
        for a in avgs if a.key.startswith(("newton.", "scene."))
    ]
    # the hand kernels' device time, each instantiation on a line of its own
    hand = []
    for a in avgs:
        m = re.search(r"\b(?:element_apply|segment_sum|contract_G_Gw|banded_sum"
                      r"|stencil_apply|stencil_assemble|stencil_zero_planes)"
                      r"_kernel\w*<[^>]*>", a.key)
        if m and a.device_type == torch.autograd.DeviceType.CUDA:
            hand.append(f"  kernel {m.group(0):40s} launches {a.count:4d} device "
                        f"{a.self_device_time_total / 1e3:8.3f} ms")
    for line in spans + hand:
        log(line)
    path = os.path.join(out_dir, f"profile_{name}.txt")
    with open(path, "w") as f:
        f.write(f"traced step: wall {wall_ms:.3f} ms, device busy {busy_ms:.3f} ms\n")
        f.write("\n".join(spans + hand) + "\n")
        f.write(avgs.table(sort_by="self_device_time_total", row_limit=60))
    log(f"  traced step wall {wall_ms:.3f} ms, device busy {busy_ms:.3f} ms "
        f"({100 * busy_ms / wall_ms:.1f}% of the traced step, "
        f"{100 * busy_ms / untraced_ms:.1f}% of an untraced step), table in {path}")


# ---------------------------------------------------------------------------


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", metavar="DIR", default=None)
    args = ap.parse_args()

    log("phase 1: card")
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)",
              file=sys.stderr)
        return 2
    card = card_line()
    log(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from mixedfem_tpu_torch import cuda
    from mixedfem_tpu_torch.io.scene import load_scene
    from mixedfem_tpu_torch.solvers import operator as opmod

    log("phase 2: build")
    t0 = time.perf_counter()
    lib = cuda.build()
    log(f"  built {lib.name} in {time.perf_counter() - t0:.1f} s")

    log("phase 3: kernels at the 100k-tet shapes")
    mesh, config, state, cs = beam(40, 25, 20, torch.float32, "cuda")
    log(f"  E {mesh.nelem} nv {mesh.nv} aggregates {cs.naggr} ncd {cs.ncd}")
    for name, pl in (("vertex plan", mesh.plan), ("aggregate plan", cs.agg_plan),
                     ("pair plan", cs.pair_plan)):
        log("  " + plan_line(name, pl))
    dt = 0.02
    cases32 = kernel_cases(mesh, cs, state, dt)
    errs = check_kernels(cases32, torch.float32, 1e-5)
    mesh64, _, state64, cs64 = beam(40, 25, 20, torch.float64, "cuda")
    cases64 = kernel_cases(mesh64, cs64, state64, dt)
    check_kernels(cases64, torch.float64, 1e-12)
    k3_64 = [c for c in cases64 if c["name"] == "contract_G_Gw"]
    del mesh64, state64, cs64, cases64
    # K4 on the banded beam's plan and on the loaded scene's plan
    tmp = tempfile.TemporaryDirectory()
    t0 = time.perf_counter()
    sim = load_scene(write_scene(tmp.name, 40, 25, 20, newton=5, seed=0),
                     dim=3, dtype="float32", device="cuda")
    log(f"  scene loaded in {time.perf_counter() - t0:.1f} s: E "
        f"{sim.mesh.nelem} nv {sim.mesh.nv} W {sim.matvec_plan.W} chunks "
        f"{sim.matvec_plan.nchunks}, aggregates {sim.coarse.naggr}")
    beam_plan = opmod.build_banded_plan(mesh)
    for name, pl in (("scene K4 plan", sim.matvec_plan.csr),
                     ("beam K4 plan", beam_plan.csr),
                     ("scene aggregate plan", sim.coarse.agg_plan),
                     ("scene pair plan", sim.coarse.pair_plan)):
        log("  " + plan_line(name, pl))
    beam_rows = step_inputs(mesh, state, dt)
    scene_rows = step_inputs(sim.mesh, sim.state, dt)
    k4_beam = k4_cases(beam_plan, mesh.plan, beam_rows["rows3"],
                       beam_rows["rows9"], f"beam, W={beam_plan.W}")
    k4_scene = k4_cases(sim.matvec_plan, sim.mesh.plan, scene_rows["rows3"],
                        scene_rows["rows9"], f"scene, W={sim.matvec_plan.W}")
    del beam_rows, scene_rows
    errs.update(check_kernels(k4_beam + k4_scene, torch.float32, 1e-5))

    def f64(a):
        return a.double() if torch.is_tensor(a) and a.is_floating_point() else a

    check_kernels(k4_beam + k4_scene, torch.float64, 1e-12, cast=f64)
    timings = time_kernels(cases32, torch.float32)
    sweep = piece_sweep(cs, next(c for c in cases32
                                 if c["name"] == "segment_sum_m36")["make"]()[1])
    k3_32 = next(c for c in cases32 if c["name"] == "contract_G_Gw")
    k3_tiles = {"float32": tile_sweep(k3_32), "float64": tile_sweep(k3_64[0])}
    (k3_64_t,) = time_kernels(k3_64, torch.float64)
    del k3_64
    k4_beam_t = time_kernels(k4_beam, torch.float32)
    k4_scene_t = time_kernels(k4_scene, torch.float32)
    del k4_beam, beam_plan
    # K5 and K6 on the bench's box grid (phase 8's mesh)
    t0 = time.perf_counter()
    gmesh, gconfig, gstate, gcs, gplan = grid_beam(40, 25, 20, torch.float32,
                                                   "cuda")
    log(f"  grid built in {time.perf_counter() - t0:.1f} s: E {gmesh.nelem} "
        f"nv {gmesh.nv}, lattice {(gplan.NI, gplan.NJ, gplan.NK)}, npad "
        f"{gplan.npad}, planes used {len(gplan.used)} of 27, terms "
        f"{len(gplan.terms)}, aggregates {gcs.naggr} (block {gcs.grid[1]}) "
        f"ncd {gcs.ncd}")
    st32 = stencil_cases(gmesh, gplan, gstate, dt, torch.float32)
    st64 = stencil_cases(gmesh, gplan, gstate, dt, torch.float64)
    errs.update(check_kernels(st32, torch.float32, 1e-5))
    check_kernels(st64, torch.float64, 1e-12)
    st32_t = time_kernels(st32, torch.float32)
    st64_t = {t["name"]: t for t in time_kernels(st64, torch.float64)}
    del st32, st64
    # K2 at the contact shapes: phase 11's scene and its first candidates
    ctmp = tempfile.TemporaryDirectory()
    t0 = time.perf_counter()
    csim = load_scene(write_contact_scene(ctmp.name), dim=3, dtype="float32",
                      device="cuda")
    t1 = time.perf_counter()
    csim._update_contact_candidates()
    cf = csim.state.contact
    log(f"  contact scene loaded in {t1 - t0:.1f} s: E {csim.mesh.nelem} nv "
        f"{csim.mesh.nv} W {csim.matvec_plan.W}, aggregates "
        f"{csim.coarse.naggr}, variables {csim.config.mixed_variables}; "
        f"candidates {cf.nreal} (capacity {cf.frames.shape[0]}) in "
        f"{(time.perf_counter() - t1) * 1e3:.1f} ms")
    pairs = first_contact_pairs(csim)
    for name, pl in (("contact frame plan", cf.plan),
                     ("contact pair plan", pairs.plan)):
        log("  " + plan_line(name, pl))
    k2c = contact_k2_cases(cf, pairs)
    errs.update(check_kernels(k2c, torch.float32, 1e-5))
    check_kernels(k2c, torch.float64, 1e-12, cast=f64)
    k2c_t = time_kernels(k2c, torch.float32)
    k2c_pieces = {case_key(c): c["npieces"] for c in k2c}
    del k2c, cf, pairs

    log("phase 4: main path, 100k tets, float32")
    final, step_ms, launches = main_path(mesh, config, state, cs)
    missing = [t["name"] for t in timings if launches.get(t["name"], 0) == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the main path: {missing}")
    if args.profile:
        profile_step(lambda: run_steps(mesh, config, final, cs, 1),
                     args.profile, "step", step_ms)
    del mesh, state, cs, final

    log("phase 5: float64 trajectory, card against CPU")
    trajectory()

    log("phase 6: scene path, 100k tets, float32 (load_scene, Simulation.step)")
    scene_ms, scene_launches = scene_main_path(sim)
    need = ("element_apply", "banded_sum_m3", "banded_sum_m9",
            "segment_sum_m6", "segment_sum_m36", "contract_G_Gw")
    missing = [k for k in need if scene_launches.get(k, 0) == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the scene path: {missing}")
    if args.profile:
        profile_step(sim.step, args.profile, "scene_step", scene_ms)
    del sim

    log("phase 7: float64 scene trajectory, card against CPU")
    with tempfile.TemporaryDirectory() as d:
        scene_trajectory(d)
    tmp.cleanup()

    log("phase 8: grid path, 100k tets, float32 (stencil plan, grid coarse "
        "space)")
    gfinal, grid_ms, grid_launches = main_path(gmesh, gconfig, gstate, gcs,
                                               gplan, "grid")
    need = ("stencil_apply", "stencil_assemble", "contract_G_Gw",
            "segment_sum_m3", "segment_sum_m36")
    missing = [k for k in need if grid_launches.get(k, 0) == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the grid path: {missing}")
    if args.profile:
        profile_step(lambda: run_steps(gmesh, gconfig, gfinal, gcs, 1, gplan),
                     args.profile, "grid_step", grid_ms)
    del gmesh, gstate, gcs, gplan, gfinal

    log("phase 9: float64 grid trajectory, card against CPU")
    grid_trajectory()

    log("phase 10: one float64 grid step, 100k tets")
    grid_float64_step()

    log("phase 11: contact scene, 92k tets, float32 (load_scene without "
        "mixed_variables, Simulation.step)")
    contact_ms, contact_launches = contact_main_path(csim)
    need = ("element_apply", "banded_sum_m3", "banded_sum_m9",
            "segment_sum_m3", "segment_sum_m9", "segment_sum_m6",
            "segment_sum_m36", "contract_G_Gw")
    missing = [k for k in need if contact_launches.get(k, 0) == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the contact path: {missing}")
    if args.profile:
        profile_step(csim.step, args.profile, "contact_step", contact_ms)
    del csim
    ctmp.cleanup()

    log("phase 12: float64 contact trajectory, card against CPU")
    with tempfile.TemporaryDirectory() as d:
        contact_trajectory(d)

    log("phase 13: results")
    replaces = {c["name"]: c["replaces"] for c in cases32 + k4_scene}
    replaces.update({t["name"]: "mixedfem_tpu/ops/stencil.py:" + (
        "378" if t["name"] == "stencil_apply" else "187") for t in st32_t})
    k4_other = {t["name"]: t for t in k4_beam_t}
    contact_keys = {t["key"] for t in k2c_t}
    kernels = []
    for t in timings + k4_scene_t + st32_t + k2c_t:
        name = t["name"]
        by_path = {"beam_step": launches.get(name, 0),
                   "scene_step": scene_launches.get(name, 0),
                   "grid_step": grid_launches.get(name, 0),
                   "contact_step": contact_launches.get(name, 0)}
        entry = dict(
            name=name, route="cuda",
            source="mixedfem_tpu_torch/csrc/kernels.cu",
            replaces=replaces[name],
            # the path that carries the kernel: K4 the scene's, K5 and K6
            # the grid's, K2 at the contact shapes the contact scene's,
            # K1-K3 the bench beam's (phase 4)
            launches=by_path["contact_step" if t["key"] in contact_keys
                             else "scene_step" if name.startswith("banded")
                             else "grid_step" if name.startswith("stencil")
                             else "beam_step"],
            launches_by_path=by_path, max_abs_err=errs[t["key"]],
            ms=t["ms"], plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
            bound_by=t["bound_by"], library_ms=t["library_ms"],
        )
        if t["hot_ms"] is not None:
            entry["hot_ms"] = t["hot_ms"]
        if name in st64_t:
            entry["f64"] = {k: st64_t[name][k] for k in (
                "ms", "hot_ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms") if st64_t[name][k] is not None}
        if t["key"] == "segment_sum_m36":
            entry["piece_rows_us"] = sweep
        if name == "contract_G_Gw":
            entry["tile_us"] = k3_tiles["float32"]
            entry["tile_us_f64"] = k3_tiles["float64"]
            entry["f64"] = {k: k3_64_t[k] for k in (
                "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}
        c = next((c for c in cases32 if c["name"] == name), {})
        if t["key"] in contact_keys:
            entry["shapes"] = t["key"]
            entry["npieces"] = k2c_pieces[t["key"]]
        elif "npieces" in c:
            entry["npieces"] = c["npieces"]
        if name in k4_other:
            o = k4_other[name]
            entry["shapes"] = t["key"]
            entry["k2_same_rows_ms"] = t["k2_same_rows_ms"]
            entry["other_plan"] = {k: o[k] for k in (
                "key", "ms", "plain_ms", "bound_ms", "library_ms",
                "k2_same_rows_ms")}
        kernels.append(entry)
    log(f"{card}, ms_per_step {step_ms:.3f}, scene ms_per_step {scene_ms:.3f}, "
        f"grid ms_per_step {grid_ms:.3f}, contact ms_per_step {contact_ms:.3f}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
