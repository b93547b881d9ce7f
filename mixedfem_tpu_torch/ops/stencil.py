"""Structured-grid stencil path: the condensed operator as a 27-point block
stencil on a ghost-padded vertex lattice (port of
mixedfem_tpu/ops/stencil.py).

On a regular box grid (mesh/generators.box_tet_mesh: each cell split into
5 tets, mirrored on odd cells) the vertex-pair blocks of the condensed
system are stored in OFFSET form, W[o, :, :, v] = A[v, v + o] for the 27
offsets o in {-1, 0, 1}^3, on the flat lattice (NI+2, NJ+2, NK+2) whose
ghost layer makes every offset a constant flat shift. Only 19 of the 27
offsets occur for the 5-tet split; the other 8 planes stay zero.

  assemble_W   W from Gw (E, 6, 4, 3) and the mass blocks, once per Newton
               iteration: kernel K6 (csrc/kernels.cu:stencil_assemble_kernel)
               on a CUDA tensor, a block per tile of lattice vertices with
               the tile's cells staged in shared memory, a thread per (pair
               of vertices along k, job of the host schedule k6_schedule,
               row of the block) adding each of its planes' terms in plan
               order, no atomics.
  matvec_lat   y = fm * (A x) on (3, npad) lattice vectors, every CG
               iteration: kernel K5 (stencil_apply_kernel), a thread per
               (row of y, lattice vertex), the used planes unrolled.

The JAX package's TPU layout devices (masked pad-and-sum windows, the
(feat, E) rows of ops/rows.py) are not carried over: the corner gather is
one index gather through the plan's table of lattice ids, and the vertex
sums are kernel K2 over the mesh's incidence plan (ops/assembly.py
segment_sum over mesh.plan, which is the JAX scatter_vec's function), in
a fixed order. The plain versions of
K5 and K6 (stencil_apply_plain, assemble_W_plain) are the JAX formulas:
the shifted block products and the term loop.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from mixedfem_tpu_torch import cuda
from mixedfem_tpu_torch.device import resolve_device
from mixedfem_tpu_torch.ops import assembly

# offset id: oid = 9*(di+1) + 3*(dj+1) + (dk+1)
OFFSETS = [(di, dj, dk) for di in (-1, 0, 1) for dj in (-1, 0, 1)
           for dk in (-1, 0, 1)]
CENTER = 13  # (0, 0, 0)


@dataclasses.dataclass
class StencilPlan:
    """Static plan of the box-grid stencil path, on one device.

    `terms` are the JAX package's (parity, slot, a, b, (cai, caj, cak), oid)
    descriptors and `vec_terms` its (parity, slot, a, ca); element order is
    cell-major, slot-minor (build_stencil_plan returns the permutation)."""

    masks: torch.Tensor        # (2, NIc, NJc, NKc) cell-parity indicators
    corner_lat: torch.Tensor   # (E, k) int64 padded-lattice id per corner
    term_table: torch.Tensor   # (nterms, 8) int32 K6's terms, plane-major
    plane_ptr: torch.Tensor    # (28,) int32 K6's terms of plane o
    schedule: torch.Tensor     # int32 K6's jobs over term_table (k6_schedule)
    NI: int
    NJ: int
    NK: int
    nslots: int
    terms: tuple
    vec_terms: tuple
    used: tuple                # the offsets the terms use, ascending

    @property
    def nv(self) -> int:
        return self.NI * self.NJ * self.NK

    @property
    def npad(self) -> int:
        return (self.NI + 2) * (self.NJ + 2) * (self.NK + 2)

    @property
    def ncells(self) -> int:
        return (self.NI - 1) * (self.NJ - 1) * (self.NK - 1)

    @property
    def used_mask(self) -> int:
        return sum(1 << o for o in self.used)


def build_stencil_plan(
    T: np.ndarray, nv: int, grid_dims: tuple[int, int, int] | None = None,
    device="cuda",
) -> tuple[Optional[StencilPlan], Optional[np.ndarray]]:
    """Detect the box-grid structure of (T, nv) and build the plan (host
    numpy, a copy of the JAX function, then the tables on `device`).

    grid_dims = (NI, NJ, NK) vertex lattice dims with
    vid = (i*NJ + j)*NK + k (box_tet_mesh's layout). Returns
    (plan, element_permutation) -- reorder T and every per-element array
    with the permutation BEFORE building the mesh -- or (None, None) when
    the mesh is not a conforming grid of uniform element classes."""
    T = np.asarray(T)
    if grid_dims is None:
        return None, None
    NI, NJ, NK = grid_dims
    if NI * NJ * NK != nv or T.shape[1] != 4:
        return None, None
    E, k = T.shape

    i3 = np.stack([T // (NJ * NK), (T // NK) % NJ, T % NK], axis=-1)
    cell = i3.min(axis=1)                      # (E, 3) lattice cell
    ca = i3 - cell[:, None, :]                 # (E, 4, 3) corner offsets
    if ca.min() < 0 or ca.max() > 1:
        return None, None
    NIc, NJc, NKc = NI - 1, NJ - 1, NK - 1
    if E % (NIc * NJc * NKc) != 0:
        return None, None
    nslots = E // (NIc * NJc * NKc)
    cellid = (cell[:, 0] * NJc + cell[:, 1]) * NKc + cell[:, 2]
    perm = np.argsort(cellid, kind="stable")
    counts = np.bincount(cellid, minlength=NIc * NJc * NKc)
    if (counts != nslots).any():
        return None, None
    parity = (cell[:, 0] + cell[:, 1] + cell[:, 2]) % 2

    # class = (parity, slot); every element of a class shares its corner
    # offsets
    slot = np.empty(E, np.int64)
    slot[perm] = np.arange(E) % nslots
    terms = []
    for p in (0, 1):
        for t in range(nslots):
            sel = np.flatnonzero((parity == p) & (slot == t))
            if len(sel) == 0:
                continue
            ca0 = ca[sel[0]]
            if not (ca[sel] == ca0).all():
                return None, None
            for a in range(k):
                for b in range(k):
                    d = ca0[b] - ca0[a]
                    oid = 9 * (d[0] + 1) + 3 * (d[1] + 1) + (d[2] + 1)
                    terms.append(
                        (p, t, a, b, tuple(int(c) for c in ca0[a]),
                         int(oid))
                    )
    vec_terms = tuple(
        (p, t, a, caa) for (p, t, a, b, caa, _o) in terms if b == 0
    )
    pc = ((np.add.outer(np.add.outer(np.arange(NIc), np.arange(NJc)),
                        np.arange(NKc))) % 2)
    masks = np.stack([(pc == 0), (pc == 1)]).astype(np.float32)
    return plan_from_terms(NI, NJ, NK, nslots, tuple(terms), vec_terms,
                           masks, device), perm


def plan_from_terms(NI, NJ, NK, nslots, terms, vec_terms, masks,
                    device="cuda") -> StencilPlan:
    """StencilPlan from the JAX plan's fields (host values), with the
    port's tables built from them on `device`."""
    dev = resolve_device(device)
    terms = tuple((int(p), int(t), int(a), int(b),
                   tuple(int(c) for c in ca), int(o))
                  for (p, t, a, b, ca, o) in terms)
    vec_terms = tuple((int(p), int(t), int(a), tuple(int(c) for c in ca))
                      for (p, t, a, ca) in vec_terms)
    NIc, NJc, NKc = NI - 1, NJ - 1, NK - 1
    NJp, NKp = NJ + 2, NK + 2
    k = 1 + max(a for (_p, _t, a, _ca) in vec_terms)

    # the lattice vertex of every element corner, cell-major slot-minor:
    # element e = cell * nslots + t, corner a at cell + ca(parity, t, a)
    ci, cj, ck = np.meshgrid(np.arange(NIc), np.arange(NJc), np.arange(NKc),
                             indexing="ij")
    ci, cj, ck = ci.reshape(-1), cj.reshape(-1), ck.reshape(-1)
    par = (ci + cj + ck) % 2
    vid = np.full((len(ci), nslots, k), -1, np.int64)
    for (p, t, a, (oi, oj, ok)) in vec_terms:
        sel = par == p
        vid[sel, t, a] = ((ci[sel] + oi) * NJ + cj[sel] + oj) * NK + ck[sel] + ok
    if (vid < 0).any():
        raise ValueError("the plan's terms do not cover every element corner")
    vid = vid.reshape(-1, k)
    i, j, kk = vid // (NJ * NK), (vid // NK) % NJ, vid % NK
    lat = ((i + 1) * NJp + j + 1) * NKp + kk + 1

    # K6's terms grouped by plane, plan order kept within a plane
    order = sorted(range(len(terms)), key=lambda q: terms[q][5])
    table = np.array(
        [[terms[q][1], terms[q][2], terms[q][3], terms[q][0], *terms[q][4], 0]
         for q in order], np.int32).reshape(-1, 8)
    plane_ptr = np.zeros(28, np.int32)
    np.cumsum(np.bincount([t[5] for t in terms], minlength=27),
              out=plane_ptr[1:])
    if not set(np.unique(table[:, 4:7])) <= {0, 1}:
        raise ValueError("the plan's corner offsets must lie in {0, 1}")
    return StencilPlan(
        masks=torch.tensor(np.asarray(masks, np.float32), device=dev),
        corner_lat=torch.as_tensor(lat, device=dev),
        term_table=torch.as_tensor(table, device=dev),
        plane_ptr=torch.as_tensor(plane_ptr, device=dev),
        schedule=torch.as_tensor(k6_schedule(table, plane_ptr), device=dev),
        NI=int(NI), NJ=int(NJ), NK=int(NK), nslots=int(nslots),
        terms=terms, vec_terms=vec_terms,
        used=tuple(sorted({t[5] for t in terms})),
    )


def k6_schedule(table: np.ndarray, plane_ptr: np.ndarray) -> np.ndarray:
    """K6's jobs over its plane-major term rows `table` (slot, a, b,
    parity, ca, 0) with plane bounds `plane_ptr`.

    A vertex of padded-lattice parity q = (i + j + k) % 2 takes a term of
    parity p and corner offset ca where the cell v - 1 - ca has parity p,
    that is where (q + 1 + |ca|) % 2 == p. For each q, every plane with
    terms is a record: the plane and its terms for q in plan order (none:
    the record stores zeros). Each q's records are dealt into
    ceil(terms / C) jobs, C the largest record, the largest record first,
    each into the job with the fewest terms so far; a job lists its
    records by plane. A thread of K6 takes one job of one vertex, and a
    pair of vertices along k (one of each parity) about C terms a job.
    Layout (int32): J0, J1 (jobs of parity 0, then 1), the number of
    records and of entries, job_ptr (J0 + J1 + 1 record bounds), then
    (plane, first entry, end entry) per record, then the entries (rows of
    `table`)."""
    table = np.asarray(table).reshape(-1, 8)
    plane_ptr = np.asarray(plane_ptr)
    by_parity = []
    for q in (0, 1):
        recs = []
        for o in range(27):
            rows = np.arange(plane_ptr[o], plane_ptr[o + 1])
            if len(rows):
                take = (q + 1 + table[rows, 4:7].sum(1)) % 2 == table[rows, 3]
                recs.append((o, rows[take].tolist()))
        by_parity.append(recs)
    cap = max([len(rows) for recs in by_parity for _, rows in recs] + [1])
    jobs, njobs = [], []
    for recs in by_parity:
        n = max(1, -(-sum(len(rows) for _, rows in recs) // cap))
        load, dealt = [0] * n, [[] for _ in range(n)]
        for o, rows in sorted(recs, key=lambda rec: (-len(rec[1]), rec[0])):
            j = min(range(n), key=lambda j: (load[j], j))
            dealt[j].append((o, rows))
            load[j] += len(rows)
        jobs += [sorted(d) for d in dealt]
        njobs.append(n)
    job_ptr, recs, ents = [0], [], []
    for job in jobs:
        for o, rows in job:
            recs += [o, len(ents), len(ents) + len(rows)]
            ents += rows
        job_ptr.append(len(recs) // 3)
    return np.array([*njobs, len(recs) // 3, len(ents), *job_ptr, *recs,
                     *ents], np.int32)


# ---------------------------------------------------------------------------
# lattice vectors: (nv, d) <-> (d, npad) feature-major, zero ghosts
# ---------------------------------------------------------------------------

def to_lat(plan: StencilPlan, x: torch.Tensor) -> torch.Tensor:
    """(nv, d) -> (d, npad) ghost-padded feature-major."""
    d = x.shape[1]
    out = x.new_zeros((d, plan.NI + 2, plan.NJ + 2, plan.NK + 2))
    out[:, 1:-1, 1:-1, 1:-1] = x.T.reshape(d, plan.NI, plan.NJ, plan.NK)
    return out.reshape(d, plan.npad)


def from_lat(plan: StencilPlan, yl: torch.Tensor) -> torch.Tensor:
    """(d, npad) -> (nv, d)."""
    d = yl.shape[0]
    y = yl.reshape(d, plan.NI + 2, plan.NJ + 2, plan.NK + 2)
    return y[:, 1:-1, 1:-1, 1:-1].reshape(d, plan.nv).T.contiguous()


def _interior(plan: StencilPlan, yl: torch.Tensor) -> torch.Tensor:
    """yl with its ghost entries set to zero."""
    return to_lat(plan, from_lat(plan, yl))


# ---------------------------------------------------------------------------
# K6: W from the element blocks
# ---------------------------------------------------------------------------

def assemble_W_plain(plan: StencilPlan, Gw: torch.Tensor,
                     mass: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K6 (the JAX term loop): for each term in
    plan order, C = sum_n Gw[n, a] (x) Gw[n, b] + mass[a, b] I over the
    cells of its parity, added into plane oid at each cell's corner a."""
    E, N, k, d = Gw.shape
    ns = plan.nslots
    ncells = plan.ncells
    if E != ns * ncells:
        raise ValueError(f"{E} elements for {ncells} cells of {ns} slots")
    NI, NJ, NK = plan.NI, plan.NJ, plan.NK
    NIc, NJc, NKc = NI - 1, NJ - 1, NK - 1
    GwS = Gw.reshape(ncells, ns, N, k, d)
    MS = mass.reshape(ncells, ns, k, k)
    mk = plan.masks.reshape(2, ncells).to(Gw.dtype)
    eye = torch.eye(d, dtype=Gw.dtype, device=Gw.device)
    W = Gw.new_zeros((27, d, d, NI + 2, NJ + 2, NK + 2))
    for (p, t, a, b, (ci, cj, ck), oid) in plan.terms:
        g1, g2 = GwS[:, t, :, a, :], GwS[:, t, :, b, :]   # (ncells, N, d)
        acc = g1[:, 0, :, None] * g2[:, 0, None, :]
        for n in range(1, N):
            acc = acc + g1[:, n, :, None] * g2[:, n, None, :]
        C = (acc + MS[:, t, a, b][:, None, None] * eye) * mk[p][:, None, None]
        W[oid, :, :, 1 + ci:1 + ci + NIc, 1 + cj:1 + cj + NJc,
          1 + ck:1 + ck + NKc] += C.permute(1, 2, 0).reshape(d, d, NIc, NJc, NKc)
    return W.reshape(27, d, d, plan.npad)


def assemble_W(plan: StencilPlan, Gw: torch.Tensor,
               mass: torch.Tensor) -> torch.Tensor:
    """Offset-form system blocks W (27, d, d, npad) from the factored
    stretch rows Gw (E, N, k, d) and the consistent-mass blocks (E, k, k).

    On a CUDA tensor this launches kernel K6; on a CPU tensor it runs
    assemble_W_plain."""
    if Gw.device.type == "cpu":
        return assemble_W_plain(plan, Gw, mass)
    return cuda.stencil_assemble(
        Gw.contiguous(), mass.contiguous(), plan.term_table, plan.plane_ptr,
        (plan.NI, plan.NJ, plan.NK), plan.nslots, plan.schedule,
    )


def diag_blocks(plan: StencilPlan, W: torch.Tensor) -> torch.Tensor:
    """(nv, d, d) diagonal blocks: the o=0 plane of W."""
    d = W.shape[1]
    D = W[CENTER].reshape(d * d, plan.npad)
    return from_lat(plan, D).reshape(plan.nv, d, d)


# ---------------------------------------------------------------------------
# K5: the stencil product
# ---------------------------------------------------------------------------

def stencil_apply_plain(plan: StencilPlan, W: torch.Tensor, xl: torch.Tensor,
                        fm: torch.Tensor | None = None) -> torch.Tensor:
    """Plain PyTorch version of K5 (the JAX shifted block products):
    y[a, v] = fm[a, v] sum_{o used} sum_b W[o, a, b, v] x[b, v + shift_o],
    zero at the ghost vertices."""
    d, npad = xl.shape
    NJp, NKp = plan.NJ + 2, plan.NK + 2
    S = NJp * NKp + NKp + 1
    xfe = F.pad(xl, (S, S))
    y = torch.zeros_like(xl)
    for oid in plan.used:
        di, dj, dk = OFFSETS[oid]
        sh = (di * NJp + dj) * NKp + dk
        y = y + torch.einsum("abn,bn->an", W[oid], xfe[:, S + sh:S + sh + npad])
    if fm is not None:
        y = y * fm
    return _interior(plan, y)


def matvec_lat(plan: StencilPlan, W: torch.Tensor, xl: torch.Tensor,
               fm: torch.Tensor | None = None) -> torch.Tensor:
    """y = A x on (d, npad) lattice vectors, times the lattice free mask
    `fm` (d, npad) when one is given (the CG operator's projection), zero
    at the ghosts.

    On a CUDA tensor this launches kernel K5; on a CPU tensor it runs
    stencil_apply_plain."""
    if xl.device.type == "cpu":
        return stencil_apply_plain(plan, W, xl, fm)
    return cuda.stencil_apply(
        W.contiguous(), xl.contiguous(),
        None if fm is None else fm.contiguous(),
        (plan.NI, plan.NJ, plan.NK), plan.used_mask,
    )


def stencil_matvec(plan: StencilPlan, W: torch.Tensor,
                   x: torch.Tensor) -> torch.Tensor:
    """y = A x on (nv, d) vectors; the caller masks pinned rows."""
    return from_lat(plan, matvec_lat(plan, W, to_lat(plan, x)))


# ---------------------------------------------------------------------------
# corner gather and vertex sums
# ---------------------------------------------------------------------------

def gather_corners_lat(plan: StencilPlan, x_lat: torch.Tensor) -> torch.Tensor:
    """Per-element-corner values of a lattice vector: (m, npad) -> (k*m, E)
    feature-major rows, row index m*a + comp (the JAX layout)."""
    m = x_lat.shape[0]
    E, k = plan.corner_lat.shape
    return x_lat[:, plan.corner_lat].permute(2, 0, 1).reshape(k * m, E)


def scatter_rows_lat(plan: StencilPlan, vplan: assembly.IncidencePlan,
                     rows: torch.Tensor, m: int) -> torch.Tensor:
    """(k*m, E) feature-major rows (row index m*a + comp) -> (m, npad)
    vertex sums on the lattice, zero ghosts: kernel K2 over the mesh's
    incidence plan `vplan` (mesh.plan) on a CUDA tensor, then to_lat."""
    E = rows.shape[-1]
    return to_lat(plan, assembly.segment_sum(
        vplan, rows.reshape(-1, m, E).permute(2, 0, 1)))


# ---------------------------------------------------------------------------
# the lattice preconditioner
# ---------------------------------------------------------------------------

def lattice_two_level_preconditioner(plan: StencilPlan, cs, free_mask, binv,
                                     dim: int = 3):
    """Two-level (or plain block-Jacobi when cs is None) preconditioner on
    (d, npad) lattice vectors: block-Jacobi as an elementwise block product
    in the matvec's layout; the rigid-mode restriction and prolongation as
    lattice reshape-sums (cs must come from
    solvers/coarse.build_coarse_space_grid). Returns apply(rl, Ac_inv)."""
    from mixedfem_tpu_torch.solvers import coarse as coarsemod

    nv = free_mask.shape[0]
    d = dim
    Binv_l = to_lat(plan, binv.reshape(nv, d * d)).reshape(d, d, -1)

    def apply_bj(rl, Ac_inv=None):
        return torch.einsum("abn,bn->an", Binv_l, rl)

    if cs is None:
        return apply_bj
    if cs.grid is None:
        raise ValueError("the lattice preconditioner needs a grid coarse space")
    coarsemod._no_tf32()
    fm_l = to_lat(plan, free_mask[:, None].expand(nv, d).to(binv.dtype))
    restrict, prolong = coarsemod.grid_transfer(cs)
    B = coarsemod._vert_modes(cs, free_mask, d)          # (nv, d, 6)
    B_l = to_lat(plan, B.reshape(nv, d * 6)).reshape(d, 6, -1)

    def apply(rl, Ac_inv):
        z = apply_bj(rl)
        rc = restrict(from_lat(plan, torch.einsum("dan,dn->an", B_l, rl)))
        zc = (Ac_inv @ rc.reshape(-1)).reshape(cs.naggr, 6)
        zv_l = to_lat(plan, prolong(zc))                   # (6, npad)
        return (z + torch.einsum("dan,an->dn", B_l, zv_l)) * fm_l

    return apply
