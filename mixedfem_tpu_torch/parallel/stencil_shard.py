"""I-slab sharding of the structured-grid path (port of
mixedfem_tpu/parallel/stencil_shard.py).

The vertex lattice is split into contiguous I-axis slabs, one per rank,
and the whole Newton step runs per rank on its slab:

  update     ms.update on a rank-local MeshData (K3) whose connectivity
             indexes the halo-extended rows of (Si + 1) vertex planes (the
             +1 plane is the right neighbour's first), so every per-element
             function of the single-device step works unchanged;
  rhs        the corner rows summed by K2 over the rank-local incidence
             plan, whose rows are the slab's lattice positions; the spill
             plane (contributions of the rank's last cell plane to the
             right neighbour's first vertex plane) goes right by one shift;
  W          K6 over the slab's own cell planes, with the slab's own term
             table and schedule (the cell parity of a slab that starts at
             an odd plane is flipped), the spill plane sent right;
  matvec     K5 on the slab with one vertex plane from each neighbour;
  precond    block-Jacobi from W's centre plane, and the lattice-block
             coarse residual summed per aggregate (K2) and psum'd, solved
             with the dense inverse that every rank builds (the JAX step's
             once-a-step coarse build, before its shard_map);
  cg, merit  psum'd dot products; the merit as a rank-local sum and a
             psum at each alpha of the line search; the decrement by pmax.

Padding, as in the JAX package: the pad cell planes' element data repeat
the first cell plane's real rows (dphidX, mu, lam, s), their volumes and
mass are zero; the pad vertex planes take a rest lattice extrapolated
along I, so that padded elements see F ~ I and stay finite.

Scope, the JAX step's: 3D mixed-stretch solids on a box grid in
cell-major element order, 'pcg' with block-Jacobi or the grid coarse
space, BDF1-6, no contact. The host plan (ShardStencilPlan) equals the
JAX package's.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from mixedfem_tpu_torch.integrators import bdf as bdfmod
from mixedfem_tpu_torch.ops import assembly
from mixedfem_tpu_torch.ops import stencil as stmod
from mixedfem_tpu_torch.solvers import coarse as coarsemod
from mixedfem_tpu_torch.solvers import pcg as pcgmod
from mixedfem_tpu_torch.variables import displacement as disp
from mixedfem_tpu_torch.variables import mixed_stretch as ms


@dataclasses.dataclass
class ShardStencilPlan:
    """Static I-slab partition, host numpy; leading axis of every array =
    rank."""

    masks: np.ndarray    # (D, 2, Sc, NJc, NKc) cell parity indicators
    emask: np.ndarray    # (D, Sc * NJc * NKc * ns) valid-element mask
    NI: int
    NJ: int
    NK: int
    nslots: int
    terms: tuple
    D: int
    Si: int              # vertex planes per rank (NI padded to D * Si)
    Sc: int              # cell planes per rank (= Si)

    @property
    def plane(self) -> int:
        """Flat size of one lattice plane (ghost-padded J/K)."""
        return (self.NJ + 2) * (self.NK + 2)

    @property
    def per_plane(self) -> int:
        """Elements of one cell plane."""
        return (self.NJ - 1) * (self.NK - 1) * self.nslots


def build_shard_plan(plan: stmod.StencilPlan, n_shards: int) -> ShardStencilPlan:
    """Split the box lattice of `plan` into n_shards I-slabs: rank s owns
    vertex planes [s Si, (s+1) Si) and the cell planes with the same
    indices (cell plane ci touches vertex planes ci and ci + 1; the spill
    into plane (s+1) Si goes to the right neighbour)."""
    NI, NJ, NK, ns = plan.NI, plan.NJ, plan.NK, plan.nslots
    NIc, NJc, NKc = NI - 1, NJ - 1, NK - 1
    D = n_shards
    Si = -(-NI // D)
    Sc = Si
    pc = (np.add.outer(np.add.outer(np.arange(D * Sc), np.arange(NJc)),
                       np.arange(NKc))) % 2
    valid = (np.arange(D * Sc) < NIc)[:, None, None]
    masks = np.stack([(pc == 0) & valid, (pc == 1) & valid]).astype(np.float32)
    masks = masks.reshape(2, D, Sc, NJc, NKc).transpose(1, 0, 2, 3, 4)
    emask = np.repeat(valid[:, 0, 0], NJc * NKc * ns).reshape(
        D, Sc * NJc * NKc * ns)
    return ShardStencilPlan(
        masks=masks, emask=emask.astype(np.float32), NI=NI, NJ=NJ, NK=NK,
        nslots=ns, terms=plan.terms, D=D, Si=Si, Sc=Sc)


# ---------------------------------------------------------------------------
# vertex fields and element rows <-> slabs (torch, any device)
# ---------------------------------------------------------------------------

def shard_element_rows(sp: ShardStencilPlan, rows: torch.Tensor) -> torch.Tensor:
    """(E, ...) cell-major element data -> (D, Eshard, ...) zero-padded
    I-slab shards."""
    return _pad_elem(sp, rows, "zero")


def _pad_elem(sp: ShardStencilPlan, rows: torch.Tensor, mode="zero"):
    """(E, ...) cell-major element data -> (D, Eloc, ...) I-slab shards.
    mode 'zero' pads with zeros (vols, mass); 'tile' repeats the first
    cell plane's real rows (dphidX, mu, lam, model_id, s), so that padded
    elements stay finite through the polar and the materials."""
    per_plane = sp.per_plane
    Epad = sp.D * sp.Sc * per_plane
    n = rows.shape[0]
    if Epad > n:
        if mode == "tile":
            reps = -(-(Epad - n) // per_plane)
            pad = rows[:per_plane].repeat((reps,) + (1,) * (rows.dim() - 1))
            pad = pad[: Epad - n]
        else:
            pad = rows.new_zeros((Epad - n,) + tuple(rows.shape[1:]))
        rows = torch.cat([rows, pad])
    return rows.reshape((sp.D, sp.Sc * per_plane) + tuple(rows.shape[1:]))


def shard_vertex_field(sp: ShardStencilPlan, x: torch.Tensor) -> torch.Tensor:
    """(nv, d) -> (D, d, Si * plane) ghost-padded (J and K) I-slabs."""
    d = x.shape[1]
    x3 = x.reshape(sp.NI, sp.NJ, sp.NK, d)
    xp = torch.nn.functional.pad(
        x3, (0, 0, 1, 1, 1, 1, 0, sp.D * sp.Si - sp.NI))
    return xp.reshape(sp.D, sp.Si * sp.plane, d).permute(0, 2, 1).contiguous()


def shard_vertex_ints(sp: ShardStencilPlan, ids: torch.Tensor,
                      sentinel: int) -> torch.Tensor:
    """(nv,) int vertex ids -> (D, Si * plane), ghost and pad positions
    `sentinel`."""
    i3 = ids.reshape(sp.NI, sp.NJ, sp.NK)
    ip = torch.nn.functional.pad(i3, (1, 1, 1, 1, 0, sp.D * sp.Si - sp.NI),
                                 value=sentinel)
    return ip.reshape(sp.D, sp.Si * sp.plane)


def unshard_vertex_field(sp: ShardStencilPlan, xs: torch.Tensor) -> torch.Tensor:
    """(D, d, Si * plane) -> (nv, d)."""
    d = xs.shape[1]
    xp = xs.permute(0, 2, 1).reshape(sp.D * sp.Si, sp.NJ + 2, sp.NK + 2, d)
    return xp[: sp.NI, 1:-1, 1:-1].reshape(sp.NI * sp.NJ * sp.NK, d)


def build_local_T(sp: ShardStencilPlan, T) -> np.ndarray:
    """Rank-local connectivity (D, Eloc, k) int32: the global cell-major T
    mapped to rows of the halo-extended local vector ((Si+1) planes of
    (NJ+2)(NK+2), J/K ghost offset +1). Padded elements reuse the first
    cell plane's local pattern (their volumes are zero)."""
    T = np.asarray(T)
    NJ, NK = sp.NJ, sp.NK
    NJp, NKp = NJ + 2, NK + 2
    per_plane = sp.per_plane
    E, k = T.shape
    gi, gj, gk = T // (NJ * NK), (T // NK) % NJ, T % NK
    shard = (np.arange(E) // per_plane) // sp.Sc
    li = gi - (shard * sp.Si)[:, None]
    lv = (li * NJp + (gj + 1)) * NKp + (gk + 1)
    Epad = sp.D * sp.Sc * per_plane
    if Epad > E:
        reps = -(-(Epad - E) // per_plane)
        lv = np.concatenate([lv, np.tile(lv[:per_plane], (reps, 1))[: Epad - E]])
    return lv.reshape(sp.D, sp.Sc * per_plane, k).astype(np.int32)


def build_rest_rows(sp: ShardStencilPlan, V0) -> np.ndarray:
    """(D, (Si+1) * plane, d) rest positions of the halo-extended local
    rows, extrapolated linearly beyond the box along I and edge-clamped at
    the J/K ghosts."""
    NI, NJ, NK = sp.NI, sp.NJ, sp.NK
    V3 = np.asarray(V0).reshape(NI, NJ, NK, -1)
    ext_n = sp.D * sp.Si + 1
    if ext_n > NI:
        step = V3[NI - 1] - V3[NI - 2] if NI >= 2 else 0.0 * V3[0]
        extra = V3[NI - 1][None] + step[None] * np.arange(
            1, ext_n - NI + 1, dtype=V3.dtype).reshape(-1, 1, 1, 1)
        V3 = np.concatenate([V3, extra], axis=0)
    V3 = np.pad(V3, ((0, 0), (1, 1), (1, 1), (0, 0)), mode="edge")
    return np.stack([V3[s * sp.Si: s * sp.Si + sp.Si + 1].reshape(
        -1, V3.shape[-1]) for s in range(sp.D)])


def build_valid_rows(sp: ShardStencilPlan) -> np.ndarray:
    """(D, (Si+1) * plane) 1.0 where a local row is a real lattice vertex
    (owned or halo), 0.0 at I-pad planes and J/K ghosts (float32)."""
    NI, NJ, NK = sp.NI, sp.NJ, sp.NK
    ii = np.arange(sp.D * sp.Si + 1) < NI
    jj = (np.arange(NJ + 2) >= 1) & (np.arange(NJ + 2) <= NJ)
    kk = (np.arange(NK + 2) >= 1) & (np.arange(NK + 2) <= NK)
    v = ii[:, None, None] & jj[None, :, None] & kk[None, None, :]
    return np.stack([v[s * sp.Si: s * sp.Si + sp.Si + 1].reshape(-1)
                     for s in range(sp.D)]).astype(np.float32)


def shard_vertex_rows_halo(sp: ShardStencilPlan, f: torch.Tensor) -> torch.Tensor:
    """(nv, m) static vertex field -> (D, (Si+1) * plane, m) halo-extended
    rows (the +1 plane is the right ring neighbour's first owned plane)."""
    xs = shard_vertex_field(sp, f)                       # (D, m, Si*plane)
    halo = torch.roll(xs[..., : sp.plane], -1, dims=0)
    return torch.cat([xs, halo], dim=-1).permute(0, 2, 1)


def shard_local_mesh(sp: ShardStencilPlan, mesh, rank: int):
    """Rank `rank`'s MeshData: its slab's element data (padded), the
    connectivity into its halo-extended rows with the incidence plan over
    them, its halo-extended vertex fields; mass_diag and mass_lumped zero
    (the step takes its diagonal from W), V0 the rest rows."""
    nvloc = (sp.Si + 1) * sp.plane
    dt, dev = mesh.vols.dtype, mesh.device
    T = build_local_T(sp, mesh.T.cpu().numpy())[rank]
    zeros_v = torch.zeros((nvloc,), dtype=dt, device=dev)

    def elem(rows, mode):
        return _pad_elem(sp, rows, mode)[rank].contiguous()

    return dataclasses.replace(
        mesh,
        V0=torch.as_tensor(build_rest_rows(sp, mesh.V0.cpu().numpy())[rank],
                           device=dev).to(mesh.V0.dtype),
        T=torch.as_tensor(T, device=dev),
        dphidX=elem(mesh.dphidX, "tile"),
        vols=elem(mesh.vols, "zero"),
        mass_coeff=elem(mesh.mass_coeff, "zero"),
        mass_lumped=zeros_v, mass_diag=zeros_v,
        free_mask=shard_vertex_rows_halo(sp, mesh.free_mask[:, None])[rank, :, 0]
        .contiguous(),
        mu=elem(mesh.mu, "tile"), lam=elem(mesh.lam, "tile"),
        model_id=elem(mesh.model_id, "tile"),
        ext_force=shard_vertex_rows_halo(sp, mesh.ext_force)[rank].contiguous(),
        obj_id=torch.zeros((nvloc,), dtype=torch.int32, device=dev),
        F_srf=mesh.F_srf[:0], E_srf=mesh.E_srf[:0],
        plan=assembly.build_incidence_plan(T, nvloc, dev),
    )


def slab_plan(sp: ShardStencilPlan, rank: int, device) -> stmod.StencilPlan:
    """The StencilPlan of rank `rank`'s slab for K5 and K6: a lattice of
    (Sc + 1) vertex planes (its own and the spill plane) over its Sc cell
    planes, with the terms' cell parity flipped where the slab starts at an
    odd cell plane, so that its own term table and K6 schedule see the
    global parity."""
    flip = (rank * sp.Sc) % 2
    terms = tuple((p ^ flip, t, a, b, ca, o) for (p, t, a, b, ca, o) in sp.terms)
    vec_terms = tuple((p, t, a, ca) for (p, t, a, b, ca, _o) in terms if b == 0)
    NJc, NKc = sp.NJ - 1, sp.NK - 1
    pc = (np.add.outer(np.add.outer(np.arange(sp.Sc), np.arange(NJc)),
                       np.arange(NKc))) % 2
    masks = np.stack([pc == 0, pc == 1]).astype(np.float32)
    return stmod.plan_from_terms(sp.Sc + 1, sp.NJ, sp.NK, sp.nslots, terms,
                                 vec_terms, masks, device)


# ---------------------------------------------------------------------------
# the rank's lattice operations
# ---------------------------------------------------------------------------

def assemble_local(sp: ShardStencilPlan, comm, splan, Gw, mass, emask):
    """This rank's W (27, d, d, (Si + 3) * plane) on its slab lattice
    (planes: ghost, own Si, the right halo, ghost): K6 over its own cells
    (Gw and mass masked by emask), then the right neighbour's spill added
    to the first own plane; the rank's own spill plane (the halo plane) is
    left as assembled."""
    plane, Sc = sp.plane, sp.Sc
    W = stmod.assemble_W(splan, Gw * emask[:, None, None, None],
                         mass * emask[:, None, None])          # K6
    spill = comm.shift(W[..., (Sc + 1) * plane: (Sc + 2) * plane], +1)
    W[..., plane: 2 * plane] += spill
    return W


def local_pcg(sp: ShardStencilPlan, comm, splan, W, b, x0, fm, binv,
              max_iters: int, tol: float, B6=None, agg_plan=None,
              agg=None, naggr: int = 0, Aci=None):
    """Preconditioned CG on this rank's slab vectors (d, Si * plane): the
    matvec K5 on [left plane | own | right plane | 0] with W from
    assemble_local, block-Jacobi from binv (d, d, Si * plane) and, with
    B6 (d, 6, Si * plane), the lattice-block coarse space (the residual
    summed per aggregate by K2 over agg_plan and psum'd, aggregate ids
    `agg` with naggr at pads). Returns (x, iterations, rel_residual)."""
    plane, Si = sp.plane, sp.Si
    d = b.shape[0]
    use_coarse = B6 is not None and Aci is not None
    zero = b.new_zeros((d, plane))
    last_rank, first_rank = comm.rank == comm.size - 1, comm.rank == 0
    fm_l = torch.cat([zero, fm, zero, zero], dim=1)

    def A(p):
        # the left neighbour's last plane and the right neighbour's first;
        # the ring's wrap-around planes at the ends are zeroed
        last, first = comm.ring(p[:, (Si - 1) * plane:], p[:, :plane])
        if first_rank:
            last = torch.zeros_like(last)
        if last_rank:
            first = torch.zeros_like(first)
        pb = torch.cat([last, p, first, zero], dim=1)
        y = stmod.matvec_lat(splan, W, pb, fm_l)               # K5
        return y[:, plane: (Si + 1) * plane]

    def Minv(r):
        z = torch.einsum("abn,bn->an", binv, r)
        if use_coarse:
            w = torch.einsum("dan,dn->an", B6, r)               # (6, n)
            rc = assembly.segment_sum(agg_plan, w.T[:, None, :])[:naggr]
            rc = comm.psum(rc)
            zc = (Aci @ rc.reshape(-1)).reshape(naggr, 6)
            zv = torch.cat([zc, zc.new_zeros((1, 6))])[agg]
            z = z + torch.einsum("dan,na->dn", B6, zv) * fm
        return z

    def dots(r, z):
        """(r . z, r . r), one psum for the pair."""
        return comm.psum(torch.stack([torch.sum(r * z), torch.sum(r * r)]))

    bnorm2 = comm.psum(torch.sum(b * b))
    safe_b = torch.where(bnorm2 > 0, bnorm2, torch.ones_like(bnorm2))
    tol2 = (tol * tol) * safe_b
    x = x0
    r = b - A(x0)
    z = Minv(r)
    p = z
    rz, rr = dots(r, z)
    it = 0
    while it < max_iters and bool(rr > tol2):
        Ap = A(p)
        denom = comm.psum(torch.sum(p * Ap))
        alpha = rz / torch.where(denom != 0, denom, torch.ones_like(denom))
        x = x + alpha * p
        r = r - alpha * Ap
        z = Minv(r)
        rz_new, rr = dots(r, z)
        beta = rz_new / torch.where(rz != 0, rz, torch.ones_like(rz))
        p = z + beta * p
        rz = rz_new
        it += 1
    return x, it, torch.sqrt(rr / safe_b)


def _coarse_slabs(sp, rank, coarse, free_mask, dim, dev):
    """(B6 (d, 6, Si * plane), agg (Si * plane,) int64 with naggr at pads,
    agg_plan) of rank `rank`'s slab."""
    B = coarsemod._vert_modes(coarse, free_mask, dim)
    B6 = shard_vertex_field(sp, B.reshape(-1, dim * 6))[rank].reshape(
        dim, 6, sp.Si * sp.plane)
    agg = shard_vertex_ints(sp, coarse.agg_id, coarse.naggr)[rank].long()
    plan = assembly.build_incidence_plan(agg.cpu().numpy(), coarse.naggr + 1,
                                         dev)
    return B6, agg, plan


@dataclasses.dataclass
class RankSlab:
    """One rank's static slab data for sharded_newton_step, built once
    (rank_slab), as JAX builds it once when it traces the step."""

    mesh: object              # the rank's MeshData (shard_local_mesh)
    splan: stmod.StencilPlan  # its K5/K6 plan (slab_plan)
    valid: torch.Tensor       # (nvloc, 1) real lattice rows
    xrest: torch.Tensor       # (nvloc, d) the rest rows off the lattice
    emask: torch.Tensor       # (Eloc,) real elements
    fm: torch.Tensor          # (d, Si * plane) free mask of the own slab
    coarse: dict              # B6, agg_plan, agg, naggr of the grid coarse
                              # space ({} without one)


def rank_slab(sp: ShardStencilPlan, mesh, rank: int, coarse=None) -> RankSlab:
    """Rank `rank`'s RankSlab on the mesh's device and dtype, with the grid
    coarse space's slab tables when `coarse` is given."""
    dev, dtype, d = mesh.device, mesh.vols.dtype, mesh.dim
    mesh_l = shard_local_mesh(sp, mesh, rank)
    valid = torch.as_tensor(build_valid_rows(sp)[rank], device=dev).to(
        dtype)[:, None]
    kw = {}
    if coarse is not None:
        B6, agg, aplan = _coarse_slabs(sp, rank, coarse, mesh.free_mask, d, dev)
        kw = dict(B6=B6, agg_plan=aplan, agg=agg, naggr=coarse.naggr)
    return RankSlab(
        mesh=mesh_l, splan=slab_plan(sp, rank, dev), valid=valid,
        xrest=mesh_l.V0 * (1.0 - valid),
        emask=torch.as_tensor(sp.emask[rank], device=dev).to(dtype),
        fm=shard_vertex_field(sp, mesh.free_mask[:, None].expand(
            mesh.nv, d).to(dtype))[rank],
        coarse=kw)


def sharded_pcg(sp: ShardStencilPlan, comm, Gw, mass, b, x0, fm, binv,
                max_iters: int, tol: float, coarse=None, free_mask=None,
                Ac_inv=None):
    """This rank's CG on its slab (the JAX sharded_pcg's body): Gw (Eloc,
    6, 4, 3) and mass (Eloc, 4, 4) of its cells (shard_element_rows), b,
    x0, fm (d, Si * plane) and binv (d, d, Si * plane) of its slab
    (shard_vertex_field), and optionally the grid coarse space with the
    global free mask and the dense inverse Ac_inv. Returns (x, iterations,
    rel_residual), the last two the same on every rank."""
    dev = b.device
    splan = slab_plan(sp, comm.rank, dev)
    emask = torch.as_tensor(sp.emask[comm.rank], device=dev).to(b.dtype)
    W = assemble_local(sp, comm, splan, Gw, mass, emask)
    kw = {}
    if coarse is not None:
        B6, agg, aplan = _coarse_slabs(sp, comm.rank, coarse, free_mask,
                                       b.shape[0], dev)
        kw = dict(B6=B6, agg_plan=aplan, agg=agg, naggr=coarse.naggr,
                  Aci=Ac_inv)
    return local_pcg(sp, comm, splan, W, b, x0, fm, binv, max_iters, tol, **kw)


def sharded_newton_step(sp: ShardStencilPlan, comm, slab: RankSlab, mesh,
                        config, state, coarse=None):
    """One implicit BDF step of this rank, sharded over I-slabs, from the
    whole mesh (cell-major element order) and state that every rank holds,
    with the rank's static slab data `slab` (rank_slab, with the same
    coarse space); returns the updated SimState in that layout, the same
    on every rank (the slabs gathered). The once-a-step coarse build
    (coarse_matrix, its LU inverse) runs on every rank from the whole mesh
    before the slabs, as the JAX step runs it before its shard_map; every
    per-Newton O(n) piece runs on the rank's slab."""
    from mixedfem_tpu_torch.optimizer.newton import SimState, empty_stats

    if mesh.dim != 3 or mesh.shell or mesh.rod:
        raise NotImplementedError("the sharded stencil step covers 3D solids")
    if "mixed-stretch" not in config.mixed_variables:
        raise NotImplementedError("the sharded stencil step needs mixed-stretch")
    if state.contact.frames.shape[0] > 0:
        raise NotImplementedError(
            "sharded stencil step: contact runs on parallel/vp_step.py")
    if coarse is not None and coarse.grid is None:
        raise ValueError("the sharded stencil step needs a grid coarse space")
    if (coarse is not None) != bool(slab.coarse):
        raise ValueError("slab and step need the same coarse space")

    rank, dev = comm.rank, mesh.device
    plane, Si = sp.plane, sp.Si
    dt = bdfmod.bdf_dt(state.bdf)
    h2 = dt * dt
    dtype = state.x.dtype
    outer = config.outer_steps
    d = mesh.dim
    mesh_l, splan, valid, emask, fm = (slab.mesh, slab.splan, slab.valid,
                                       slab.emask, slab.fm)
    fm_n = fm[0]
    eye = torch.eye(d, dtype=dtype, device=dev)

    # --- the rank's share of the state -----------------------------------
    bdf_l = dataclasses.replace(
        state.bdf,
        x_hist=torch.stack([shard_vertex_rows_halo(sp, h)[rank]
                            for h in state.bdf.x_hist]),
        v_hist=torch.stack([shard_vertex_rows_halo(sp, h)[rank]
                            for h in state.bdf.v_hist]))
    x0_sl = shard_vertex_field(sp, state.x)[rank]
    s0 = _pad_elem(sp, state.s, "tile")[rank]
    la0 = _pad_elem(sp, state.la, "zero")[rank]

    kw = dict(slab.coarse)
    if coarse is not None:
        # the once-a-step coarse build, on the whole mesh
        Ac = coarsemod.coarse_matrix(mesh, coarse,
                                     ms.update(mesh, state.x, state.s, dt))
        kw["Aci"] = coarsemod.coarse_inverse(Ac)

    def halo_rows(sl):
        """(d, Si * plane) own slab -> (nvloc, d) halo-extended rows, zero
        at pad and ghost positions."""
        h = comm.shift(sl[:, :plane], -1)          # the right neighbour's
        return torch.cat([sl, h], dim=1).T * valid

    def to_slab(rows):
        return rows.T[:, : Si * plane]

    xrest = slab.xrest                             # the additive rest blend

    def merit(x_rows, s_t, la_t, Sv=None):
        E = (disp.energy(mesh_l, bdf_l, x_rows) + h2 * ms.energy(mesh_l, s_t)
             + ms.constraint_value(mesh_l, x_rows, s_t, la_t, Sv=Sv))
        return comm.psum(E)

    t_rows = disp.target(mesh_l, bdf_l, blend=config.inertia_blend_factor)
    eps_E = 0.0 if config.ls_strict else 16.0 * torch.finfo(dtype).eps

    stats = empty_stats(outer, dtype, dev)
    x_sl, s, la = x0_sl, s0, la0
    it = 0
    E_prev = torch.zeros((), dtype=dtype, device=dev)
    dec = res = float("inf")
    while it < outer and dec > config.newton_tol and res > 1e-12:
        xh = halo_rows(x_sl) + xrest
        coeffs = ms.update(mesh_l, xh, s, dt)                          # K3
        # the rhs: K2 over the slab's rows, then the spill plane
        rows = ms.rhs_contrib(mesh_l, coeffs, s) - disp.gradient_contrib(
            mesh_l, bdf_l, xh, blend=config.inertia_blend_factor)
        bl = assembly.segment_sum(mesh_l.plan, rows).T                # K2
        b_sl = bl[:, : Si * plane].clone()
        b_sl[:, :plane] += comm.shift(bl[:, Si * plane:], +1)
        b_sl = b_sl * fm
        # W (K6) with the spill; block-Jacobi from its centre plane
        W = assemble_local(sp, comm, splan, coeffs.Gw, mesh_l.mass_coeff,
                           emask)
        blocks = W[stmod.CENTER, :, :, plane: (Si + 1) * plane]
        reg = blocks * fm_n + eye[:, :, None] * (1.0 - fm_n)
        binv = pcgmod._small_inv(reg.permute(2, 0, 1)).permute(1, 2, 0) * fm_n

        dx0 = to_slab(t_rows - xh) * fm
        dx_sl, cg_iters, cg_err = local_pcg(
            sp, comm, splan, W, b_sl, dx0, fm, binv,
            config.max_iterative_solver_iters, config.itr_tol, **kw)

        dxh = halo_rows(dx_sl)
        ds, la_new = ms.local_solve(mesh_l, coeffs, s, dxh)
        ds = ds * emask[:, None]
        la_new = la_new * emask[:, None]
        dec_t = comm.pmax(torch.maximum(dx_sl.abs().amax(), ds.abs().amax()))

        E = merit(xh, s, la_new, Sv=coeffs.Sv)
        res_t = torch.abs((E - E_prev) / (E + 1e-6))
        E_thresh = E + eps_E * E.abs() if eps_E else E
        alpha, ls_k = 1.0, 0
        while ls_k < config.ls_iters and bool(
                merit(xh + alpha * dxh, s + alpha * ds, la_new) >= E_thresh):
            alpha *= 0.5
            ls_k += 1
        step = alpha if ls_k < config.ls_iters else 0.0
        x_sl = x_sl + step * dx_sl
        s = s + step * ds
        la = la_new

        stats.energy[it] = E
        stats.energy_res[it] = res_t
        stats.decrement[it] = dec_t
        stats.alpha[it] = alpha
        stats.solver_iters[it] = cg_iters
        stats.solver_error[it] = cg_err
        it += 1
        stats.iterations = it
        E_prev = E
        dec, res = float(dec_t), float(res_t)

    # --- gather the slabs, push the BDF history, clear la -----------------
    x_new = unshard_vertex_field(sp, torch.stack(comm.all_gather(x_sl)))
    E_real = mesh.nelem
    s_new = torch.cat(comm.all_gather(s))[:E_real]
    return SimState(
        x=x_new, s=s_new, la=torch.zeros_like(s_new),
        bdf=bdfmod.bdf_update(state.bdf, x_new), bc_states=state.bc_states,
        contact=state.contact, press_states=state.press_states,
        step_count=state.step_count + 1, stats=stats,
        precond=state.precond, power_v0=state.power_v0, R=state.R)
