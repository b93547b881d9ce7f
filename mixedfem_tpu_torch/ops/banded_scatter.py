"""Windowed segment sum of rows in banded element order: the counterpart of
mixedfem_tpu/ops/pallas_scatter.py (its ``build_banded_scatter_plan`` and
``scatter_add_sorted``, the path of ``_make_kernel``).

Rows ``(Rp, m)`` come in their natural element order, padded to a multiple
of ``chunk`` with zero rows that target the last row's vertex. The plan
keeps the JAX package's arrays (``lidx``, ``win_start`` in 128-lane units,
``W``) so the two can be compared, and adds what kernel K4
(csrc/kernels.cu:banded_partial_kernel, ``banded_sum``) needs to sum in a
fixed order without atomics:

- stage 1, one block per chunk: the chunk's distinct destination vertices
  ("partials", ascending), and for each the chunk's rows that target it, in
  row order (``grp_ptr``/``grp_rows``, local row ids);
- stage 2, per vertex: the partials of the chunks that touch it, in chunk
  order (``vert_ptr``/``vert_parts``).

``out[v] = sum over chunks c (in order) of (sum of c's rows of v, in row
order)``. ``banded_sum_plain`` adds in exactly that order, so the kernel
and the plain version agree to the last bit where the additions agree.
The sorted ``build_scatter_plan``/``scatter_add`` variant of the JAX
module has no caller on any path and is not ported.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from mixedfem_tpu_torch import cuda
from mixedfem_tpu_torch.device import resolve_device

LANE = 128


@dataclasses.dataclass
class ScatterPlan:
    lidx: torch.Tensor        # (Rp,) int32 window-local index per row
    win_start: torch.Tensor   # (nchunks,) int32 window start, in LANE units
    nrows: int                # rows before padding
    chunk: int                # rows per chunk
    W: int                    # window width (max span of a chunk, lane-padded)
    nv: int
    # K4's fixed-order plan (see the module docstring)
    chunk_part_ptr: torch.Tensor  # (nchunks+1,) int32 partials of each chunk
    grp_ptr: torch.Tensor     # (P+1,) int32 offsets into grp_rows
    grp_rows: torch.Tensor    # (Rp,) int32 local row ids grouped by partial
    vert_ptr: torch.Tensor    # (nv+1,) int32 offsets into vert_parts
    vert_parts: torch.Tensor  # (P,) int32 partials grouped by vertex
    part_of_row: torch.Tensor  # (Rp,) int64 partial of each row (plain)
    part_vertex: torch.Tensor  # (P,) int64 vertex of each partial (plain)

    @property
    def nparts(self) -> int:
        return self.part_vertex.shape[0]

    @property
    def nchunks(self) -> int:
        return self.win_start.shape[0]


def _window_arrays(ids_p: np.ndarray, nv: int, chunk: int, lane: int = LANE):
    """JAX's windows (pallas_scatter.py:208-225): lane-aligned start per
    chunk, W, and the window-local index of every row."""
    nchunks = len(ids_p) // chunk
    blocks = ids_p.reshape(nchunks, chunk)
    starts = (blocks.min(axis=1) // lane) * lane
    W = int((blocks.max(axis=1) - starts).max()) + 1 if nchunks else 1
    W = ((W + lane - 1) // lane) * lane
    nv_pad = ((max(nv, W) + lane - 1) // lane) * lane
    starts = np.minimum(starts, nv_pad - W)
    lidx = (blocks - starts[:, None]).reshape(-1).astype(np.int32)
    if nchunks:
        assert lidx.min() >= 0 and lidx.max() < W
    return (starts // lane).astype(np.int32), lidx, W


def plan_from_arrays(*, lidx, win_start, nrows, chunk, W, nv,
                     device) -> ScatterPlan:
    """ScatterPlan from the JAX plan's arrays (win_start in lane units);
    derives K4's fixed-order plan from the rows' vertex ids."""
    lidx = np.asarray(lidx, np.int64)
    win_start = np.asarray(win_start, np.int64)
    Rp = len(lidx)
    if Rp % chunk or Rp // chunk != len(win_start):
        raise ValueError("lidx must hold one chunk per window start")
    if Rp >= 2**31:
        raise ValueError("banded plans index rows with int32")
    nchunks = len(win_start)
    cidx = np.arange(Rp) // chunk
    ids = win_start[cidx] * LANE + lidx
    if Rp and not (0 <= ids.min() and ids.max() < nv):
        raise ValueError("a row targets a vertex outside [0, nv)")
    # stage 1: one partial per distinct (chunk, vertex), chunk-major
    uniq, part_of_row = np.unique(cidx * nv + ids, return_inverse=True)
    part_of_row = part_of_row.reshape(-1)
    P = len(uniq)
    part_vertex = uniq % max(nv, 1)
    chunk_part_ptr = np.searchsorted(uniq // max(nv, 1), np.arange(nchunks + 1))
    order = np.argsort(part_of_row, kind="stable")
    grp_ptr = np.zeros(P + 1, np.int64)
    np.cumsum(np.bincount(part_of_row, minlength=P), out=grp_ptr[1:])
    # stage 2: partials of each vertex in chunk order (partial ids ascend
    # with the chunk, so a stable sort by vertex keeps that order)
    vert_parts = np.argsort(part_vertex, kind="stable")
    vert_ptr = np.zeros(nv + 1, np.int64)
    np.cumsum(np.bincount(part_vertex, minlength=nv), out=vert_ptr[1:])

    def i32(a):
        return torch.as_tensor(np.asarray(a).astype(np.int32), device=device)

    return ScatterPlan(
        lidx=i32(lidx), win_start=i32(win_start), nrows=int(nrows),
        chunk=int(chunk), W=int(W), nv=int(nv),
        chunk_part_ptr=i32(chunk_part_ptr), grp_ptr=i32(grp_ptr),
        grp_rows=i32(order % chunk), vert_ptr=i32(vert_ptr),
        vert_parts=i32(vert_parts),
        part_of_row=torch.as_tensor(part_of_row.astype(np.int64), device=device),
        part_vertex=torch.as_tensor(part_vertex.astype(np.int64), device=device),
    )


def build_banded_scatter_plan(seg_ids: np.ndarray, nv: int, chunk: int = 2048,
                              device="cuda") -> ScatterPlan:
    """Plan for rows consumed in their natural order (no sorting): a banded
    row order (elements sorted by min vertex) keeps each chunk's window
    small, but any order is summed correctly; only W grows. The plan lives
    on `device` (raises if that is a CUDA device and none is present)."""
    seg_ids = np.asarray(seg_ids, np.int64).reshape(-1)
    R = len(seg_ids)
    Rp = ((R + chunk - 1) // chunk) * chunk
    ids_p = np.concatenate(
        [seg_ids, np.full(Rp - R, seg_ids[-1] if R else 0, np.int64)]
    )
    win_start, lidx, W = _window_arrays(ids_p, nv, chunk)
    return plan_from_arrays(lidx=lidx, win_start=win_start, nrows=R,
                            chunk=chunk, W=W, nv=nv,
                            device=resolve_device(device))


def banded_sum_plain(plan: ScatterPlan, rows: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K4 on (Rp, m) rows: per-chunk partials added
    in row order, then per-vertex sums of the partials in chunk order. On
    the CPU index_add_ adds in index order, which is the kernel's order."""
    m = rows.shape[1]
    part = rows.new_zeros((plan.nparts, m)).index_add_(0, plan.part_of_row, rows)
    return rows.new_zeros((plan.nv, m)).index_add_(0, plan.part_vertex, part)


def scatter_add_sorted(plan: ScatterPlan, rows: torch.Tensor) -> torch.Tensor:
    """Windowed segment sum of rows already in the plan's order, (Rp, m) ->
    (nv, m). On a CUDA tensor this launches kernel K4; on a CPU tensor it
    runs banded_sum_plain."""
    Rp = plan.lidx.shape[0]
    if rows.ndim != 2 or rows.shape[0] != Rp:
        raise ValueError(f"rows of shape {tuple(rows.shape)} for a plan over "
                         f"{Rp} rows")
    if rows.device.type == "cpu":
        return banded_sum_plain(plan, rows)
    return cuda.banded_sum(
        plan.chunk_part_ptr, plan.grp_ptr, plan.grp_rows, plan.vert_ptr,
        plan.vert_parts, rows.contiguous(), plan.chunk, plan.nv,
    )


def pad_rows(plan: ScatterPlan, rows: torch.Tensor) -> torch.Tensor:
    """(R, m) rows in element order, zero-padded to the plan's Rp."""
    pad = plan.lidx.shape[0] - rows.shape[0]
    if pad < 0:
        raise ValueError(f"{rows.shape[0]} rows for a plan over {plan.nrows}")
    if pad == 0:
        return rows
    return torch.cat([rows, rows.new_zeros((pad, rows.shape[1]))], dim=0)
