"""Deterministic element-to-vertex assembly through a static incidence plan.

Takes the place of the JAX package's BrickPlan (ops/brick.py) and of
``jax.ops.segment_sum``: every assembly of the slice (inertia gradient,
rhs, block-Jacobi blocks, the CG matvec's scatter, and the coarse space's
restriction and Galerkin sums) goes through ``segment_sum`` below, which on
a CUDA tensor is kernel K2 (csrc/kernels.cu:segment_sum_kernel).

The plan is built once on the host from the segment id of every row (for
the vertex plan, the element table): for each segment the flat row ids
that land on it (``e*k + corner`` for corner rows), in ascending order,
stored as CSR ``row_ptr (nseg+1)`` / ``slots (R)``. A segment longer than
``piece_rows`` (L) slots is split into consecutive pieces of at most L
slots, so that no warp of K2 walks a long tail alone; a plan whose segments
all fit in L has no pieces. The order of addition is part of the plan: the
rows in slot order within a piece, then the pieces in order within a
segment. It is the same on every run and needs no atomics, and the plain
version adds in the same order.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from mixedfem_tpu_torch import cuda

# most slots per piece (L), chosen on the card by chip_smoke.py's sweep of
# K2 at m=36 over the coarse pair plan of the 100k-tet beam (64 and 128
# tie, 256 is slower); the vertex and aggregate plans there (at most 32
# and 90 slots per segment) have no pieces
PIECE_ROWS = 128


@dataclasses.dataclass
class IncidencePlan:
    row_ptr: torch.Tensor  # (nseg+1,) int32 CSR offsets into slots
    slots: torch.Tensor    # (R,) int32 flat row ids, grouped by segment
    seg: torch.Tensor      # (R,) int64 segment of each entry of slots
    nseg: int
    # None where no segment is longer than the plan's piece length
    piece_ptr: Optional[torch.Tensor] = None   # (P+1,) int32 slot offsets
    seg_pieces: Optional[torch.Tensor] = None  # (nseg+1,) int32 piece offsets
    piece_seg: Optional[torch.Tensor] = None   # (P,) int64 segment of each
    # the sum over ranks that follows every sum over the plan: on a rank of
    # the element-sharded step (parallel/sharding.py) the plan spans the
    # rank's elements and `reduce` is its comm.psum; None on one device
    reduce: Optional[Callable[[torch.Tensor], torch.Tensor]] = None

    @property
    def nrows(self) -> int:
        return self.slots.shape[0]

    @property
    def npieces(self) -> int:
        """Pieces the kernel's first launch sums (a segment with no pieces
        counts as one)."""
        if self.piece_ptr is None:
            return self.nseg
        return self.piece_ptr.shape[0] - 1


def build_incidence_plan(seg: np.ndarray, nseg: int, device,
                         piece_rows: int = PIECE_ROWS) -> IncidencePlan:
    """Plan for rows whose segment ids are `seg` (any shape, flattened in
    C order, e.g. the element table T for (E, k, ...) corner rows)."""
    seg = np.asarray(seg).reshape(-1).astype(np.int64)
    if seg.shape[0] >= 2**31:
        raise ValueError("incidence plans index rows with int32")
    if piece_rows < 1:
        raise ValueError(f"pieces of {piece_rows} rows")
    order = np.argsort(seg, kind="stable")
    counts = np.bincount(seg, minlength=nseg)
    row_ptr = np.zeros(nseg + 1, np.int64)
    np.cumsum(counts, out=row_ptr[1:])

    def i32(a):
        return torch.as_tensor(a.astype(np.int32), device=device)

    plan = IncidencePlan(
        row_ptr=i32(row_ptr), slots=i32(order),
        seg=torch.as_tensor(seg[order], device=device), nseg=nseg,
    )
    if nseg == 0 or counts.max() <= piece_rows:
        return plan
    per_seg = np.maximum(-(-counts // piece_rows), 1)
    seg_pieces = np.zeros(nseg + 1, np.int64)
    np.cumsum(per_seg, out=seg_pieces[1:])
    piece_seg = np.repeat(np.arange(nseg), per_seg)
    k = np.arange(seg_pieces[-1]) - seg_pieces[piece_seg]
    piece_ptr = np.append(row_ptr[piece_seg] + k * piece_rows, row_ptr[-1])
    return dataclasses.replace(
        plan, piece_ptr=i32(piece_ptr), seg_pieces=i32(seg_pieces),
        piece_seg=torch.as_tensor(piece_seg, device=device),
    )


def segment_sum_plain(plan: IncidencePlan, rows: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K2 on (R, m) rows: the rows in plan order
    added into their segments with index_add_, or, where the plan has
    pieces, into their pieces and the pieces into their segments. On the
    CPU index_add_ adds in index order, which is the kernel's order."""
    out = rows.new_zeros((plan.nseg, rows.shape[1]))
    gathered = rows[plan.slots.long()]
    if plan.piece_ptr is None:
        return out.index_add_(0, plan.seg, gathered)
    piece = torch.repeat_interleave(
        torch.arange(plan.npieces, device=rows.device), plan.piece_ptr.diff(),
        output_size=plan.nrows)
    part = rows.new_zeros((plan.npieces, rows.shape[1]))
    return out.index_add_(0, plan.piece_seg, part.index_add_(0, piece, gathered))


def segment_sum(plan: IncidencePlan, rows: torch.Tensor) -> torch.Tensor:
    """Sum rows (E, k, *trail) into segments: (nseg, *trail), then over the
    ranks when the plan has a `reduce`.

    On a CUDA tensor this launches kernel K2; on a CPU tensor it runs
    segment_sum_plain."""
    trail = tuple(rows.shape[2:])
    m = 1
    for s in trail:
        m *= s
    flat = rows.reshape(-1, m)
    if flat.shape[0] != plan.nrows:
        raise ValueError(
            f"{flat.shape[0]} rows for a plan over {plan.nrows} slots"
        )
    if flat.device.type == "cpu":
        out = segment_sum_plain(plan, flat)
    else:
        out = cuda.segment_sum(
            plan.row_ptr, plan.slots, flat.contiguous(), plan.nseg,
            plan.piece_ptr, plan.seg_pieces,
        )
    if plan.reduce is not None:
        out = plan.reduce(out)
    return out.reshape((plan.nseg,) + trail)


def with_reduce(plan, reduce):
    """A copy of the incidence or banded plan `plan` whose sums are
    followed by `reduce` (the element-sharded step's comm.psum); None stays
    None."""
    if plan is None or plan.reduce == reduce:
        return plan
    return dataclasses.replace(plan, reduce=reduce)
