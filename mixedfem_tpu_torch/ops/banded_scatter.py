"""Segment sum of rows in banded element order: the counterpart of
mixedfem_tpu/ops/pallas_scatter.py (its ``build_banded_scatter_plan`` and
``scatter_add_sorted``, the path of ``_make_kernel``).

Rows ``(Rp, m)`` come in their natural element order, padded to a multiple
of ``chunk`` with zero rows that target the last row's vertex. The plan
keeps the JAX package's arrays (``lidx``, ``win_start`` in 128-lane units,
``W``) so the two can be compared; nothing on the path reads them. Kernel
K4 (csrc/kernels.cu:banded_sum_kernel, ``banded_sum``) reads ``csr``
instead: the incidence plan (ops/assembly.py) of the first ``nrows`` rows
by vertex, each vertex's rows ascending. The zero padding rows are not in
it, and neither the kernel nor ``banded_sum_plain`` reads them.
``out[v] = sum of the rows of v in row order`` (or in the plan's pieces,
where a vertex has more than L rows), the same order in both, so the kernel
and the plain version agree to the last bit where the additions agree.
The sorted ``build_scatter_plan``/``scatter_add`` variant of the JAX
module has no caller on any path and is not ported.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from mixedfem_tpu_torch import cuda
from mixedfem_tpu_torch.device import resolve_device
from mixedfem_tpu_torch.ops import assembly

LANE = 128


@dataclasses.dataclass
class ScatterPlan:
    lidx: torch.Tensor        # (Rp,) int32 window-local index per row
    win_start: torch.Tensor   # (nchunks,) int32 window start, in LANE units
    nrows: int                # rows before padding
    chunk: int                # rows per chunk
    W: int                    # window width (max span of a chunk, lane-padded)
    nv: int
    csr: assembly.IncidencePlan  # K4's plan: each vertex's rows, ascending
    # the sum over ranks after each sum (assembly.IncidencePlan.reduce)
    reduce: Optional[Callable[[torch.Tensor], torch.Tensor]] = None

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
    derives K4's per-vertex CSR from the rows' vertex ids."""
    lidx = np.asarray(lidx, np.int64)
    win_start = np.asarray(win_start, np.int64)
    Rp = len(lidx)
    if Rp % chunk or Rp // chunk != len(win_start):
        raise ValueError("lidx must hold one chunk per window start")
    if Rp >= 2**31:
        raise ValueError("banded plans index rows with int32")
    ids = win_start[np.arange(Rp) // chunk] * LANE + lidx
    if Rp and not (0 <= ids.min() and ids.max() < nv):
        raise ValueError("a row targets a vertex outside [0, nv)")

    def i32(a):
        return torch.as_tensor(np.asarray(a).astype(np.int32), device=device)

    return ScatterPlan(
        lidx=i32(lidx), win_start=i32(win_start), nrows=int(nrows),
        chunk=int(chunk), W=int(W), nv=int(nv),
        csr=assembly.build_incidence_plan(ids[:nrows], int(nv), device),
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
    """Plain PyTorch version of K4 on (Rp, m) rows: each vertex's rows in
    the CSR's order (K2's plain version over plan.csr)."""
    return assembly.segment_sum_plain(plan.csr, rows)


def scatter_add_sorted(plan: ScatterPlan, rows: torch.Tensor) -> torch.Tensor:
    """Segment sum of rows already in the plan's order, (Rp, m) -> (nv, m),
    then over the ranks when the plan has a `reduce`. On a CUDA tensor this
    launches kernel K4; on a CPU tensor it runs banded_sum_plain."""
    Rp = plan.lidx.shape[0]
    if rows.ndim != 2 or rows.shape[0] != Rp:
        raise ValueError(f"rows of shape {tuple(rows.shape)} for a plan over "
                         f"{Rp} rows")
    if rows.device.type == "cpu":
        out = banded_sum_plain(plan, rows)
    else:
        c = plan.csr
        out = cuda.banded_sum(c.row_ptr, c.slots, rows.contiguous(), plan.nv,
                              c.piece_ptr, c.seg_pieces)
    return out if plan.reduce is None else plan.reduce(out)


def pad_rows(plan: ScatterPlan, rows: torch.Tensor) -> torch.Tensor:
    """(R, m) rows in element order, zero-padded to the plan's Rp."""
    pad = plan.lidx.shape[0] - rows.shape[0]
    if pad < 0:
        raise ValueError(f"{rows.shape[0]} rows for a plan over {plan.nrows}")
    if pad == 0:
        return rows
    return torch.cat([rows, rows.new_zeros((pad, rows.shape[1]))], dim=0)
