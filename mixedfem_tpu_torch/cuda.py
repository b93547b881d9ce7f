"""Build, load and launch the hand-written CUDA kernels (csrc/kernels.cu).

The kernels are compiled at first use with
``nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared`` into
``mixedfem_tpu_torch/_build/`` (named by a hash of the source, so an edited
source is rebuilt) and loaded with ctypes. Nothing here runs at import time.

Each launcher checks device, dtype, shape and contiguity, allocates its
outputs with ``torch.empty``, launches on ``torch.cuda.current_stream()``,
raises if the launch reports a CUDA error, and adds one to its entry of
``LAUNCHES`` and of ``LAUNCHES_BY_TYPE``. The launchers take CUDA tensors only: the CPU path is the plain
PyTorch version beside each wrapper (ops/assembly.py, solvers/operator.py,
ops/smallops.py, ops/banded_scatter.py, ops/stencil.py), chosen there by
the device of the input.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import NamedTuple, Optional

import torch

_PKG = Path(__file__).resolve().parent
SOURCE = _PKG / "csrc" / "kernels.cu"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

# launches per kernel (segment_sum and banded_sum counted per row width m,
# element_apply, contract_G_Gw and contract_Gw per element shape under the
# names SHAPES gives them); a caller clears it before a run and reads it
# after, to show the run went through the kernels
LAUNCHES: collections.Counter = collections.Counter()
# the same launches split by type, under the same names with "_f32" or
# "_f64" appended (a step with f64 islands runs K2 and K3 in both types)
LAUNCHES_BY_TYPE: collections.Counter = collections.Counter()


def clear_launches() -> None:
    """Set every launch count, of both counters, to 0."""
    LAUNCHES.clear()
    LAUNCHES_BY_TYPE.clear()


def _count(name: str, suffix: str) -> None:
    LAUNCHES[name] += 1
    LAUNCHES_BY_TYPE[f"{name}_{suffix}"] += 1

_lib = None


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library_path() -> Path:
    digest = hashlib.sha256(
        SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"libmfem_kernels_{digest}.so"


def build() -> Path:
    """Compile csrc/kernels.cu unless the library for this source exists."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(SOURCE)],
            check=True, capture_output=True, text=True,
        )
        os.replace(tmp, out)
    except subprocess.CalledProcessError as err:
        raise RuntimeError(f"nvcc failed:\n{err.stderr}") from err
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out


def _load():
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(build()))
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    k1_k3 = [n for sh in SHAPES.values() for n in (sh.k1, sh.k3) if n]
    k7 = [sh.k7 for sh in SHAPES.values() if sh.k7]
    for suffix in ("f32", "f64"):
        for name in k1_k3:
            getattr(lib, f"mf_{name}_{suffix}").argtypes = [vp] * 6 + [i32, vp]
        for name in k7:
            getattr(lib, f"mf_{name}_{suffix}").argtypes = [vp] * 4 + [i32, vp]
        getattr(lib, f"mf_contract_G_Gw_tile_{suffix}").argtypes = [vp] * 6 + [i32] * 2 + [vp]
        for name in ("segment_sum", "banded_sum"):
            getattr(lib, f"mf_{name}_{suffix}").argtypes = [vp] * 7 + [i32] * 4 + [vp]
        getattr(lib, f"mf_stencil_apply_{suffix}").argtypes = [vp] * 4 + [i32] * 4 + [vp]
        getattr(lib, f"mf_stencil_assemble_{suffix}").argtypes = [vp] * 6 + [i32] * 6 + [vp]
        for name in k1_k3 + k7 + ["segment_sum", "contract_G_Gw_tile",
                                  "banded_sum", "stencil_apply",
                                  "stencil_assemble"]:
            getattr(lib, f"mf_{name}_{suffix}").restype = i32
    lib.mf_error_string.argtypes = [i32]
    lib.mf_error_string.restype = ctypes.c_char_p
    _lib = lib
    return lib


_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}


def _check(t: torch.Tensor, name: str, shape, dtype, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _float_dtype(t: torch.Tensor) -> str:
    if t.device.type != "cuda":
        raise ValueError(f"the CUDA kernels take CUDA tensors, got {t.device}")
    if t.dtype not in _SUFFIX:
        raise TypeError(f"the CUDA kernels take float32 or float64, got {t.dtype}")
    return _SUFFIX[t.dtype]


def _launch(fn_name: str, suffix: str, *args) -> None:
    lib = _load()
    code = getattr(lib, f"mf_{fn_name}_{suffix}")(
        *args, torch.cuda.current_stream().cuda_stream
    )
    if code != 0:
        msg = lib.mf_error_string(code).decode()
        raise RuntimeError(f"CUDA kernel {fn_name} failed: {msg} ({code})")


class Shape(NamedTuple):
    """An element shape's stretch values N and its kernels' names: K1's,
    K3's (solids, whose G is D : dphi) or K7's (shells and rods, whose G
    comes from a Jacobian)."""

    N: int
    k1: str
    k3: Optional[str]
    k7: Optional[str]


# the element shapes, keyed by (corners k, dimension d): tets, 2D
# triangles, shells (3D triangles) and rods (3D segments). A shell and a 2D
# triangle both have k = 3, so the key is the pair.
SHAPES = {
    (4, 3): Shape(6, "element_apply", "contract_G_Gw", None),
    (3, 2): Shape(3, "element_apply_k3d2", "contract_G_Gw_n3", None),
    (3, 3): Shape(6, "element_apply_k3d3", None, "contract_Gw_k3d3"),
    (2, 3): Shape(6, "element_apply_k2d3", None, "contract_Gw_k2d3"),
}


def _shape(k: int, d: int) -> Shape:
    if (k, d) not in SHAPES:
        raise ValueError(f"elements of {k} corners in {d} dimensions: the "
                         f"kernels have instances for {sorted(SHAPES)}")
    return SHAPES[(k, d)]


def element_apply(T, Gw, mass, free_mask, p) -> torch.Tensor:
    """K1: per-corner rows (E, k, d) of (M_e (x) I + Gw_e^T Gw_e) P p_e, for
    tets (k=4, d=3, Gw (E, 6, 4, 3)), triangles (k=3, d=2, Gw (E, 3, 3,
    2)), shells (k=3, d=3, Gw (E, 6, 3, 3)) or rods (k=2, d=3, Gw (E, 6, 2,
    3))."""
    sfx = _float_dtype(p)
    dev, dt = p.device, p.dtype
    E, k = T.shape[0], T.shape[-1]
    nv, d = p.shape[0], p.shape[-1]
    N, name, _, _ = _shape(k, d)
    _check(T, "T", (E, k), torch.int32, dev)
    _check(Gw, "Gw", (E, N, k, d), dt, dev)
    _check(mass, "mass", (E, k, k), dt, dev)
    _check(free_mask, "free_mask", (nv,), dt, dev)
    _check(p, "p", (nv, d), dt, dev)
    out = torch.empty((E, k, d), dtype=dt, device=dev)
    _launch(
        name, sfx, T.data_ptr(), Gw.data_ptr(), mass.data_ptr(),
        free_mask.data_ptr(), p.data_ptr(), out.data_ptr(), E,
    )
    _count(name, sfx)
    return out


# K2 and K4 give each lane of a warp at most two of a row's columns
MAX_WIDTH = 64


def _gather(fn_name, row_ptr, slots, rows, nseg, piece_ptr, seg_pieces):
    """Check and launch K2 or K4 over the CSR (row_ptr, slots) of `nseg`
    segments, or over its pieces (piece_ptr) and then each segment's
    partials (seg_pieces), as ops/assembly.py plans them."""
    sfx = _float_dtype(rows)
    dev, dt = rows.device, rows.dtype
    R, m = rows.shape
    if not 0 < m <= MAX_WIDTH:
        raise ValueError(f"rows of width {m}: {fn_name} takes 1 to {MAX_WIDTH}")
    _check(row_ptr, "row_ptr", (nseg + 1,), torch.int32, dev)
    _check(slots, "slots", (slots.shape[0],), torch.int32, dev)
    _check(rows, "rows", (R, m), dt, dev)
    if (piece_ptr is None) != (seg_pieces is None):
        raise ValueError("piece_ptr and seg_pieces come together")
    out = torch.empty((nseg, m), dtype=dt, device=dev)
    npieces, part = 0, None
    if piece_ptr is not None:
        npieces = piece_ptr.shape[0] - 1
        _check(piece_ptr, "piece_ptr", (npieces + 1,), torch.int32, dev)
        _check(seg_pieces, "seg_pieces", (nseg + 1,), torch.int32, dev)
        part = torch.empty((npieces, m), dtype=dt, device=dev)
    _launch(
        fn_name, sfx, row_ptr.data_ptr(), slots.data_ptr(),
        None if piece_ptr is None else piece_ptr.data_ptr(),
        None if seg_pieces is None else seg_pieces.data_ptr(),
        rows.data_ptr(), None if part is None else part.data_ptr(),
        out.data_ptr(), nseg, npieces, slots.shape[0], m,
    )
    return out


def segment_sum(row_ptr, slots, rows, nseg: int, piece_ptr=None,
                seg_pieces=None) -> torch.Tensor:
    """K2: out[v] = sum of rows[slots[row_ptr[v]:row_ptr[v+1]]] in slot
    order, (nseg, m); with pieces, per piece and then per segment in piece
    order. One count per call, whatever it launches."""
    if slots.shape[0] != rows.shape[0]:
        raise ValueError(f"{rows.shape[0]} rows for {slots.shape[0]} slots")
    out = _gather("segment_sum", row_ptr, slots, rows, nseg, piece_ptr,
                  seg_pieces)
    _count(f"segment_sum_m{rows.shape[1]}", _SUFFIX[rows.dtype])
    return out


# K3's tile sizes, elements per block (contract_G_Gw takes the kernel's
# own, kK3Tile)
CONTRACT_TILES = (16, 32, 64)


def contract_G_Gw(D, dphi, Hs, vols):
    """K3: G = D : dphi and Gw = sqrt(vol) Hs G, both (E, N, k, d), for
    tets (D (E, 6, 3, 3), dphi (E, 4, 3), Hs (E, 6, 6)) or triangles (D
    (E, 3, 2, 2), dphi (E, 3, 2), Hs (E, 3, 3))."""
    return _contract_G_Gw(D, dphi, Hs, vols, None)


def contract_G_Gw_tile(D, dphi, Hs, vols, tile: int):
    """K3's tet instance in tiles of `tile` elements, one of
    CONTRACT_TILES."""
    if tile not in CONTRACT_TILES:
        raise ValueError(f"tile {tile}: K3 takes one of {CONTRACT_TILES}")
    if tuple(dphi.shape[1:]) != (4, 3):
        raise ValueError("K3's tile sizes are offered for tets only")
    return _contract_G_Gw(D, dphi, Hs, vols, tile)


def _contract_G_Gw(D, dphi, Hs, vols, tile):
    sfx = _float_dtype(D)
    dev, dt = D.device, D.dtype
    E, k, d = dphi.shape[0], dphi.shape[1], dphi.shape[-1]
    N, _, name, _ = _shape(k, d)
    if name is None:
        raise ValueError(f"K3 has no instance for elements of {k} corners in "
                         f"{d} dimensions: their G is a Jacobian's (K7)")
    _check(D, "D", (E, N, d, d), dt, dev)
    _check(dphi, "dphi", (E, k, d), dt, dev)
    _check(Hs, "Hs", (E, N, N), dt, dev)
    _check(vols, "vols", (E,), dt, dev)
    G = torch.empty((E, N, k, d), dtype=dt, device=dev)
    Gw = torch.empty((E, N, k, d), dtype=dt, device=dev)
    args = (D.data_ptr(), dphi.data_ptr(), Hs.data_ptr(), vols.data_ptr(),
            G.data_ptr(), Gw.data_ptr(), E)
    if tile is None:
        _launch(name, sfx, *args)
    else:
        _launch("contract_G_Gw_tile", sfx, *args, tile)
    _count(name, sfx)
    return G, Gw


def contract_Gw(Hs, G, vols):
    """K7: Gw = sqrt(vol) Hs G, (E, N, k, d), from a given G (E, N, k, d),
    Hs (E, N, N) and vol (E,), for shells (k=3, d=3) and rods (k=2,
    d=3)."""
    sfx = _float_dtype(G)
    dev, dt = G.device, G.dtype
    if G.dim() != 4:
        raise ValueError(f"G has shape {tuple(G.shape)}, expected (E, N, k, d)")
    E, _, k, d = G.shape
    N, _, _, name = _shape(k, d)
    if name is None:
        raise ValueError(f"K7 has no instance for elements of {k} corners "
                         f"in {d} dimensions: their G and Gw come from K3")
    _check(Hs, "Hs", (E, N, N), dt, dev)
    _check(G, "G", (E, N, k, d), dt, dev)
    _check(vols, "vols", (E,), dt, dev)
    Gw = torch.empty((E, N, k, d), dtype=dt, device=dev)
    _launch(name, sfx, Hs.data_ptr(), G.data_ptr(), vols.data_ptr(),
            Gw.data_ptr(), E)
    _count(name, sfx)
    return Gw


def banded_sum(row_ptr, slots, rows, nv: int, piece_ptr=None,
               seg_pieces=None) -> torch.Tensor:
    """K4: out[v] = sum of the rows (Rp, m) in banded element order whose
    vertex is v, through the per-vertex CSR (row_ptr, slots) of those rows
    (ascending; rows that no slot names, the zero padding, are left out),
    (nv, m)."""
    if slots.shape[0] > rows.shape[0]:
        raise ValueError(f"{rows.shape[0]} rows for {slots.shape[0]} slots")
    out = _gather("banded_sum", row_ptr, slots, rows, nv, piece_ptr,
                  seg_pieces)
    _count(f"banded_sum_m{rows.shape[1]}", _SUFFIX[rows.dtype])
    return out


def _lattice(dims):
    NI, NJ, NK = (int(n) for n in dims)
    if min(NI, NJ, NK) < 2:
        raise ValueError(f"a vertex lattice of {dims}: K5 and K6 take 2 or more a side")
    return NI, NJ, NK, (NI + 2) * (NJ + 2) * (NK + 2)


def stencil_apply(W, x, fm, dims, used: int) -> torch.Tensor:
    """K5: y[a, v] = fm[a, v] sum_{o in used} sum_b W[o, a, b, v]
    x[b, v + shift_o] on the ghost-padded lattice of `dims` vertices,
    (3, npad), zero at the ghosts; `used` has bit o set for each offset
    plane to read, and fm None means no mask."""
    sfx = _float_dtype(x)
    dev, dt = x.device, x.dtype
    NI, NJ, NK, npad = _lattice(dims)
    if not 0 <= used < 1 << 27:
        raise ValueError(f"plane mask {used:#x} names planes outside 0..26")
    _check(W, "W", (27, 3, 3, npad), dt, dev)
    _check(x, "x", (3, npad), dt, dev)
    if fm is not None:
        _check(fm, "fm", (3, npad), dt, dev)
    y = torch.empty((3, npad), dtype=dt, device=dev)
    _launch(
        "stencil_apply", sfx, W.data_ptr(), x.data_ptr(),
        None if fm is None else fm.data_ptr(), y.data_ptr(), NI, NJ, NK, used,
    )
    _count("stencil_apply", sfx)
    return y


def stencil_assemble(Gw, mass, term_table, plane_ptr, dims, nslots: int,
                     schedule):
    """K6: W (27, 3, 3, npad) from Gw (E, 6, 4, 3) and mass (E, 4, 4) of a
    cell-major, slot-minor box grid: each plane o adds, at every lattice
    vertex, its terms term_table[plane_ptr[o]:plane_ptr[o+1]] (rows of
    slot, a, b, parity, corner offset of a, 0) in order, each the block
    sum_n Gw[e, n, a] (x) Gw[e, n, b] + mass[e, a, b] I of the element
    (cell, slot) whose corner a is the vertex, over the cells of the term's
    parity; zero where no term lands. `schedule` is the kernel's job table
    over those rows (ops/stencil.py:k6_schedule, StencilPlan.schedule),
    one entry per row. One count, two launches: the planes no term
    touches, then the tiles."""
    sfx = _float_dtype(Gw)
    dev, dt = Gw.device, Gw.dtype
    NI, NJ, NK, npad = _lattice(dims)
    if not 1 <= nslots <= 255:
        raise ValueError(f"{nslots} slots per cell: K6 takes 1 to 255")
    E = (NI - 1) * (NJ - 1) * (NK - 1) * nslots
    _check(Gw, "Gw", (E, 6, 4, 3), dt, dev)
    _check(mass, "mass", (E, 4, 4), dt, dev)
    _check(term_table, "term_table", (term_table.shape[0], 8), torch.int32, dev)
    _check(plane_ptr, "plane_ptr", (28,), torch.int32, dev)
    nterms = term_table.shape[0]
    _check(schedule, "schedule", (schedule.shape[0],), torch.int32, dev)
    if schedule.shape[0] < 5 + nterms:
        raise ValueError(f"a schedule of {schedule.shape[0]} values for "
                         f"{nterms} term rows: K6 takes one entry per row")
    W = torch.empty((27, 3, 3, npad), dtype=dt, device=dev)
    _launch(
        "stencil_assemble", sfx, Gw.data_ptr(), mass.data_ptr(),
        term_table.data_ptr(), plane_ptr.data_ptr(), schedule.data_ptr(),
        W.data_ptr(), NI, NJ, NK, nslots, nterms, schedule.shape[0],
    )
    _count("stencil_assemble", sfx)
    return W
