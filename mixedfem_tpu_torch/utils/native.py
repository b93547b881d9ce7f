"""Build, load and call the host C++ helpers (csrc/native.cpp): IC(0) and
its triangular solves.

The library is compiled at first use with ``g++ -O3 -std=c++17 -shared
-fPIC`` into ``mixedfem_tpu_torch/_build/`` (named by a hash of the source
and the flags, so an edited source is rebuilt) and loaded with ctypes.
Nothing runs at import time. A failed build raises: no caller falls back
to a Python loop.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import numpy as np

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "native.cpp"
BUILD_DIR = _PKG / "_build"
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")

_lib = None


def library_path() -> Path:
    digest = hashlib.sha256(
        SOURCE.read_bytes() + " ".join(CXX_FLAGS).encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"libmfem_native_{digest}.so"


def build() -> Path:
    """Compile csrc/native.cpp unless the library for this source exists."""
    out = library_path()
    if out.exists():
        return out
    cxx = shutil.which(os.environ.get("CXX", "g++"))
    if cxx is None:
        raise RuntimeError("g++ not found: the native helpers cannot be built")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, str(SOURCE)],
                       check=True, capture_output=True, text=True)
        os.replace(tmp, out)
    except subprocess.CalledProcessError as err:
        raise RuntimeError(f"g++ failed:\n{err.stderr}") from err
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out


def _load():
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(build()))
    i64, dp = ctypes.c_longlong, ctypes.POINTER(ctypes.c_double)
    lp = ctypes.POINTER(ctypes.c_longlong)
    lib.ichol0.restype = ctypes.c_double
    lib.ichol0.argtypes = [i64, lp, lp, dp]
    lib.ichol_solve.restype = None
    lib.ichol_solve.argtypes = [i64, lp, lp, dp, dp]
    _lib = lib
    return lib


def _check(a: np.ndarray, dtype, name: str) -> None:
    if a.dtype != dtype or not a.flags.c_contiguous:
        raise ValueError(f"{name} must be a contiguous {np.dtype(dtype)} array")


def _dptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def _lptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong))


def ichol0(indptr: np.ndarray, indices: np.ndarray, data: np.ndarray) -> float:
    """IC(0) of a lower-triangular CSR (int64 indptr and indices, ascending
    per row with the diagonal last; float64 data overwritten with L).
    Returns the diagonal shift applied; raises np.linalg.LinAlgError on a
    bad pattern or when 12 shifts do not make it factor."""
    for a, t, n in ((indptr, np.int64, "indptr"), (indices, np.int64, "indices"),
                    (data, np.float64, "data")):
        _check(a, t, n)
    sigma = _load().ichol0(len(indptr) - 1, _lptr(indptr), _lptr(indices),
                           _dptr(data))
    if sigma < 0.0:
        raise np.linalg.LinAlgError(
            "IC(0) breakdown after 12 shift retries (or a pattern that is "
            "not lower-triangular with its diagonal last)")
    return float(sigma)


def ichol_solve(indptr: np.ndarray, indices: np.ndarray, data: np.ndarray,
                x: np.ndarray) -> None:
    """x <- (L L^T)^{-1} x in place, L from ichol0."""
    for a, t, n in ((indptr, np.int64, "indptr"), (indices, np.int64, "indices"),
                    (data, np.float64, "data"), (x, np.float64, "x")):
        _check(a, t, n)
    _load().ichol_solve(len(indptr) - 1, _lptr(indptr), _lptr(indices),
                        _dptr(data), _dptr(x))
