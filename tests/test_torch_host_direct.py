"""Parity of the port's host direct-solve pieces (solvers/direct.py,
utils/native.py, csrc/native.cpp) with mixedfem_tpu/solvers/direct.py,
in float64 on the CPU: the assembled condensed CSR (mixed stretch alone,
with mixed-collision blocks, with the vanilla stretch, with frame
Hessians; 3D and 2D) to 1e-12 relative, scipy's exact solve, the IC(0)
factor (native against the Python row loop and the JAX package's
preconditioner, with and without the shift-and-retry), IC-PCG's iterate
and count, and the native build that raises when it fails."""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from mixedfem_tpu.mesh import mesh as jmesh
from mixedfem_tpu.solvers import direct as jdir
from mixedfem_tpu.variables import mixed_stretch as jms
from mixedfem_tpu.variables import stretch as jvs
from mixedfem_tpu_torch.solvers import direct as tdir
from mixedfem_tpu_torch.utils import native
from mixedfem_tpu_torch.variables import mixed_stretch as tms
from mixedfem_tpu_torch.variables import stretch as tvs

from torch_parity import (  # noqa: F401 (one_torch_thread is a fixture)
    beam_arrays, one_torch_thread, port, t64, to_numpy, tri_arrays,
)


@pytest.fixture(scope="module", autouse=True)
def _one_thread(one_torch_thread):
    """Every test of this module runs on one torch intra-op thread."""


DT = 0.02


def _inputs(dim):
    """A deformed 360-tet beam (3D) or 200-triangle cantilever (2D), both
    packages' mixed and vanilla coefficients there (the port's carried
    across from JAX's), and seeded contact blocks and frame Hessians."""
    V, T, kw, x = beam_arrays(seed=0) if dim == 3 else tri_arrays(seed=0)
    jm = jmesh.build_mesh_data(V, T, dtype=jnp.float64, **kw)
    tm, _, _ = port(mesh=jm)
    s = tms.reset(tm, t64(x))[0].numpy()
    s = s + 0.01 * np.random.default_rng(1).standard_normal(s.shape)
    jc = jms.update(jm, jnp.asarray(x), jnp.asarray(s), DT)
    tc = tms.StretchCoeffs(**{k: t64(v) for k, v in to_numpy(jc).items()})
    jv = jvs.update(jm, jnp.asarray(x), DT)
    tv = tvs.VanillaCoeffs(**{k: t64(v) for k, v in to_numpy(jv).items()})
    rng = np.random.default_rng(2)
    n = 17
    frames = np.stack([rng.choice(len(V), 4, replace=False) for _ in range(n)])
    Gx = rng.standard_normal((n, 4, dim))
    Hc = rng.uniform(0.5, 2.0, n)
    active = (rng.uniform(size=n) > 0.3).astype(np.float64)
    Hf = rng.standard_normal((n, 4 * dim, 4 * dim))
    Hf = Hf @ Hf.transpose(0, 2, 1)
    return dict(jm=jm, tm=tm, jc=jc, tc=tc, jv=jv, tv=tv,
                contact=(frames, Gx, Hc, active), fh=[(frames[::-1], Hf)])


@pytest.fixture(scope="module", params=[3, 2], ids=["3d", "2d"])
def inputs(request):
    return _inputs(request.param)


def _same_csr(a, b, rtol=1e-12):
    a, b = a.tocsr(), b.tocsr()
    a.sort_indices()
    b.sort_indices()
    np.testing.assert_array_equal(a.indptr, b.indptr)
    np.testing.assert_array_equal(a.indices, b.indices)
    np.testing.assert_allclose(a.data, b.data, rtol=rtol,
                               atol=rtol * np.abs(b.data).max())


@pytest.mark.parametrize("terms", ["mixed", "contact", "vanilla", "frames",
                                   "vanilla_only"])
def test_assemble_condensed(inputs, terms):
    d = inputs
    kj = dict(ms_coeffs=None if terms == "vanilla_only" else d["jc"])
    kt = dict(ms_coeffs=None if terms == "vanilla_only" else d["tc"])
    if terms == "contact":
        kj["contact"] = kt["contact"] = d["contact"]
    if terms in ("vanilla", "vanilla_only"):
        kj["v_coeffs"], kt["v_coeffs"] = d["jv"], d["tv"]
    if terms == "frames":
        kj["frame_hessians"] = kt["frame_hessians"] = d["fh"]
    A_j = jdir.assemble_condensed(d["jm"], **kj)
    A_t = tdir.assemble_condensed(d["tm"], **kt)
    _same_csr(A_t, A_j)


def test_solve_direct(inputs):
    d = inputs
    A = jdir.assemble_condensed(d["jm"], d["jc"], v_coeffs=d["jv"])
    b = np.random.default_rng(3).standard_normal(A.shape[0])
    want = jdir.solve_direct(A, b)
    np.testing.assert_allclose(tdir.solve_direct(A, b), want, rtol=0,
                               atol=1e-12 * np.abs(want).max())


def _spd_fem_like(n=120, seed=0):
    """tests/test_ichol.py's sparse SPD matrix with FEM-like bands."""
    rng = np.random.default_rng(seed)
    diags = [rng.uniform(0.1, 1.0, n - k) for k in (1, 2, 7)]
    A = sp.diags(diags + [np.zeros(n)] + diags, [-1, -2, -7, 0, 1, 2, 7],
                 format="csr")
    A = A + sp.diags(np.asarray(np.abs(A).sum(axis=1)).ravel() + 1.0)
    return A.tocsr()


def _starved():
    """The shift-retry case of tests/test_ichol.py: one pivot starved so
    that the unshifted factorization breaks down."""
    A = _spd_fem_like(30).tolil()
    A[5, 5] = 1e-3
    return A.tocsr()


@pytest.mark.parametrize("case", ["fem_like", "starved", "beam"])
def test_ichol0_native_python_jax(case):
    if case == "beam":
        d = _inputs(3)
        A = jdir.assemble_condensed(d["jm"], d["jc"])
    else:
        A = _spd_fem_like() if case == "fem_like" else _starved()
    M = tdir.ICholPreconditioner(A)
    Mj = jdir.ICholPreconditioner(A)
    L = sp.tril(A, format="csr")
    L.sort_indices()
    data = np.ascontiguousarray(L.data, np.float64)
    sigma = tdir._ichol0_python(L.indptr.astype(np.int64),
                                L.indices.astype(np.int64), data)
    assert M.shift == sigma == Mj.shift
    if case != "beam":  # the beam's condensed matrix needs a shift too
        assert (M.shift > 0.0) == (case == "starved")
    np.testing.assert_allclose(M._data, data, rtol=1e-12, atol=1e-13)
    np.testing.assert_allclose(M._data, Mj._data, rtol=1e-12, atol=1e-13)
    r = np.random.default_rng(4).standard_normal(A.shape[0])
    want = Mj.apply(r)
    np.testing.assert_allclose(M.apply(r), want, rtol=0,
                               atol=1e-12 * np.abs(want).max())


@pytest.mark.parametrize("tol,maxiter", [(1e-8, 500), (1e-2, 500), (1e-12, 7)])
def test_solve_ic_pcg(tol, maxiter):
    d = _inputs(3)
    A = jdir.assemble_condensed(d["jm"], d["jc"], v_coeffs=d["jv"])
    b = np.random.default_rng(5).standard_normal(A.shape[0])
    xj, nj = jdir.solve_ic_pcg(A, b, tol, maxiter)
    xt, nt = tdir.solve_ic_pcg(A, b, tol, maxiter)
    assert nt == nj
    np.testing.assert_allclose(xt, xj, rtol=0, atol=1e-12 * np.abs(xj).max())


def test_native_build_failure_raises(tmp_path, monkeypatch):
    """A source that does not compile raises at first use; nothing falls
    back to the Python row loop."""
    bad = tmp_path / "native.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        tdir.ICholPreconditioner(_spd_fem_like())


def test_native_library_is_the_ports_own():
    """The port builds csrc/native.cpp of its own package into its _build
    directory and names it by the source's hash."""
    tdir.ICholPreconditioner(_spd_fem_like())
    path = native.library_path()
    assert path.exists() and path.parent.name == "_build"
    assert path.parent.parent.name == "mixedfem_tpu_torch"
    assert native.SOURCE.parent.parent.name == "mixedfem_tpu_torch"
    # no module of the port loads the JAX package's library
    pkg = native.SOURCE.parent.parent
    for src in list(pkg.rglob("*.py")) + [pkg.parent / "chip_smoke.py"]:
        assert "libmfem_native.so" not in src.read_text(), src


def test_breakdown_raises():
    """A lower pattern without its diagonal (row 0 of [[0, 1], [1, 2]]
    stores nothing) raises LinAlgError, as a factorization that 12 shifts
    do not repair does."""
    A = sp.csr_matrix(np.array([[0.0, 1.0], [1.0, 2.0]]))
    with pytest.raises(np.linalg.LinAlgError):
        tdir.ICholPreconditioner(A)
    assert torch.get_num_threads() == 1
