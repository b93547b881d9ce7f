"""Parity of mixedfem_tpu_torch's small per-element ops with mixedfem_tpu's
on the same numpy inputs, in float64 on the CPU: sym-vec packing, Jacobi
eigendecomposition, polar / ds/dF (inverted and near-degenerate F included),
the PSD fix and the six S-space materials (their densities also against
the JAX row body's hand copy, ops/rows.py:psi_rows).

Tolerances: both sides run the same fixed-sweep algorithms in f64, so they
agree to rounding (1e-10 relative, with an absolute floor where a value
can cancel to zero)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mixedfem_tpu.materials import models as jmat
from mixedfem_tpu.ops import psd as jpsd
from mixedfem_tpu.ops import rotation as jrot
from mixedfem_tpu.ops import rows as jrows
from mixedfem_tpu.ops import sym as jsym
from mixedfem_tpu_torch.materials import models as tmat
from mixedfem_tpu_torch.ops import psd as tpsd
from mixedfem_tpu_torch.ops import rotation as trot
from mixedfem_tpu_torch.ops import sym as tsym

from torch_parity import close, one_torch_thread, t64  # noqa: F401


@pytest.fixture(scope="module", autouse=True)
def _one_thread(one_torch_thread):
    """Every test of this module runs on one torch intra-op thread."""


_jacobi = jax.jit(jrot.jacobi_eigh, static_argnames="sweeps")
_polar33 = jax.jit(jrot.polar33, static_argnames="sweeps")
_dsdF33 = jax.jit(jrot.dsdF33)
_psd_sqrt = jax.jit(jpsd.psd_fix_sqrt, static_argnames=("tol", "sweeps"))


def _rand_F(n, seed=0, scale=1.0):
    """Copy of tests/test_rotation.py:_rand_F (3D)."""
    rng = np.random.default_rng(seed)
    return np.eye(3) + scale * rng.standard_normal((n, 3, 3)) * 0.5


def _hard_F():
    """Random F with reflections (inverted elements), rank-deficient, zero,
    tiny and near-identity cases, as tests/test_rotation.py builds them."""
    F = _rand_F(16, seed=3).copy()
    F[:8, :, 0] *= -1.0
    D = np.tile(np.eye(3), (5, 1, 1))
    D[1, 2, 2] = 0.0
    D[2] = 0.0
    D[3] *= 1e-8
    D[4] += 1e-9 * np.random.default_rng(4).standard_normal((3, 3))
    return np.concatenate([_rand_F(32, seed=2), F, D])


def test_sym_pack_unpack():
    rng = np.random.default_rng(0)
    S = rng.standard_normal((10, 3, 3))
    close(tsym.pack(t64(S)), jsym.pack(jnp.asarray(S)), rtol=0, atol=0)
    s = rng.standard_normal((10, 6))
    close(tsym.unpack(t64(s)), jsym.unpack(jnp.asarray(s)), rtol=0, atol=0)
    for fn in ("sym_weights", "syminv_weights", "ivec"):
        close(getattr(tsym, fn)(3), getattr(jsym, fn)(3), rtol=0, atol=0)


@pytest.mark.parametrize("n", [3, 6])
def test_jacobi_eigh(n):
    rng = np.random.default_rng(1)
    A = rng.standard_normal((32, n, n))
    A = A + np.swapaxes(A, -1, -2)
    w_j, V_j = _jacobi(jnp.asarray(A), sweeps=8)
    w_t, V_t = trot.jacobi_eigh(t64(A), sweeps=8)
    close(w_t, w_j, rtol=1e-10, atol=1e-12)
    close(V_t, V_j, rtol=1e-10, atol=1e-12)


def test_polar33_and_dsdF33():
    F = _hard_F()
    R_j, S_j = _polar33(jnp.asarray(F), sweeps=6)
    R_t, S_t = trot.polar33(t64(F), sweeps=6)
    close(R_t, R_j, rtol=1e-10, atol=1e-10)
    close(S_t, S_j, rtol=1e-10, atol=1e-10)
    # inversion is carried in the smallest singular value
    det = np.linalg.det(F)
    inv = det < -1e-6
    assert np.all(np.linalg.det(R_t.numpy()[inv]) > 0)
    assert np.all(np.linalg.eigvalsh(S_t.numpy()[inv]).min(-1) < 0)
    D_j = _dsdF33(R_j, S_j)
    D_t = trot.dsdF33(R_t, S_t)
    assert D_t.shape == (F.shape[0], 6, 3, 3)
    scale = float(jnp.max(jnp.abs(D_j)))
    close(D_t, D_j, rtol=1e-9, atol=1e-12 * scale)


def test_sym_inv3_guard():
    rng = np.random.default_rng(5)
    A = rng.standard_normal((8, 3, 3))
    G = A + np.swapaxes(A, -1, -2)
    G[0] = np.diag([1.0, 1.0, 0.0])          # singular: the eps guard acts
    G[1] = -np.diag([1.0, 1.0, 1e-14])       # near-singular, negative det
    for eps in (1e-10, 1e-6):
        close(
            trot._sym_inv3(t64(G), eps),
            jrot._sym_inv3(jnp.asarray(G), eps),
            rtol=1e-10, atol=1e-12,
        )


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_psd_fix_sqrt(dtype):
    rng = np.random.default_rng(9)
    H = rng.standard_normal((24, 6, 6))
    H = H + np.swapaxes(H, -1, -2)          # indefinite
    H[:8] = np.einsum("bij,bkj->bik", H[:8], H[:8])  # PSD
    jd, td = jnp.dtype(dtype), getattr(torch, dtype)
    out_j = _psd_sqrt(jnp.asarray(H, jd), tol=1e-8)
    out_t = tpsd.psd_fix_sqrt(torch.tensor(H, dtype=td), tol=1e-8)
    # f32: the sweep count drops to 5 on both sides; agreement is then to
    # f32 rounding of the same sweeps
    rtol, atol = (1e-10, 1e-11) if dtype == "float64" else (2e-4, 2e-4)
    for a, b in zip(out_t, out_j):
        assert a.dtype == td
        close(a, b, rtol=rtol, atol=atol * max(1.0, float(jnp.max(jnp.abs(b)))))


def _stretches(n=40, seed=11):
    """Sym-vec stretches near rest, some compressed towards det <= 0."""
    rng = np.random.default_rng(seed)
    s = np.tile([1.0, 1.0, 1.0, 0.0, 0.0, 0.0], (n, 1))
    s = s + 0.2 * rng.standard_normal((n, 6))
    s[-4:, :3] *= np.array([[0.3], [0.1], [-0.2], [0.05]])
    return s


@pytest.mark.parametrize("name", tmat.MATERIAL_NAMES)
def test_material_s_space(name):
    assert tmat.MATERIAL_NAMES == jmat.MATERIAL_NAMES
    s = _stretches()
    n = len(s)
    mu = np.full(n, 3.4e5)
    lam = np.full(n, 3.1e6)
    mid = np.zeros(n, np.int32)
    models = (name,)
    ja = (jnp.asarray(s), jnp.asarray(mu), jnp.asarray(lam), jnp.asarray(mid))
    ta = (t64(s), t64(mu), t64(lam), torch.tensor(mid))
    for fn in ("psi_s_all", "grad_s_all", "hess_s_all"):
        ref = getattr(jmat, fn)(*ja, models)
        got = getattr(tmat, fn)(*ta, models)
        scale = float(jnp.max(jnp.abs(ref)))
        close(got, ref, rtol=1e-10, atol=1e-12 * scale)
    # the JAX row body's hand copy of the densities, which the port's
    # lattice merit stands in for: relative on the regular rows, and the
    # absolute floor above on the 4 degenerate rows (det near or below 0)
    got = tmat.psi_s_all(*ta, models)
    ref = jrows.psi_rows(tuple(ja[0].T), ja[1], ja[2], ja[3], models)
    close(got[:-4], ref[:-4], rtol=1e-10)
    close(got, ref, rtol=1e-10, atol=1e-12 * float(jnp.max(jnp.abs(ref))))


def test_material_mixed_models():
    """Two models in one mesh: per-element dispatch by model_id."""
    s = _stretches(n=12)
    mu, lam = np.full(12, 1e5), np.full(12, 5e5)
    mid = np.arange(12, dtype=np.int32) % 2
    models = ("Stable-Neohookean", "ARAP")
    ja = (jnp.asarray(s), jnp.asarray(mu), jnp.asarray(lam), jnp.asarray(mid))
    ta = (t64(s), t64(mu), t64(lam), torch.tensor(mid))
    for fn in ("psi_s_all", "grad_s_all", "hess_s_all"):
        ref = getattr(jmat, fn)(*ja, models)
        close(getattr(tmat, fn)(*ta, models), ref, rtol=1e-10,
              atol=1e-12 * float(jnp.max(jnp.abs(ref))))
