"""Parity of mixedfem_tpu_torch's Laplacian preconditioner
(solvers/laplacian.py) and of the condensed paths pcg-laplacian and
pcg-dualascent with mixedfem_tpu's, in float64 on the CPU (pcg-diag,
Gauss-Seidel and the solver names are in test_torch_solvers_gs.py).

The functions get the JAX functions' inputs on the 360-tet beam (the JAX
coefficients of one ms.update carried across; the power iteration's start
vector is JAX's, drawn from its PRNGKey(0), carried across) and are held
to their outputs to 1e-10 relative (an absolute floor of 1e-10 of the
largest value). Both paths step a swinging 96-tet beam 3 times with 3
Newton iterations through newton_step: positions to 1e-8, equal Newton
and CG counts and alphas (on a beam without frames pcg-dualascent runs
the Laplacian apply alone, as in JAX)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mixedfem_tpu.mesh import mesh as jmesh
from mixedfem_tpu.solvers import laplacian as jlap
from mixedfem_tpu.variables import mixed_stretch as jms
from mixedfem_tpu_torch import convert
from mixedfem_tpu_torch.solvers import laplacian as tlap
from mixedfem_tpu_torch.variables import mixed_stretch as tms

import solver_parity as sp
from torch_parity import (  # noqa: F401 (one_torch_thread is a fixture)
    CPU, beam_arrays, one_torch_thread, port, t64, to_numpy,
)


@pytest.fixture(scope="module", autouse=True)
def _one_thread(one_torch_thread):
    """Every test of this module runs on one torch intra-op thread."""


@pytest.fixture(scope="module")
def beam():
    V, T, kw, x = beam_arrays(seed=0)
    jm = jmesh.build_mesh_data(V, T, dtype=jnp.float64, **kw)
    tm, _, _ = port(mesh=jm)
    s = tms.reset(tm, t64(x))[0].numpy()
    jc = jms.update(jm, jnp.asarray(x), jnp.asarray(s), 0.02)
    tc = tms.StretchCoeffs(**{k: t64(v) for k, v in to_numpy(jc).items()})
    v0 = np.asarray(jax.random.normal(jax.random.PRNGKey(0), V.shape,
                                      jnp.float64))
    return dict(V=V, T=T, x=x, jm=jm, tm=tm, jc=jc, tc=tc, v0=v0,
                GwL_j=jlap.laplacian_rows(jm), GwL_t=tlap.laplacian_rows(tm),
                k=float(jnp.max(jc.max_evals)))


def test_laplacian_rows_and_ml_matvec(beam):
    sp.near(beam["GwL_t"], beam["GwL_j"])
    p = np.random.default_rng(2).standard_normal(beam["V"].shape)
    for k, ms_ in ((beam["k"], 1.0), (0.0, 1.0), (1.0, 0.0)):
        sp.near(tlap.ml_matvec(beam["tm"], beam["GwL_t"], k, t64(p), ms_),
                jlap.ml_matvec(beam["jm"], beam["GwL_j"], k, jnp.asarray(p),
                               ms_))


@pytest.fixture(scope="module")
def lmax(beam):
    """Both packages' power-iteration estimates of lmax(M) and lmax(L)."""
    jm, tm, GwL_j, GwL_t = beam["jm"], beam["tm"], beam["GwL_j"], beam["GwL_t"]
    v0 = convert.power_start_from_numpy(beam["v0"], torch.float64, CPU)
    j = jax.jit(lambda: (
        jlap.power_lmax(lambda p: jlap.ml_matvec(jm, GwL_j, 0.0, p),
                        beam["V"].shape, jnp.float64),
        jlap.power_lmax(lambda p: jlap.ml_matvec(jm, GwL_j, 1.0, p, 0.0),
                        beam["V"].shape, jnp.float64)))()
    t = (tlap.power_lmax(tlap.ml_operator(tm, GwL_t, 0.0), v0),
         tlap.power_lmax(tlap.ml_operator(tm, GwL_t, 1.0, 0.0), v0))
    return j, t


def test_power_lmax(lmax):
    for t, j in zip(*reversed(lmax)):
        sp.near(t, j)


def test_chebyshev_and_ml_preconditioner(beam, lmax):
    (jm_, jl_), (tm_, tl_) = lmax
    r = np.random.default_rng(3).standard_normal(beam["V"].shape)
    j = jlap.build_ml_preconditioner(beam["jm"], beam["GwL_j"], beam["k"],
                                     jm_, jl_, degree=16)
    t = tlap.build_ml_preconditioner(beam["tm"], beam["GwL_t"], beam["k"],
                                     tm_, tl_, degree=16)
    sp.near(t(t64(r)), jax.jit(j)(jnp.asarray(r)))
    # the bare Chebyshev apply on a given interval that holds the spectrum
    # of M + 2L (lmax(M) + 2 lmax(L) is about 75 here)
    jmv = jax.jit(lambda p: jlap.ml_matvec(beam["jm"], beam["GwL_j"], 2.0, p))
    tmv = tlap.ml_operator(beam["tm"], beam["GwL_t"], 2.0)
    sp.near(tlap.chebyshev_apply(tmv, 1e-2, 100.0, 8)(t64(r)),
            jlap.chebyshev_apply(jmv, 1e-2, 100.0, 8)(jnp.asarray(r)))


@pytest.mark.parametrize("solver", ["pcg-laplacian", "pcg-dualascent"])
def test_trajectory(solver):
    recs = sp.recorders(solver)
    out, _, _ = sp.beam_trajectory(solver, 4, 2, 2, recs)
    sp.compare_steps(out, recs, solver)


