"""Parity of mixedfem_tpu_torch's ADMM and the tuple and fixed-length CG
(solvers/admm.py, pcg.pcg_tree and pcg_fixed) with mixedfem_tpu's, in
float64 on the CPU.

The functions get the JAX functions' inputs on the 360-tet beam (Fung,
solver_parity.kkt_inputs) and are held to their outputs to 1e-10 relative
(with an absolute floor of 1e-10 of the largest value), each Krylov or
ADMM loop at a fixed count. The admm path steps the swinging 96-tet beam
3 times with 3 Newton iterations through newton_step: positions to 1e-8,
equal Newton and ADMM counts and alphas."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mixedfem_tpu.solvers import admm as jadmm
from mixedfem_tpu.solvers import pcg as jpcg
from mixedfem_tpu_torch.solvers import admm as tadmm
from mixedfem_tpu_torch.solvers import pcg as tpcg

import solver_parity as sp
from torch_parity import one_torch_thread, t64  # noqa: F401 (a fixture)


@pytest.fixture(scope="module", autouse=True)
def _one_thread(one_torch_thread):
    """Every test of this module runs on one torch intra-op thread."""


@pytest.fixture(scope="module")
def kkt():
    return sp.kkt_inputs()


def test_pcg_tree_and_fixed():
    """pcg_tree on a two-block SPD system, and pcg_fixed (ADMM's inner
    solve) against pcg with the same count: 15 iterations short of the
    tolerance, and 40 with the tolerance met inside them (pcg_fixed then
    leaves x as JAX's loop does)."""
    rng = np.random.default_rng(3)
    n1, n = 30, 50
    A = rng.standard_normal((n, n))
    A = A @ A.T + n * np.eye(n)
    d = np.diag(A).copy()
    b = rng.standard_normal(n)

    def split(y):
        return (y[:n1], y[n1:])

    jA = lambda u: split(jnp.asarray(A) @ jnp.concatenate(u))  # noqa: E731
    tA = lambda u: split(t64(A) @ torch.cat(u))  # noqa: E731
    jx, jit_, jrel = jax.jit(lambda bb: jpcg.pcg_tree(
        jA, bb, tuple(jnp.zeros_like(a) for a in bb),
        lambda r: (r[0] / d[:n1], r[1] / d[n1:]), 12, 1e-14))(split(jnp.asarray(b)))
    tb = split(t64(b))
    tx, tit, trel = tpcg.pcg_tree(
        tA, tb, tuple(torch.zeros_like(a) for a in tb),
        lambda r: (r[0] / t64(d[:n1]), r[1] / t64(d[n1:])), 12, 1e-14)
    assert tit == int(jit_) == 12
    sp.near_tuple(tx, jx)
    sp.near(trel, jrel)
    x0 = 0.1 * b
    for iters, tol in ((15, 1e-12), (40, 1e-6)):
        jx, jit_, _ = jpcg.pcg(lambda p: jnp.asarray(A) @ p, jnp.asarray(b),
                               jnp.asarray(x0), lambda r: r / d, iters, tol)
        tx = tpcg.pcg_fixed(lambda p: t64(A) @ p, t64(b), t64(x0),
                            lambda r: r / t64(d), iters, tol)
        assert (int(jit_) < iters) == (tol == 1e-6)
        sp.near(tx, jx)


def test_solve_admm(kkt):
    """20 ADMM sweeps (a zero tolerance) of 30 inner iterations."""
    ju, jit_, jerr = jax.jit(lambda r: jadmm.solve_admm(
        kkt["jm"], kkt["jc"], r, max_iters=20, tol=0.0))(kkt["jr"])
    tu, tit, terr = tadmm.solve_admm(kkt["tm"], kkt["tc"], kkt["tr"],
                                     max_iters=20, tol=0.0)
    assert tit == int(jit_) == 20
    sp.near_tuple(tu, ju)
    sp.near(terr, jerr)


def test_admm_preconditioner(kkt):
    _, ju, tu = sp.random_tuple((kkt["V"].shape, kkt["s"].shape,
                                 kkt["s"].shape), 4)
    jM = jadmm.admm_preconditioner(kkt["jm"], kkt["jc"], sweeps=2,
                                   inner_iters=10)
    tM = tadmm.admm_preconditioner(kkt["tm"], kkt["tc"], sweeps=2,
                                   inner_iters=10)
    sp.near_tuple(tM(tu), jax.jit(jM)(ju))


def test_trajectory():
    recs = sp.recorders("admm")
    out, _, _ = sp.beam_trajectory("admm", 4, 2, 2, recs)
    sp.compare_steps(out, recs, "admm")
