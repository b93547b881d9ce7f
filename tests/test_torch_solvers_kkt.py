"""Parity of mixedfem_tpu_torch's full indefinite KKT system, MINRES and
the dual Schur CG (solvers/minres.py, dual.py, variables' gradient and
gradient_x) with mixedfem_tpu's, in float64 on the CPU; the MINRES paths'
trajectories are in test_torch_solvers_minres.py.

The functions get the JAX functions' inputs on the 360-tet beam (Fung,
the JAX coefficients of one ms.update carried across; solver_parity.
kkt_inputs says why Fung) and are held to their outputs to 1e-10 relative
(with an absolute floor of 1e-10 of the largest value); MINRES runs a
fixed count of 60 iterations, the dual CG 20. The dual-cg path's
trajectory is held as solver_parity.compare_steps holds the CG paths."""

import jax
import jax.numpy as jnp
import pytest
import torch

from mixedfem_tpu.solvers import dual as jdual
from mixedfem_tpu.solvers import minres as jmr
from mixedfem_tpu.variables import displacement as jdisp
from mixedfem_tpu.variables import mixed_stretch as jms
from mixedfem_tpu_torch.solvers import dual as tdual
from mixedfem_tpu_torch.solvers import minres as tmr
from mixedfem_tpu_torch.variables import displacement as tdisp
from mixedfem_tpu_torch.variables import mixed_stretch as tms

import solver_parity as sp
from torch_parity import one_torch_thread, t64  # noqa: F401 (a fixture)


@pytest.fixture(scope="module", autouse=True)
def _one_thread(one_torch_thread):
    """Every test of this module runs on one torch intra-op thread."""


@pytest.fixture(scope="module")
def kkt():
    return sp.kkt_inputs()


def _shapes(kkt):
    return (kkt["V"].shape, kkt["s"].shape, kkt["s"].shape)


def test_gradients(kkt):
    """disp.gradient and ms.gradient_x, the KKT rhs's vertex sums."""
    sp.near(tdisp.gradient(kkt["tm"], kkt["tb"], t64(kkt["x"]), 0.5),
            jdisp.gradient(kkt["jm"], kkt["jb"], jnp.asarray(kkt["x"]), 0.5))
    sp.near(tms.gradient_x(kkt["tm"], kkt["tc"], t64(kkt["la"])),
            jms.gradient_x(kkt["jm"], kkt["jc"], jnp.asarray(kkt["la"])))


def test_kkt_rhs(kkt):
    sp.near_tuple(kkt["tr"], kkt["jr"])


def test_kkt_operator_and_preconditioner(kkt):
    _, ju, tu = sp.random_tuple(_shapes(kkt), 2)
    sp.near_tuple(tmr.kkt_operator(kkt["tm"], kkt["tc"])(tu),
                  jmr.kkt_operator(kkt["jm"], kkt["jc"])(ju))
    sp.near_tuple(
        tmr.kkt_block_diag_preconditioner(kkt["tm"], kkt["tc"])(tu),
        jmr.kkt_block_diag_preconditioner(kkt["jm"], kkt["jc"])(ju))


def test_minres_fixed_count(kkt):
    """60 preconditioned MINRES iterations (a zero tolerance) from zero."""
    jA = jmr.kkt_operator(kkt["jm"], kkt["jc"])
    jM = jmr.kkt_block_diag_preconditioner(kkt["jm"], kkt["jc"])
    jx, jit_, jrel = jax.jit(lambda b: jmr.minres(
        jA, b, tuple(jnp.zeros_like(a) for a in b), 60, 0.0, jM))(kkt["jr"])
    tr = kkt["tr"]
    tx, tit, trel = tmr.minres(
        tmr.kkt_operator(kkt["tm"], kkt["tc"]), tr,
        tuple(torch.zeros_like(a) for a in tr), 60, 0.0,
        tmr.kkt_block_diag_preconditioner(kkt["tm"], kkt["tc"]))
    assert tit == int(jit_) == 60
    sp.near_tuple(tx, jx)
    sp.near(trel, jrel)


def test_solve_dual(kkt):
    """The dual Schur CG for 20 iterations, and the recovered (dx, ds)
    (dx is a difference of terms of the rhs's size, so the packages' dx
    part faster than their dl: 5e-9 of its scale at 40 iterations)."""
    j = jax.jit(lambda r: jdual.solve_dual(kkt["jm"], kkt["jc"], r,
                                           max_iters=20, tol=0.0))(kkt["jr"])
    t = tdual.solve_dual(kkt["tm"], kkt["tc"], kkt["tr"], max_iters=20,
                         tol=0.0)
    assert t[3] == int(j[3]) == 20
    sp.near_tuple(t[:3], j[:3])
    sp.near(t[4], j[4])


def test_dual_cg_trajectory():
    """The dual-cg path steps the swinging 360-tet beam 3 times with 3
    Newton iterations: positions to 1e-8, equal Newton and CG counts and
    alphas."""
    recs = sp.recorders("dual-cg")
    out, _, _ = sp.beam_trajectory("dual-cg", 6, 4, 3, recs)
    sp.compare_steps(out, recs, "dual-cg")
