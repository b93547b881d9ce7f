"""Parity of the port's "subspace-amgcl" path (solvers/amg.py and the
'amgcl' branch of optimizer/newton_direct.py) with the JAX package's, in
float64 on the CPU: the assembled dual Schur matrix to 1e-12, the
smoothed-aggregation hierarchy (levels, prolongators, hence aggregates,
and coarsest matrix), the AMG-preconditioned dual solve to 1e-10, the
path's refusals, and a 3-step trajectory of a 360-tet Fung beam.

The inputs are solver_parity.kkt_inputs' Fung beam: Stable-Neo-Hookean's
stretch Hessians need the PSD clamp at 1e-8, and on such a system the
dual solve's iterates part at the inputs' rounding (a 1e-15 change of
(vol H)^{-1} moves ds by half its size after one CG iteration)."""

import jax.numpy as jnp
import numpy as np
import pytest

from mixedfem_tpu.config import SimConfig as JConfig
from mixedfem_tpu.mesh import mesh as jmesh
from mixedfem_tpu.optimizer import newton as jnewton
from mixedfem_tpu.optimizer import newton_direct as jnd
from mixedfem_tpu.solvers import amg as jamg
from mixedfem_tpu_torch.config import SimConfig as TConfig
from mixedfem_tpu_torch.optimizer import newton_direct as tnd
from mixedfem_tpu_torch.solvers import amg as tamg

from host_parity import compare_host_steps, host_steps
from solver_parity import kkt_inputs, swing
from torch_parity import (  # noqa: F401 (one_torch_thread is a fixture)
    beam_arrays, one_torch_thread, port,
)


@pytest.fixture(scope="module", autouse=True)
def _one_thread(one_torch_thread):
    """Every test of this module runs on one torch intra-op thread."""


@pytest.fixture(scope="module")
def kkt():
    return kkt_inputs()


@pytest.fixture(scope="module")
def dual(kkt):
    return (jamg.assemble_dual(kkt["jm"], kkt["jc"]),
            tamg.assemble_dual(kkt["tm"], kkt["tc"]))


def test_assemble_dual(dual):
    (Sj, Cj, mj, bj), (St, Ct, mt, bt) = dual
    for a, b in ((St, Sj), (Ct, Cj)):
        a, b = a.tocsr(), b.tocsr()
        a.sort_indices()
        b.sort_indices()
        np.testing.assert_array_equal(a.indptr, b.indptr)
        np.testing.assert_array_equal(a.indices, b.indices)
        np.testing.assert_allclose(a.data, b.data, rtol=1e-12,
                                   atol=1e-12 * np.abs(b.data).max())
    np.testing.assert_allclose(mt, mj, rtol=1e-12)
    np.testing.assert_allclose(bt, bj, rtol=1e-12, atol=1e-12 * np.abs(bj).max())


def test_saamg_hierarchy(dual):
    """Same number of levels, the same prolongator at each level (equal
    prolongators P = (I - omega D^-1 A) P_tent mean equal tentative ones,
    so the same aggregates in the same order), the same smoothers and the
    same coarsest matrix."""
    Sj, St = dual[0][0], dual[1][0]
    aj, at = jamg.SAAMG(Sj, 6), tamg.SAAMG(St, 6)
    assert len(at.levels) == len(aj.levels) >= 1
    for (Aj, Pj, sj), (At, Pt, st) in zip(aj.levels, at.levels):
        assert Pt.shape == Pj.shape and Pt.shape[1] < Pt.shape[0]
        Pj, Pt = Pj.tocsr(), Pt.tocsr()
        Pj.sort_indices()
        Pt.sort_indices()
        np.testing.assert_array_equal(Pt.indptr, Pj.indptr)
        np.testing.assert_array_equal(Pt.indices, Pj.indices)
        np.testing.assert_allclose(Pt.data, Pj.data, rtol=1e-12, atol=1e-14)
        np.testing.assert_allclose(st, sj, rtol=1e-12)
    np.testing.assert_allclose(at.A_coarse, aj.A_coarse, rtol=1e-12,
                               atol=1e-12 * np.abs(aj.A_coarse).max())


@pytest.mark.parametrize("tol,maxiter", [(1e-8, 500), (1e-3, 500),
                                         (1e-12, 6)])
def test_solve_dual_amg(kkt, tol, maxiter):
    want = jamg.solve_dual_amg(kkt["jm"], kkt["jc"], kkt["jr"][:3], tol,
                               maxiter)
    got = tamg.solve_dual_amg(kkt["tm"], kkt["tc"], kkt["tr"][:3], tol,
                              maxiter)
    assert got[3] == want[3]
    for a, b in zip(got[:3], want[:3]):
        np.testing.assert_allclose(a, np.asarray(b), rtol=0,
                                   atol=1e-10 * np.abs(np.asarray(b)).max())


def _beam(models=("Fung",), **cfg):
    V, T, kw, _ = beam_arrays()
    jm = jmesh.build_mesh_data(V, T, dtype=jnp.float64,
                               **dict(kw, models=models))
    step = dict(dict(h=0.02, outer_steps=3, newton_tol=0.0, itr_tol=1e-4,
                     mixed_variables=("mixed-stretch",), solver="amgcl"),
                **cfg)
    jcfg, tcfg = JConfig(**step), TConfig(**step)
    st = jnewton.init_state(jm, jcfg, (), jnp.asarray(V), jnp.asarray(swing(V)))
    tm, ts, _ = port(mesh=jm, state=st)
    return jm, jcfg, st, tm, tcfg, ts


def test_amgcl_trajectory():
    jm, jcfg, js, tm, tcfg, ts = _beam()
    out = host_steps(lambda s: jnd.newton_step_direct(jm, jcfg, (), s),
                     lambda s: tnd.newton_step_direct(tm, tcfg, (), s),
                     js, ts)
    compare_host_steps(out, "amgcl")
    assert out[-1][1].stats.solver_iters.min() > 1
    assert tnd.LAST_SYSTEM["levels"] >= 2


@pytest.mark.parametrize("cfg", [dict(variables=("stretch",)),
                                 dict(mixed_variables=("mixed-collision",))])
def test_amgcl_refusals(cfg):
    """subspace-amgcl solves the mixed-stretch dual system only: the
    vanilla stretch, and no mixed stretch, are refused as in JAX."""
    jm, jcfg, js, tm, tcfg, ts = _beam(**cfg)
    with pytest.raises(NotImplementedError):
        jnd.newton_step_direct(jm, jcfg, (), js)
    with pytest.raises(NotImplementedError):
        tnd.newton_step_direct(tm, tcfg, (), ts)
