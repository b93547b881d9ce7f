"""The MINRES paths of mixedfem_tpu_torch against mixedfem_tpu, in
float64 on the CPU: the count of one Stable-Neo-Hookean KKT solve from the
same input in both packages (decided by rounding, solver_parity), and the
minres-kkt and minres-kkt-admm paths stepping a swinging 96-tet beam 3
times with 3 Newton iterations through newton_step: positions to 1e-8,
equal Newton counts and alphas, and MINRES counts held by
solver_parity.check_minres_counts (margins print under -s)."""

import jax.numpy as jnp
import pytest
import torch

from mixedfem_tpu.mesh import mesh as jmesh
from mixedfem_tpu_torch.solvers import minres as tmr

import solver_parity as sp
from torch_parity import (  # noqa: F401 (one_torch_thread is a fixture)
    beam_arrays, one_torch_thread, port, t64,
)


@pytest.fixture(scope="module", autouse=True)
def _one_thread(one_torch_thread):
    """Every test of this module runs on one torch intra-op thread."""


def _xla_vdot(a, b):
    return torch.tensor(float(jnp.vdot(jnp.asarray(a.numpy()),
                                       jnp.asarray(b.numpy()))),
                        dtype=torch.float64)


def test_minres_count_rounding():
    """The second Newton iteration's KKT system of a 360-tet
    Stable-Neo-Hookean beam step from rest, solved by both packages' MINRES
    from the same input: the counts differ by rounding alone, within
    MINRES_BAND. The port's count with jnp.vdot's rounding of its dot
    products, and nothing else changed, is printed beside them."""
    from mixedfem_tpu_torch.config import SimConfig as TConfig
    from mixedfem_tpu_torch.optimizer import newton as tnewton

    V, T, kw, _ = beam_arrays()
    jm = jmesh.build_mesh_data(V, T, dtype=jnp.float64, **kw)
    tm, _, _ = port(mesh=jm)
    cfg = TConfig(h=0.02, outer_steps=2, newton_tol=0.0, itr_tol=1e-4,
                  max_iterative_solver_iters=500, solver="minres-kkt",
                  mixed_variables=("mixed-stretch",))
    x0 = t64(V)
    st = tnewton.init_state(tm, cfg, (), x0, torch.zeros_like(x0))
    recs = sp.recorders("minres-kkt")
    for r in recs:
        r.__enter__()
    try:
        tnewton.newton_step(tm, cfg, (), st)
    finally:
        for r in recs:
            r.__exit__()
    call = recs[0].calls[1]
    n_jax = sp.jax_minres_count(jm, recs[1].calls[1], call, cfg)
    n_xla = recs[0].count_with(call, [(tmr, "tdot", lambda a, b: sum(
        _xla_vdot(u, v) for u, v in zip(a, b)))])
    print(f"MINRES iterations: JAX {n_jax}, port {call[2]}, port with XLA's "
          f"dot products {n_xla}")
    assert 100 < n_jax < 500
    assert abs(call[2] - n_jax) <= sp.rounding_band(n_jax, sp.MINRES_BAND)


@pytest.fixture(scope="module", params=["minres-kkt", "minres-kkt-admm"])
def trajectory(request):
    solver = request.param
    recs = sp.recorders(solver)
    out, jm, jcfg = sp.beam_trajectory(solver, 4, 2, 2, recs)
    return solver, out, recs, jm, jcfg


def test_trajectory(trajectory):
    solver, out, recs, jm, jcfg = trajectory
    sp.compare_steps(out, recs, solver, jm, jcfg)
