"""3-step trajectories of the port's host Newton step
(optimizer/newton_direct.py) against the JAX package's, in float64 on the
CPU: the exact solve ('direct', the reference's eigen-llt) and IC-PCG
('pcg-ic', eigen-pcg-IC) on the 360-tet beam, the exact solve of the
vanilla stretch alone (the reference's non-mixed baseline) and with
mixed-stretch, and on the 200-triangle cantilever. Positions to 1e-8,
Newton counts, alphas and IC-PCG counts equal.

The trajectories start at rest with a swing, IC-PCG's from seeded
positions off the rest shape: at F = I the coefficient blocks hold
entries that are zero or 1e-20 by rounding alone, scipy drops the exact
zeros from the sum's pattern (9,684 stored entries in the JAX package's
matrix, 8,960 in the port's on one input), and the IC(0) factor then
depends on which (one IC-PCG count of 17 came out 16 from rest). The
vanilla stretch's Hessian is not projected to PSD, so off the rest shape
its exact solve amplifies rounding (3e-8 apart after a step)."""

import jax.numpy as jnp
import numpy as np
import pytest

from mixedfem_tpu.config import SimConfig as JConfig
from mixedfem_tpu.mesh import mesh as jmesh
from mixedfem_tpu.optimizer import newton as jnewton
from mixedfem_tpu.optimizer import newton_direct as jnd
from mixedfem_tpu_torch.config import SimConfig as TConfig
from mixedfem_tpu_torch.optimizer import newton as tnewton
from mixedfem_tpu_torch.optimizer import newton_direct as tnd

from host_parity import compare_host_steps, host_steps
from solver_parity import swing
from torch_parity import (  # noqa: F401 (one_torch_thread is a fixture)
    beam_arrays, one_torch_thread, port, tri_arrays,
)


@pytest.fixture(scope="module", autouse=True)
def _one_thread(one_torch_thread):
    """Every test of this module runs on one torch intra-op thread."""


def trajectory(dim, solver, **cfg):
    seed = 0 if solver == "pcg-ic" else None
    V, T, kw, x = beam_arrays(seed=seed) if dim == 3 else tri_arrays(seed=seed)
    jm = jmesh.build_mesh_data(V, T, dtype=jnp.float64, **kw)
    step = dict(dict(h=0.02, outer_steps=3, newton_tol=0.0, itr_tol=1e-4,
                     mixed_variables=("mixed-stretch",), solver=solver),
                **cfg)
    jcfg, tcfg = JConfig(**step), TConfig(**step)
    st = jnewton.init_state(jm, jcfg, (), jnp.asarray(x), jnp.asarray(swing(V)))
    tm, ts, _ = port(mesh=jm, state=st)
    return host_steps(lambda s: jnd.newton_step_direct(jm, jcfg, (), s),
                      lambda s: tnd.newton_step_direct(tm, tcfg, (), s),
                      st, ts)


@pytest.mark.parametrize("dim,solver,cfg", [
    (3, "direct", {}),
    (3, "pcg-ic", {}),
    (3, "eigen-llt", dict(mixed_variables=(), variables=("stretch",))),
    (3, "cholmod", dict(variables=("stretch",))),
    (2, "direct", {}),
], ids=["direct", "pcg-ic", "vanilla-only", "mixed+vanilla", "direct-2d"])
def test_host_trajectory(dim, solver, cfg):
    out = trajectory(dim, solver, **cfg)
    compare_host_steps(out, f"{solver} {cfg}")
    ts = out[-1][1]
    if solver == "pcg-ic":
        assert ts.stats.solver_iters.min() > 1
        assert tnd.LAST_SYSTEM["shift"] is not None
    else:
        assert (ts.stats.solver_iters[:ts.stats.iterations] == 1).all()
    # E_prev is never updated in the JAX host loop: the residual stays inf
    assert np.isinf(ts.stats.energy_res[:ts.stats.iterations].numpy()).all()
    np.testing.assert_array_equal(ts.stats.energy_res.numpy(),
                                  out[-1][0]["stats"]["energy_res"])


def test_newton_step_refuses_host_paths():
    """newton_step refuses the host names with the JAX step's ValueError."""
    V, T, kw, x = beam_arrays()
    jm = jmesh.build_mesh_data(V, T, dtype=jnp.float64, **kw)
    for name in ("direct", "eigen-ldlt", "pcg-ic", "subspace-amgcl"):
        cfg = dict(h=0.02, outer_steps=1, solver=name)
        st = jnewton.init_state(jm, JConfig(**cfg), (), jnp.asarray(x),
                                jnp.zeros_like(jnp.asarray(x)))
        tm, ts, _ = port(mesh=jm, state=st)
        with pytest.raises(ValueError):
            jnewton.newton_step(jm, JConfig(**cfg), (), st)
        with pytest.raises(ValueError):
            tnewton.newton_step(tm, TConfig(**cfg), (), ts)
