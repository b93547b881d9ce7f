"""The element-sharded step with f64 islands (rhs_precision='float64' on a
float32 state: the island update's f64 sums and the f64 merit summed over
the ranks in float64) on 2 gloo ranks against the JAX package's
shard_simulation + Simulation.step on 2 virtual CPU devices: 2 steps of
the swinging 80-tet beam with pcg. A float32 state's positions part at
float32 rounding between any two summation orders, so they are held as
tests/test_torch_islands_beam.py holds the single-device islands: within
twice the JAX package's own distance between its sharded float32 island
run and the float64 run (the port's single-device float64 step, held to
the JAX step at 1e-8 by the other parity files, stands in for JAX's own
f64 run, whose compile would double this file's time; the margins print
under -s); Newton counts equal, CG counts within 2%."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from es_parity import run_both, single_device
from mixedfem_tpu.mesh import mesh as jmesh
from parallel_parity import check_steps
from solver_parity import swing
from torch_parity import beam_arrays, one_torch_thread  # noqa: F401

CFG = dict(h=0.02, outer_steps=3, newton_tol=0.0, itr_tol=1e-6,
           max_iterative_solver_iters=500, mixed_variables=("mixed-stretch",),
           solver="pcg")


@pytest.fixture(scope="module", autouse=True)
def _one_thread(one_torch_thread):
    """Every test of this module runs on one torch intra-op thread."""


def test_f32_islands_match_jax():
    V, T, kw, _ = beam_arrays(4, 2, 2)
    mesh = jmesh.build_mesh_data(V, T, dtype=jnp.float64, **kw)
    mesh32 = jax.tree.map(lambda a: a.astype(jnp.float32)
                          if hasattr(a, "dtype") and a.dtype == jnp.float64
                          else a, mesh)
    V32, v32 = V.astype(np.float32), swing(V).astype(np.float32)
    cfg32 = dict(CFG, dtype="float32", rhs_precision="float64")
    (got, x64), want = run_both(mesh32, cfg32, V32, v32, 2,
                                also=lambda: single_device(
                                    mesh, dict(CFG, dtype="float64"), V,
                                    swing(V)))
    for k in range(2):
        own = np.abs(want[k]["x"].astype(np.float64) - x64[k]["x"]).max()
        for rank_runs in got:
            dist = np.abs(rank_runs[k]["x"].astype(np.float64)
                          - want[k]["x"]).max()
            print(f"step {k}: |x_port - x_jax| {dist:.3e}; JAX's own "
                  f"f32-island to f64 distance {own:.3e}")
            assert dist <= 2 * own, (k, dist, own)
    check_steps(got, [(w["x"], w["iterations"], w["solver_iters"])
                      for w in want], 1.0, 0.02)
