"""The element-sharded step over an element count that does not divide by
the ranks, with an element-space solver: dual-cg on 3 gloo ranks over the
swinging 80-tet Fung beam (one zero-volume padded element on the last
rank), float64, 2 steps.

The JAX package's own padded run does not solve: its dual Schur
complement divides the padded element's zero rows by its zero volume
(0/0), the NaN reaches every dot product, and its CG stops at once (0
iterations), so its positions are those of a step without a solve. The
test shows that on 1 step of JAX's 3-device run, and holds the port's
3 padded ranks (whose divisions by a volume read 1 on padded elements,
mesh.safe_vols) to the JAX package's unpadded sharded run on 2 virtual
CPU devices: positions and stretch to 1e-8 of scale, Newton counts equal,
CG counts within 2%."""

import jax.numpy as jnp
import numpy as np
import pytest

from es_parity import check, jax_sim_steps, port_ranks
from mixedfem_tpu.config import SimConfig as JConfig
from mixedfem_tpu.mesh import mesh as jmesh
from parallel_parity import alongside
from solver_parity import swing
from torch_parity import beam_arrays, one_torch_thread  # noqa: F401

CFG = dict(h=0.02, outer_steps=3, newton_tol=0.0, itr_tol=1e-6,
           max_iterative_solver_iters=500, dtype="float64",
           mixed_variables=("mixed-stretch",), solver="dual-cg")


@pytest.fixture(scope="module", autouse=True)
def _one_thread(one_torch_thread):
    """Every test of this module runs on one torch intra-op thread."""


def test_padded_dual_cg_on_3_ranks():
    V, T, kw, _ = beam_arrays(4, 2, 2)
    kw = dict(kw, models=("Fung",))
    mesh = jmesh.build_mesh_data(V, T, dtype=jnp.float64, **kw)
    assert len(T) % 3
    v0 = swing(V)
    jcfg = JConfig(**CFG)

    def jax_runs():
        return (jax_sim_steps(mesh, jcfg, V, v0, 2, 2),
                jax_sim_steps(mesh, jcfg, V, v0, 3, 1))

    got, (want, padded) = alongside(
        lambda: port_ranks(mesh, CFG, V, v0, 3, 2), jax_runs)
    assert padded[0]["solver_iters"].max() == 0
    assert np.abs(padded[0]["x"] - want[0]["x"]).max() > 1e-6
    check(got, want, 1e-8, 0.02)
