"""The element-sharded step (mixedfem_tpu_torch/parallel/sharding.py and
newton_step with a comm) on 2 gloo ranks on the CPU against
mixedfem_tpu/parallel/sharding.py's shard_simulation + newton_step on 2
virtual CPU devices, float64: 2 steps of tests/test_sharding.py's beam,
positions to 1e-8 of scale, Newton counts equal, CG counts within 2%
(parallel_parity.check_steps says which)."""

import numpy as np
import pytest

from mixedfem_tpu.config import SimConfig as JConfig
from mixedfem_tpu.optimizer import newton as jnewton
from mixedfem_tpu.parallel import sharding as jsharding
from mixedfem_tpu_torch.config import SimConfig as TConfig
from mixedfem_tpu_torch.parallel import launch, ranks

from parallel_parity import alongside, check_steps
from test_newton import make_state, small_beam
from torch_parity import one_torch_thread, to_numpy  # noqa: F401

CFG = dict(h=0.01, outer_steps=4, itr_tol=1e-10, dtype="float64",
           mixed_variables=("mixed-stretch",))


@pytest.fixture(scope="module", autouse=True)
def _one_thread(one_torch_thread):
    """Every test of this module runs on one torch intra-op thread."""


def _jax_sharded_steps(mesh, config, state, n, steps):
    jmesh = jsharding.make_device_mesh(n)
    mesh_s, st = jsharding.shard_simulation(mesh, state, jmesh)
    out = []
    for _ in range(steps):
        st = jnewton.newton_step(mesh_s, config, (), st)
        it = int(st.stats.iterations)
        out.append((np.asarray(st.x), it,
                    np.asarray(st.stats.solver_iters)[:it]))
    return out


def test_element_sharded_step_matches_jax():
    mesh, V = small_beam(4, 2, 2)
    config = JConfig(**CFG)
    state = make_state(mesh, config)
    got, want = alongside(
        lambda: launch.run_ranks(ranks.element_sharded_steps, 2, args=(
            to_numpy(mesh), None, TConfig(**CFG), V, np.zeros_like(V), 2)),
        lambda: _jax_sharded_steps(mesh, config, state, 2, 2))
    check_steps(got, want, 1e-8, 0.02)


