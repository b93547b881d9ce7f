"""The element-sharded step of a shell on gloo ranks against the JAX
package's shard_simulation + Simulation.step, float64: 2 steps of
tests/test_shell.py's cloth(4, 4) (32 triangles, K1's and K7's k3d3
instances on each rank's 16) on 2 ranks against 2 virtual CPU devices,
positions and stretch to 1e-8 of scale, Newton and CG counts equal. Over
3 the triangles need a padded one, and the JAX package's sharded step
fails on the rest normals it does not pad; the port refuses that at shard
time with a ValueError that says so."""

import numpy as np
import pytest

from es_parity import check, jax_sim_steps, run_both
from mixedfem_tpu.config import SimConfig as JConfig
from mixedfem_tpu_torch.parallel import sharding
from test_shell import cloth
from torch_parity import one_torch_thread, port  # noqa: F401

CFG = dict(h=0.01, outer_steps=3, itr_tol=1e-8,
           mixed_variables=("mixed-stretch",), dtype="float64")


@pytest.fixture(scope="module", autouse=True)
def _one_thread(one_torch_thread):
    """Every test of this module runs on one torch intra-op thread."""


def test_cloth_matches_jax_on_2_ranks():
    mesh, V = cloth(4, 4)
    got, want = run_both(mesh, CFG, V, np.zeros_like(V), 2)
    check(got, want, 1e-8, 0)
    assert want[-1]["x"][:, 2].min() < 0


def test_padded_cloth_fails_in_jax_and_is_refused():
    """32 triangles over 3: JAX's sharded step raises on broadcasting the
    padded 33 against the unpadded rest normals; the port's shard_mesh_data
    raises ValueError naming the field and that fault."""
    mesh, V = cloth(4, 4)
    with pytest.raises(TypeError, match="incompatible shapes"):
        jax_sim_steps(mesh, JConfig(**CFG), V, np.zeros_like(V), 3, 1,
                      jit=False)
    tm, _, _ = port(mesh=mesh)
    with pytest.raises(ValueError, match="rest_normal.*incompatible shapes"):
        sharding.shard_mesh_data(tm, 0, 3)


def test_stencil_plan_with_a_comm_is_refused():
    """A StencilPlan with a comm raises NotImplementedError pointing at
    parallel/stencil_shard.py (the JAX package keeps the plan whole, so its
    sharded lattice body is the single-device step on every device)."""
    import torch

    from mixedfem_tpu_torch.config import SimConfig as TConfig
    from mixedfem_tpu_torch.ops import stencil as stmod
    from mixedfem_tpu_torch.optimizer import newton as tnewton
    from mixedfem_tpu_torch.parallel import comm as commmod

    from torch_parity import beam_arrays

    V, T, kw, _ = beam_arrays(2, 1, 1)
    from mixedfem_tpu_torch.mesh import mesh as tmesh

    tm = tmesh.build_mesh_data(V, T, dtype=torch.float64, device="cpu", **kw)
    cfg = TConfig(h=0.01, dtype="float64")
    st = tnewton.init_state(tm, cfg, (), tm.V0, torch.zeros_like(tm.V0))
    plan = object.__new__(stmod.StencilPlan)
    comm = object.__new__(commmod.Comm)
    with pytest.raises(NotImplementedError, match="stencil_shard.py"):
        tnewton.newton_step(tm, cfg, (), st, matvec_plan=plan, comm=comm)
