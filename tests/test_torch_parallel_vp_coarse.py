"""mixedfem_tpu_torch/parallel/vp_step.py with the two-level coarse space
inside the sharded CG (2 gloo ranks on the CPU) against
mixedfem_tpu/parallel/vp_step.py on 2 virtual CPU devices, float64, the
same plan: 2 steps of small_beam(32, 2, 2) with its geometric coarse space
(target 24). Positions to 1e-8 of scale, Newton counts equal, CG totals
within 2%."""

import jax.numpy as jnp
import numpy as np
import pytest

from mixedfem_tpu.config import SimConfig as JConfig
from mixedfem_tpu.parallel import vp_step as jvp
from mixedfem_tpu.solvers.coarse import build_coarse_space as jbuild_cs
from mixedfem_tpu_torch import convert
from mixedfem_tpu_torch.config import SimConfig as TConfig
from mixedfem_tpu_torch.parallel import launch, ranks

from parallel_parity import (VP_CFG, alongside, check, jax_vp_steps,
                             plan_fields, vp_call)
from test_newton import small_beam
from torch_parity import one_torch_thread  # noqa: F401 (a fixture)

D = 2


@pytest.fixture(scope="module", autouse=True)
def _one_thread(one_torch_thread):
    """Every test of this module runs on one torch intra-op thread."""


def test_vp_two_level_matches_jax():
    jm, V = small_beam(32, 2, 2)
    v0 = np.zeros_like(V)
    cs = jbuild_cs(np.asarray(jm.V0), np.asarray(jm.T),
                   ~np.asarray(jm.free_mask, bool), target_size=24,
                   dtype=jnp.float64)
    plan = jvp.build_vp_plan(jm, D, coarse=cs)
    call = vp_call(convert.vp_plan_from_numpy(plan_fields(plan)),
                   TConfig(**VP_CFG), V, v0)
    got, want = alongside(
        lambda: launch.run_ranks(ranks.sequence, D, args=([call],)),
        lambda: jax_vp_steps(plan, JConfig(**VP_CFG), jnp.asarray(V),
                             jnp.asarray(v0), 2))
    check([g[0] for g in got], want, jm.nv)
