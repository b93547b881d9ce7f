"""mixedfem_tpu_torch/parallel/vp_step.py (the vertex-partitioned full step,
2 gloo ranks on the CPU) against mixedfem_tpu/parallel/vp_step.py on 2
virtual CPU devices, in float64 from the same plan (convert.py's hand-over
of the JAX VPPlan), with block-Jacobi: 2 steps of tests/test_sharding.py's
small_beam(32, 2, 2). Positions to 1e-8 of scale, Newton counts equal, CG
totals within 2% (Krylov counts are rounding's to decide)."""

import jax.numpy as jnp
import numpy as np
import pytest

from mixedfem_tpu.config import SimConfig as JConfig
from mixedfem_tpu.parallel import vp_step as jvp
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


def test_vp_block_jacobi_matches_jax():
    jm, V = small_beam(32, 2, 2)
    v0 = np.zeros_like(V)
    plan = jvp.build_vp_plan(jm, D)
    call = vp_call(convert.vp_plan_from_numpy(plan_fields(plan)),
                   TConfig(**VP_CFG), V, v0)
    got, want = alongside(
        lambda: launch.run_ranks(ranks.sequence, D, args=([call],)),
        lambda: jax_vp_steps(plan, JConfig(**VP_CFG), jnp.asarray(V),
                             jnp.asarray(v0), 2))
    check([g[0] for g in got], want, jm.nv)
