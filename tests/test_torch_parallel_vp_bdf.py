"""mixedfem_tpu_torch/parallel/vp_step.py with BDF2 over each rank's rows
(2 gloo ranks on the CPU) against mixedfem_tpu/parallel/vp_step.py on 2
virtual CPU devices, float64, the same plan: 2 steps of
small_beam(32, 2, 2): positions to 1e-8 of scale, velocities to 1e-6 (as
tests/test_sharding.py holds them against the replicated step), Newton
counts equal, CG totals within 2%."""

import jax.numpy as jnp
import numpy as np
import pytest

from mixedfem_tpu.config import SimConfig as JConfig
from mixedfem_tpu.parallel import vp_step as jvp
from mixedfem_tpu_torch import convert
from mixedfem_tpu_torch.config import SimConfig as TConfig
from mixedfem_tpu_torch.parallel import launch, ranks

from parallel_parity import (VP_CFG, alongside, assemble, check,
                             jax_vp_steps, plan_fields, vp_call)
from test_newton import small_beam
from torch_parity import one_torch_thread  # noqa: F401 (a fixture)

D = 2
CFG = dict(VP_CFG, integrator="BDF2")


@pytest.fixture(scope="module", autouse=True)
def _one_thread(one_torch_thread):
    """Every test of this module runs on one torch intra-op thread."""


def test_vp_bdf2_matches_jax():
    jm, V = small_beam(32, 2, 2)
    v0 = np.zeros_like(V)
    plan = jvp.build_vp_plan(jm, D)
    call = vp_call(convert.vp_plan_from_numpy(plan_fields(plan)),
                   TConfig(**CFG), V, v0, bdf_name="BDF2")
    got, want = alongside(
        lambda: launch.run_ranks(ranks.sequence, D, args=([call],)),
        lambda: jax_vp_steps(plan, JConfig(**CFG), jnp.asarray(V),
                             jnp.asarray(v0), 2, bdf="BDF2"))
    got = [g[0] for g in got]
    check(got, want, jm.nv)
    scale = np.abs(want[-1][0][:jm.nv]).max()
    for k, (_x, vj, _it, _cg) in enumerate(want):
        v = assemble(got, k, jm.nv, "v")
        assert np.abs(v - vj[:jm.nv]).max() < 1e-6 * scale, k
