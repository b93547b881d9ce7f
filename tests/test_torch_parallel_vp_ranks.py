"""mixedfem_tpu_torch/parallel/vp_step.py on 3 gloo ranks on the CPU
(uneven element counts, padded elements) against the port's own
single-device newton_step (held to the JAX step elsewhere), float64, at
the tolerances of tests/test_sharding.py's vertex-partitioned tests:
block-Jacobi and BDF2, 2 steps of small_beam(32, 2, 2) each. Positions to
1e-8 of scale after one step and 1e-7 after two, Newton counts equal."""

import numpy as np
import pytest

from mixedfem_tpu_torch.config import SimConfig
from mixedfem_tpu_torch.parallel import launch, ranks, vp_step as vp

from parallel_parity import (VP_CFG, check_ranks, port_small_beam,
                             single_device, vp_call)
from torch_parity import one_torch_thread  # noqa: F401 (a fixture)


@pytest.fixture(scope="module", autouse=True)
def _one_thread(one_torch_thread):
    """Every test of this module runs on one torch intra-op thread."""


def test_vp_three_ranks_match_the_single_device_step():
    mesh, V = port_small_beam()
    cfg = SimConfig(**VP_CFG)
    cfg2 = SimConfig(**dict(VP_CFG, integrator="BDF2"))
    plan = vp.build_vp_plan(mesh, 3)
    assert (plan.emask == 0).any()
    v0 = np.zeros_like(V)
    calls = [vp_call(plan, cfg, V, v0),
             vp_call(plan, cfg2, V, v0, bdf_name="BDF2")]
    out = launch.run_ranks(ranks.sequence, 3, args=(calls,))
    check_ranks([o[0] for o in out], single_device(mesh, cfg, V), mesh.nv)
    check_ranks([o[1] for o in out], single_device(mesh, cfg2, V), mesh.nv)
