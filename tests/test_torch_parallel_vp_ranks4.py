"""mixedfem_tpu_torch/parallel/vp_step.py with the two-level coarse space
on 4 gloo ranks on the CPU (padded vertex rows) against the port's own
single-device newton_step, float64: 2 steps of small_beam(32, 2, 2) with
its geometric coarse space (target 24). Positions to 1e-8 of scale after
one step and 1e-7 after two, Newton counts equal."""

import numpy as np
import pytest
import torch

from mixedfem_tpu_torch.config import SimConfig
from mixedfem_tpu_torch.parallel import launch, ranks, vp_step as vp
from mixedfem_tpu_torch.solvers.coarse import build_coarse_space

from parallel_parity import (VP_CFG, check_ranks, port_small_beam,
                             single_device, vp_call)
from torch_parity import one_torch_thread  # noqa: F401 (a fixture)


@pytest.fixture(scope="module", autouse=True)
def _one_thread(one_torch_thread):
    """Every test of this module runs on one torch intra-op thread."""


def test_vp_four_ranks_two_level_match_the_single_device_step():
    mesh, V = port_small_beam()
    cs = build_coarse_space(V, mesh.T.numpy(), ~mesh.free_mask.numpy().astype(
        bool), target_size=24, dtype=torch.float64, device="cpu")
    cfg = SimConfig(**VP_CFG)
    plan = vp.build_vp_plan(mesh, 4, coarse=cs)
    assert plan.nv_pad > mesh.nv
    out = launch.run_ranks(ranks.sequence, 4, args=(
        [vp_call(plan, cfg, V, np.zeros_like(V))],))
    check_ranks([o[0] for o in out], single_device(mesh, cfg, V), mesh.nv)
