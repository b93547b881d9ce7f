"""The element-sharded step (mixedfem_tpu_torch/parallel/sharding.py and
newton_step with a comm) on gloo ranks on the CPU against the port's own
single-device step (held to the JAX step elsewhere), float64: 4 ranks over
small_beam(3, 1, 1)'s 15 tets, and 3 ranks over small_beam(4, 2, 2)'s 80
with the geometric coarse space (a padded element each); 2 steps, 1e-9 of
scale, equal Newton counts, CG counts within 2 (parallel_parity.check_steps
says which)."""

import numpy as np
import pytest
import torch

from mixedfem_tpu_torch import convert
from mixedfem_tpu_torch.config import SimConfig as TConfig
from mixedfem_tpu_torch.optimizer import newton as tnewton
from mixedfem_tpu_torch.parallel import launch, ranks
from mixedfem_tpu_torch.solvers.coarse import build_coarse_space

from parallel_parity import check_steps
from test_newton import small_beam
from torch_parity import one_torch_thread, port, to_numpy  # noqa: F401

CFG = dict(h=0.01, outer_steps=4, itr_tol=1e-10, dtype="float64",
           mixed_variables=("mixed-stretch",))


@pytest.fixture(scope="module", autouse=True)
def _one_thread(one_torch_thread):
    """Every test of this module runs on one torch intra-op thread."""


def _single(mesh, coarse, config, V, steps=2):
    st = tnewton.init_state(mesh, config, (), torch.tensor(V),
                            torch.zeros(V.shape, dtype=torch.float64))
    out = []
    for _ in range(steps):
        st = tnewton.newton_step(mesh, config, (), st, coarse)
        it = st.stats.iterations
        out.append((st.x.numpy(), it, st.stats.solver_iters[:it].numpy()))
    return out


def test_element_sharded_ranks_match_the_single_device_step():
    """4 ranks over small_beam(3, 1, 1)'s 15 tets and 3 ranks over
    small_beam(4, 2, 2)'s 80 with the geometric coarse space (a padded
    element each), against the port's single-device step."""
    cfg = TConfig(**CFG)
    m15, V15 = small_beam(3, 1, 1)
    tm15, _, _ = port(mesh=m15)
    want15 = _single(tm15, None, cfg, V15)
    got15 = launch.run_ranks(ranks.element_sharded_steps, 4, args=(
        to_numpy(m15), None, cfg, V15, np.zeros_like(V15), 2))
    check_steps(got15, want15, 1e-9, 2)
    m80, V80 = small_beam(4, 2, 2)
    tm80, _, _ = port(mesh=m80)
    cs = build_coarse_space(V80, tm80.T.numpy(), ~tm80.free_mask.numpy().astype(
        bool), target_size=8, dtype=torch.float64, device="cpu")
    want80 = _single(tm80, cs, cfg, V80)
    got80 = launch.run_ranks(ranks.element_sharded_steps, 3, args=(
        to_numpy(m80), convert.coarse_to_numpy(cs), cfg, V80,
        np.zeros_like(V80), 2))
    check_steps(got80, want80, 1e-9, 2)
