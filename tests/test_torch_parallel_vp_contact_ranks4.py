"""mixedfem_tpu_torch/parallel/vp_step.py with mixed IPC contact on 4 gloo
ranks on the CPU against the port's own single-device newton_step (held
to the JAX step elsewhere), float64: tests/test_vp_contact.py's drop
mesh, whose candidate frames join the beam's vertices and the box's and
so have corners on different ranks, candidates within dhat rebuilt from
the positions before each of 2 steps on both sides. Positions to 1e-8 of
scale after one step and 1e-7 after two (tests/test_sharding.py's vp
tolerances, inside tests/test_vp_contact.py's 1e-6), Newton counts
equal, some frames active."""

import pytest

from parallel_parity import vp_contact_vs_single
from torch_parity import one_torch_thread  # noqa: F401 (a fixture)


@pytest.fixture(scope="module", autouse=True)
def _one_thread(one_torch_thread):
    """Every test of this module runs on one torch intra-op thread."""


def test_vp_contact_four_ranks_match_the_single_device_step():
    vp_contact_vs_single(4)
