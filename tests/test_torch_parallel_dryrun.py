"""mixedfem_tpu_torch/parallel/dryrun.py, the port of
__graft_entry__.py dryrun_multichip, on 2 gloo ranks on the CPU: one
float32 step each of the element-sharded, the vertex-partitioned (two-level
coarse space) and the sharded stencil paths on tiny shapes, finite and
moving, and the same displacement on every rank."""

import pytest

from mixedfem_tpu_torch.parallel import dryrun, launch

from torch_parity import one_torch_thread  # noqa: F401 (a fixture)


@pytest.fixture(scope="module", autouse=True)
def _one_thread(one_torch_thread):
    """Every test of this module runs on one torch intra-op thread."""


def test_dryrun_multichip_on_two_cpu_ranks():
    out = launch.run_ranks(dryrun.dryrun_rank, 2)
    assert out[0] == out[1]
    assert set(out[0]) == {"element_sharded", "vertex_partitioned",
                           "stencil_sharded"}
    assert all(v > 0 for v in out[0].values())
    assert dryrun.dryrun_multichip(2, "cpu") == out[0]
