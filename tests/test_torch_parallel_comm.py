"""The collective layer of mixedfem_tpu_torch/parallel/ (comm.py, launch.py)
on 3 gloo ranks on the CPU: psum is the rank-ordered sum bit for bit and
the same on every rank, pmax, the ring shifts wrap around as the JAX
package's ppermutes do, all_gather keeps rank order; a rank that skips a
collective makes run_ranks raise within its timeout instead of hanging,
and the launcher refuses what NCCL would refuse."""

import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from mixedfem_tpu_torch.parallel import launch, ranks

from torch_parity import one_torch_thread  # noqa: F401 (a fixture)

WORLD = 3


@pytest.fixture(scope="module", autouse=True)
def _one_thread(one_torch_thread):
    """Every test of this module runs on one torch intra-op thread."""


@pytest.fixture(scope="module")
def probe():
    return launch.run_ranks(ranks.comm_probe, WORLD, timeout=30)


def test_psum_is_the_rank_ordered_sum(probe):
    vals = [p[0] for p in probe]
    want = vals[0].copy()
    for v in vals[1:]:
        want = want + v
    for p in probe:
        assert p[1].tobytes() == want.tobytes()


def test_pmax_and_all_gather(probe):
    vals = np.stack([p[0] for p in probe])
    for p in probe:
        np.testing.assert_array_equal(p[2], vals.max(axis=0))
        np.testing.assert_array_equal(p[5], vals)


def test_shifts_wrap_around_the_ring(probe):
    """shift(t, +1) on rank i returns rank i-1's t (rank 0 gets rank 2's),
    shift(t, -1) rank i+1's (rank 2 gets rank 0's)."""
    for i, p in enumerate(probe):
        np.testing.assert_array_equal(p[3], probe[(i - 1) % WORLD][0])
        np.testing.assert_array_equal(p[4], probe[(i + 1) % WORLD][0])


def test_a_rank_that_skips_a_collective_raises():
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank"):
        launch.run_ranks(ranks.comm_probe, WORLD, args=(1,), timeout=10,
                         deadline=40)
    assert time.monotonic() - t0 < 45


def test_launcher_refusals():
    with pytest.raises(ValueError, match="nccl"):
        launch.run_ranks(ranks.comm_probe, 2, backend="nccl",
                         devices=["cuda:0", "cuda:0"])
    with pytest.raises(ValueError, match="60 s"):
        launch.run_ranks(ranks.comm_probe, 2, timeout=120)
    with pytest.raises(ValueError, match="devices"):
        launch.run_ranks(ranks.comm_probe, 2, devices=["cpu"])


def test_a_bare_cuda_device_is_card_0():
    """A rank given 'cuda' runs on card 0 (torch.cuda.set_device refuses a
    device without an index), so 'cuda' and 'cuda:0' are one device to the
    launcher's nccl check."""
    assert launch._indexed("cuda") == torch.device("cuda", 0)
    assert launch._indexed("cuda:1") == torch.device("cuda", 1)
    assert launch._indexed("cpu") == torch.device("cpu")
    with pytest.raises(ValueError, match="nccl"):
        launch.run_ranks(ranks.comm_probe, 2, backend="nccl",
                         devices=["cuda", "cuda:0"])


def test_a_rank_that_dies_while_starting_raises():
    """Ranks started from a script on standard input die while starting
    (spawn cannot import its main module again); with large arguments the
    launcher still raises at once instead of blocking in a process's
    start."""
    code = (
        "import numpy as np\n"
        "from mixedfem_tpu_torch.parallel import launch, ranks\n"
        "try:\n"
        "    launch.run_ranks(ranks.comm_probe, 2, args=(None,),\n"
        "                     kwargs=dict(), deadline=40)\n"
        "except RuntimeError as e:\n"
        "    print('raised:', str(e).splitlines()[0])\n"
        "big = np.zeros(4_000_000)\n"
        "try:\n"
        "    launch.run_ranks(ranks.sequence, 2, args=([], big), deadline=40)\n"
        "except RuntimeError as e:\n"
        "    print('raised:', str(e).splitlines()[0])\n")
    t0 = time.monotonic()
    out = subprocess.run([sys.executable, "-"], input=code, text=True,
                         capture_output=True, timeout=120,
                         cwd=os.path.dirname(os.path.dirname(
                             os.path.abspath(__file__))))
    lines = [ln for ln in out.stdout.splitlines() if ln.startswith("raised")]
    assert len(lines) == 2 and all("no report" in ln for ln in lines), (
        out.stdout, out.stderr[-2000:])
    assert time.monotonic() - t0 < 60
