"""The element-sharded host solver 'pcg-ic' through Simulation.step on 2
gloo ranks against the JAX package's sharded step on 2 virtual CPU
devices (tests/es_solvers.py host_case says what is held and how)."""

import pytest

from es_solvers import host_case
from torch_parity import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module", autouse=True)
def _one_thread(one_torch_thread):
    """Every test of this module runs on one torch intra-op thread."""


def test_host_ic_matches_jax():
    host_case("pcg-ic")
