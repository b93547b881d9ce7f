"""Parity of the port's F-space material densities (materials/models.py
psi_F_all, grad_F_all, hess_F_all: torch.func through the polar
decomposition of ops/rotation.py, 8 Jacobi sweeps in 3D, the closed form
in 2D) with the JAX package's, in float64 on the CPU, to 1e-10: all six
models on one batch of deformed, uninverted F (round-robin model ids, so
every model's elements are checked), in 3D and 2D. Each package evaluates
once per dimension (JAX compiles each function once for the six models);
each case checks one function on one model's elements."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mixedfem_tpu.materials import models as jmat
from mixedfem_tpu_torch.materials import models as tmat

from solver_parity import near
from torch_parity import one_torch_thread, t64  # noqa: F401 (a fixture)


@pytest.fixture(scope="module", autouse=True)
def _one_thread(one_torch_thread):
    """Every test of this module runs on one torch intra-op thread."""


NAMES = jmat.MATERIAL_NAMES
FNS = ("psi_F_all", "grad_F_all", "hess_F_all")


@pytest.fixture(scope="module", params=[3, 2], ids=["3d", "2d"])
def evaluated(request):
    dim, E = request.param, 36
    rng = np.random.default_rng(dim)
    F = np.eye(dim) + 0.25 * rng.standard_normal((E, dim, dim))
    F[np.linalg.det(F) < 0.2] = np.eye(dim)
    mu = rng.uniform(1e3, 1e4, E)
    la = rng.uniform(1e3, 1e5, E)
    mid = np.arange(E) % len(NAMES)
    out = {}
    for fn in FNS:
        want = getattr(jmat, fn)(jnp.asarray(F), jnp.asarray(mu),
                                 jnp.asarray(la), jnp.asarray(mid), NAMES)
        got = getattr(tmat, fn)(t64(F), t64(mu), t64(la), torch.tensor(mid),
                                NAMES)
        out[fn] = (got, np.asarray(want))
    return mid, out


@pytest.mark.parametrize("fn", FNS)
@pytest.mark.parametrize("model", range(len(NAMES)), ids=NAMES)
def test_F_space_density(evaluated, fn, model):
    mid, out = evaluated
    got, want = out[fn]
    sel = mid == model
    assert np.abs(want[sel]).max() > 0
    near(got[torch.tensor(sel)], want[sel], 1e-10)


def test_single_model_is_a_straight_vmap():
    """One model on its own gives what the six-model mask selects."""
    rng = np.random.default_rng(0)
    F = np.eye(3) + 0.2 * rng.standard_normal((5, 3, 3))
    mu, la = np.full(5, 3e3), np.full(5, 2e4)
    for fn in FNS:
        one = getattr(tmat, fn)(t64(F), t64(mu), t64(la),
                                torch.zeros(5, dtype=torch.int64), ("ARAP",))
        six = getattr(tmat, fn)(t64(F), t64(mu), t64(la),
                                torch.zeros(5, dtype=torch.int64), NAMES)
        near(one, six.numpy(), 1e-14)
