"""The float32 island run of tests/test_newton.py's TestMixedPrecision
against mixedfem_tpu, on the CPU: one step of small_beam(8, 3, 3) with 12
Newton iterations and CG to 1e-8 with rhs_precision='float64'. The port's
island positions lie no further from the JAX step's island positions than
twice the JAX step's own distance between its float32 island run and its
float64 run (the margin prints under -s). The least decrements, judged as
the JAX test judges them, are tests/test_torch_islands_floor.py's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mixedfem_tpu.config import SimConfig as JConfig
from mixedfem_tpu.optimizer import newton as jnewton
from mixedfem_tpu_torch.config import SimConfig as TConfig
from mixedfem_tpu_torch.optimizer import newton as tnewton

from test_newton import small_beam
from torch_parity import one_torch_thread, port  # noqa: F401


@pytest.fixture(scope="module", autouse=True)
def _one_thread(one_torch_thread):
    """Every test of this module runs on one torch intra-op thread."""


def _config(cls, dtype, rhs_precision="native"):
    return cls(h=0.02, outer_steps=12, newton_tol=0.0, itr_tol=1e-8,
               max_iterative_solver_iters=5000,
               mixed_variables=("mixed-stretch",), dtype=dtype,
               rhs_precision=rhs_precision)


def _mesh32(mesh):
    return jax.tree.map(lambda a: a.astype(jnp.float32)
                        if hasattr(a, "dtype") and a.dtype == jnp.float64
                        else a, mesh)


def test_f32_islands_near_jax():
    mesh, V = small_beam(8, 3, 3)
    mesh32 = _mesh32(mesh)
    x0 = jnp.asarray(V, jnp.float32)
    jcfg = _config(JConfig, "float32", "float64")
    st = jnewton.init_state(mesh32, jcfg, (), x0, jnp.zeros_like(x0))
    tm, ts, _ = port(mesh=mesh32, state=st, dtype=torch.float32)
    jx = np.asarray(jax.jit(lambda s: jnewton.newton_step(
        mesh32, jcfg, (), s))(st).x, np.float64)
    tx = tnewton.newton_step(tm, _config(TConfig, "float32", "float64"), (),
                             ts).x.numpy().astype(np.float64)
    jcfg64 = _config(JConfig, "float64")
    st64 = jnewton.init_state(mesh, jcfg64, (), jnp.asarray(V),
                              jnp.zeros(V.shape))
    x64 = np.asarray(jax.jit(lambda s: jnewton.newton_step(
        mesh, jcfg64, (), s))(st64).x)
    own = np.abs(jx - x64).max()
    dist = np.abs(tx - jx).max()
    print(f"|x_port - x_jax| (islands) {dist:.3e}; JAX's own f32-island to "
          f"f64 distance {own:.3e}; margin {2 * own / dist:.2f}x")
    assert dist <= 2 * own
