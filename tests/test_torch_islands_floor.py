"""The float32 island run of tests/test_newton.py's TestMixedPrecision
against mixedfem_tpu, on the CPU: one step of small_beam(8, 3, 3) with 12
Newton iterations and CG to 1e-8, without islands and with
rhs_precision='float64'. Judged as the JAX test judges its own run, for
the port and for the JAX step alike: the islands' least decrement is under
5e-7 and no more than 1.05 times the native run's (the decrements print
under -s). The distance to the JAX step's island positions is
tests/test_torch_islands_beam.py's."""

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
from test_torch_islands_beam import _mesh32
from torch_parity import one_torch_thread, port, to_numpy  # noqa: F401


@pytest.fixture(scope="module", autouse=True)
def _one_thread(one_torch_thread):
    """Every test of this module runs on one torch intra-op thread."""


def _config(cls, dtype, rhs_precision="native"):
    return cls(h=0.02, outer_steps=12, newton_tol=0.0, itr_tol=1e-8,
               max_iterative_solver_iters=5000,
               mixed_variables=("mixed-stretch",), dtype=dtype,
               rhs_precision=rhs_precision)


def _least(dec):
    dec = np.asarray(dec)
    return dec[dec > 0].min()


def test_f32_islands_reach_the_f32_floor():
    mesh, V = small_beam(8, 3, 3)
    mesh32 = _mesh32(mesh)
    x0 = jnp.asarray(V, jnp.float32)
    floors = {}
    for rp in ("native", "float64"):
        jcfg = _config(JConfig, "float32", rp)
        st = jnewton.init_state(mesh32, jcfg, (), x0, jnp.zeros_like(x0))
        tm, ts, _ = port(mesh=mesh32, state=st, dtype=torch.float32)
        st = jax.jit(lambda s: jnewton.newton_step(mesh32, jcfg, (), s))(st)
        ts = tnewton.newton_step(tm, _config(TConfig, "float32", rp), (), ts)
        js = to_numpy(st)
        floors[rp] = (_least(ts.stats.decrement.numpy()),
                      _least(js["stats"]["decrement"]))
        print(f"{rp}: least decrement port {floors[rp][0]:.4e} JAX "
              f"{floors[rp][1]:.4e}; CG port {ts.stats.solver_iters.tolist()} "
              f"JAX {js['stats']['solver_iters'].tolist()}")
    for k, who in enumerate(("port", "JAX")):
        hp, native = floors["float64"][k], floors["native"][k]
        assert hp < 5e-7, (who, hp)
        assert hp <= native * 1.05, (who, hp, native)
