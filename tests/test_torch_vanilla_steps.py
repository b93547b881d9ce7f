"""3-step newton_step trajectories of the port with the vanilla (F-space)
stretch variable against the JAX package's, in float64 on the CPU, on the
swinging 360-tet beam and 200-triangle cantilever: the vanilla stretch
alone with block-Jacobi PCG (3D and 2D), with mixed-stretch beside it
through condensed PCG and through MINRES on the KKT system (its product in
the x-row), and the vanilla gradient norm recorded at the mixed iterates
(record_vanilla_gradient, the convergence harness's probe) to 1e-8
relative. Positions to 1e-8, Newton, CG and MINRES counts and alphas
equal. The KKT product with the vanilla rows and the JAX step's refusals
of the variable are tests/test_torch_vanilla_kkt.py's.

MINRES runs 10 iterations a Newton iteration: the vanilla Hessian is not
projected to PSD, and on the KKT system with it the two packages' MINRES
iterates, which agree to 1e-14 after 10 iterations on the same input,
part by 1e-5 after 30 (the products agree to 2e-16); at the 500-iteration
cap the trajectories end 8e-7 apart. The recorded gradient runs on a Fung
beam, whose CG counts no rounding moves (on the Stable-Neo-Hookean beam
one count of 91 came out 90 in the third step)."""

import jax.numpy as jnp
import numpy as np
import pytest

from mixedfem_tpu.config import SimConfig as JConfig
from mixedfem_tpu.mesh import mesh as jmesh
from mixedfem_tpu.optimizer import newton as jnewton
from mixedfem_tpu_torch.config import SimConfig as TConfig
from mixedfem_tpu_torch.optimizer import newton as tnewton

from solver_parity import near, swing
from torch_parity import (  # noqa: F401 (one_torch_thread is a fixture)
    beam_arrays, close, one_torch_thread, port, to_numpy, tri_arrays,
)


@pytest.fixture(scope="module", autouse=True)
def _one_thread(one_torch_thread):
    """Every test of this module runs on one torch intra-op thread."""


def trajectory(dim, models=("Stable-Neohookean",), **cfg):
    V, T, kw, _ = beam_arrays() if dim == 3 else tri_arrays()
    jm = jmesh.build_mesh_data(V, T, dtype=jnp.float64,
                               **dict(kw, models=models))
    step = dict(dict(h=0.02, outer_steps=3, newton_tol=0.0, itr_tol=1e-4,
                     max_iterative_solver_iters=500,
                     solver="pcg-block-jacobi"), **cfg)
    jcfg, tcfg = JConfig(**step), TConfig(**step)
    js = jnewton.init_state(jm, jcfg, (), jnp.asarray(V), jnp.asarray(swing(V)))
    tm, ts, _ = port(mesh=jm, state=js)
    out = []
    for _ in range(3):
        js = jnewton.newton_step(jm, jcfg, (), js)
        ts = tnewton.newton_step(tm, tcfg, (), ts)
        out.append((to_numpy(js), ts))
    for js, ts in out:
        close(ts.x, js["x"], rtol=0, atol=1e-8)
        close(ts.s, js["s"], rtol=0, atol=1e-8)
        it = ts.stats.iterations
        assert it == int(js["stats"]["iterations"])
        close(ts.stats.alpha, js["stats"]["alpha"], rtol=0, atol=0)
        np.testing.assert_array_equal(ts.stats.solver_iters.numpy(),
                                      js["stats"]["solver_iters"])
        assert not ts.la.any()
    return out


@pytest.mark.parametrize("dim", [3, 2])
def test_vanilla_only(dim):
    out = trajectory(dim, mixed_variables=(), variables=("stretch",))
    ts = out[-1][1]
    assert (ts.x - out[0][1].bdf.x_hist[-1]).abs().max() > 1e-3
    # the mixed variables stay where init_state put them
    np.testing.assert_array_equal(ts.s.numpy(), out[0][1].s.numpy())


@pytest.mark.parametrize("solver,cap", [("pcg-block-jacobi", 500),
                                        ("minres-kkt", 10)])
def test_mixed_and_vanilla(solver, cap):
    trajectory(3, solver=solver, max_iterative_solver_iters=cap,
               mixed_variables=("mixed-stretch",), variables=("stretch",))


def test_record_vanilla_gradient():
    out = trajectory(3, models=("Fung",), mixed_variables=("mixed-stretch",),
                     record_vanilla_gradient=True)
    for js, ts in out:
        want = js["stats"]["vanilla_grad"]
        assert (want[:ts.stats.iterations] > 0).all()
        near(ts.stats.vanilla_grad, want, 1e-8)
