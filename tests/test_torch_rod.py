"""Parity of mixedfem_tpu_torch's rods (3D segments with a
frame-augmented deformation gradient, mesh/rod.py) with mixedfem_tpu's,
in float64 on the CPU: the rest frames, rod_def_grad, the 9x6 Jacobian
per segment (torch.func.jacfwd under vmap against JAX's jax.jacfwd), the
mass, build_rod_mesh_data, the mixed-stretch update through K7's plain
version, and 3-step trajectories through newton_step (default pcg, no
coarse space) of tests/test_rod.py's hanging chain_rod(9) and of a bundle
of 4 strands pinned at their roots: positions and stretches to 1e-8,
equal Newton and CG counts and alphas."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mixedfem_tpu.config import SimConfig as JConfig
from mixedfem_tpu.mesh import mesh as jmesh
from mixedfem_tpu.mesh import rod as jrod
from mixedfem_tpu.optimizer import newton as jnewton
from mixedfem_tpu.variables import mixed_stretch as jms
from mixedfem_tpu_torch import cuda
from mixedfem_tpu_torch.config import SimConfig as TConfig
from mixedfem_tpu_torch.mesh import mesh as tmesh
from mixedfem_tpu_torch.mesh import rod as trod
from mixedfem_tpu_torch.optimizer import newton as tnewton
from mixedfem_tpu_torch.variables import mixed_stretch as tms

from torch_parity import (  # noqa: F401 (one_torch_thread is a fixture)
    close, one_torch_thread, port, rod_arrays, t64, to_numpy,
)


@pytest.fixture(scope="module", autouse=True)
def _one_thread(one_torch_thread):
    """Every test of this module runs on one torch intra-op thread."""


@pytest.fixture(scope="module")
def chain():
    V, E, kw = rod_arrays()
    jm = jmesh.build_rod_mesh_data(V, E, dtype=jnp.float64, **kw)
    tm, _, _ = port(mesh=jm)
    return V, E, kw, jm, tm


@pytest.fixture(scope="module")
def bent(chain):
    rng = np.random.default_rng(0)
    return chain[0] + 0.05 * rng.standard_normal(chain[0].shape)


def _frame_args(jm):
    return (jnp.asarray(jm.T), jm.rod_frames[:, 0], jm.rod_frames[:, 1],
            jm.rod_frames[:, 2], jm.rod_L)


def _tframe_args(tm):
    return (tm.T, tm.rod_frames[:, 0], tm.rod_frames[:, 1],
            tm.rod_frames[:, 2], tm.rod_L)


def test_rest_frames_and_mass():
    """rod_rest_frames on segments in general position (and along x, where
    the reference direction switches) and the segment mass to 1e-14."""
    rng = np.random.default_rng(1)
    V = np.concatenate([rng.standard_normal((12, 3)),
                        np.array([[0.0, 0, 0], [1.0, 0, 0]])])
    E = np.array([[2 * i, 2 * i + 1] for i in range(7)], np.int32)
    for got, want in zip(trod.rod_rest_frames(V, E), jrod.rod_rest_frames(V, E)):
        close(got, want, rtol=1e-14, atol=1e-14)
    L = rng.uniform(0.1, 1.0, 7)
    close(trod.rod_mass_coeff(L, np.full(7, 1000.0), 5e-3),
          jrod.rod_mass_coeff(L, np.full(7, 1000.0), 5e-3), rtol=1e-14)


def test_build_rod_mesh_data(chain):
    """The port's own build_rod_mesh_data against JAX's: every field to
    1e-12."""
    V, E, kw, jm, _ = chain
    tm = tmesh.build_rod_mesh_data(V, E, dtype=torch.float64, device="cpu",
                                   **kw)
    assert tm.rod and not tm.shell and tm.dim == 3
    for name in ("V0", "dphidX", "vols", "mass_coeff", "mass_lumped",
                 "mass_diag", "free_mask", "mu", "lam", "ext_force",
                 "rod_frames", "rod_L"):
        close(getattr(tm, name), getattr(jm, name), rtol=1e-12, atol=1e-15)
    for name in ("T", "E_srf"):
        np.testing.assert_array_equal(getattr(tm, name).numpy(),
                                      np.asarray(getattr(jm, name)))
    assert tm.F_srf.shape == (0, 3)


def test_def_grad_and_jacobian(chain, bent):
    """rod_def_grad (F = I at rest) and its Jacobian (E, k, r, a, c) at
    seeded positions against JAX's jax.jacfwd, to 1e-12."""
    _, _, _, jm, tm = chain
    close(tmesh.def_grad(tm, t64(chain[0])),
          np.tile(np.eye(3), (tm.nelem, 1, 1)), rtol=0, atol=1e-12)
    xj = jnp.asarray(bent)
    close(tmesh.def_grad(tm, t64(bent)), jmesh.def_grad(jm, xj), rtol=1e-12,
          atol=1e-12)
    J = trod.rod_def_grad_jacobian(t64(bent), *_tframe_args(tm))
    assert J.shape == (tm.nelem, 2, 3, 3, 3) and J.is_contiguous()
    close(J, jrod.rod_def_grad_jacobian(xj, *_frame_args(jm)), rtol=1e-12,
          atol=1e-12)


def test_update(chain, bent):
    """The mixed-stretch coefficients of a rod (G from the Jacobian, Gw
    through contract_Gw's plain version) to 1e-10 of scale."""
    _, _, _, jm, tm = chain
    xj = jnp.asarray(bent)
    s = np.asarray(jms.reset(jm, xj)[0])
    s = s + 0.01 * np.random.default_rng(2).standard_normal(s.shape)
    j = jms.update(jm, xj, jnp.asarray(s), 0.01)
    t = tms.update(tm, t64(bent), t64(s), 0.01)
    for name in ("G", "Gw", "H", "g", "Sv"):
        ref = np.asarray(getattr(j, name))
        close(getattr(t, name), ref, rtol=1e-10,
              atol=1e-10 * np.abs(ref).max())


# tests/test_rod.py:test_hanging_rod_steps_stably's settings at 3 Newton
# iterations a step, with CG to 1e-8 instead of 1e-10: the chain's CG
# fills its Krylov space in 16 iterations, and the residual that last
# iteration leaves is rounding (27.3 to 2.3e-11 of |b| in the third
# Newton iteration of the first step, whose |b| is small), so whether it
# lands under 1e-10 is rounding's to decide (the port stopped there at
# 16, the JAX package at 17, with positions equal to 1e-18); at 1e-8 every
# stop lies orders of magnitude from that floor
STEP = dict(h=0.01, outer_steps=3, itr_tol=1e-8,
            max_iterative_solver_iters=2000,
            mixed_variables=("mixed-stretch",), dtype="float64")


@pytest.mark.parametrize("strands", [1, 4])
def test_trajectory(strands):
    """3 steps of both packages from rest: positions and stretches to 1e-8,
    Newton counts, CG counts and alphas equal, the roots pinned, the tips
    falling; no kernel runs on the CPU."""
    V, E, kw = rod_arrays(strands)
    jm = jmesh.build_rod_mesh_data(V, E, dtype=jnp.float64, **kw)
    jcfg, tcfg = JConfig(**STEP), TConfig(**STEP)
    x0 = jnp.asarray(V)
    st = jnewton.init_state(jm, jcfg, (), x0, jnp.zeros_like(x0))
    tm, ts, _ = port(mesh=jm, state=st)
    jstep = jax.jit(lambda s: jnewton.newton_step(jm, jcfg, (), s))
    cuda.LAUNCHES.clear()
    for _ in range(3):
        st = jstep(st)
        ts = tnewton.newton_step(tm, tcfg, (), ts)
        js = to_numpy(st)
        close(ts.x, js["x"], rtol=0, atol=1e-8)
        close(ts.s, js["s"], rtol=0, atol=1e-8)
        it = ts.stats.iterations
        assert it == int(js["stats"]["iterations"]) > 0
        np.testing.assert_array_equal(ts.stats.solver_iters.numpy(),
                                      js["stats"]["solver_iters"])
        close(ts.stats.alpha, js["stats"]["alpha"], rtol=0, atol=0)
    fixed = tm.free_mask == 0
    close(ts.x[fixed], V[fixed.numpy()], rtol=0, atol=1e-12)
    assert float(ts.x[:, 1].min()) < 0
    assert sum(cuda.LAUNCHES.values()) == 0
