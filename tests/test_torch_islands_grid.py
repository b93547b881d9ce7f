"""The block-Jacobi diagonal of an f64-island step on a stencil plan
against mixedfem_tpu's, on the CPU: with islands the JAX step takes it as
the mass diagonal plus the float32 stretch blocks (the float32 cast of the
float64 update) summed per vertex, not as W's o = 0 plane
(mixedfem_tpu/optimizer/newton.py:712-726), and assembles W afterwards
from the float32 Gw (:812). Held to float32 rounding (2e-6 of scale), on
the 360-tet swinging grid of tests/test_torch_lattice_cg.py through the
'lattice_cg' body."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mixedfem_tpu.config import SimConfig as JConfig
from mixedfem_tpu.optimizer import newton as jnewton
from mixedfem_tpu.variables import mixed_stretch as jms
from mixedfem_tpu_torch.config import SimConfig as TConfig
from mixedfem_tpu_torch.optimizer import newton as tnewton
from mixedfem_tpu_torch.solvers import pcg as tpcg

from solver_parity import near
from test_torch_islands import DT, F32, _up
from test_torch_lattice_cg import grid  # noqa: F401 (a fixture)
from torch_parity import (  # noqa: F401 (one_torch_thread is a fixture)
    SolveRecorder, one_torch_thread, port,
)


@pytest.fixture(scope="module", autouse=True)
def _one_thread(one_torch_thread):
    """Every test of this module runs on one torch intra-op thread."""


def test_stencil_plan_blocks(grid):  # noqa: F811
    """An island step on the 360-tet grid with its plan ('lattice_cg'
    body): its block-Jacobi diagonal (recorded where the lattice CG
    inverts it) is mass_diag I + the float32 stretch blocks summed per
    vertex, to 2e-6 of scale of the JAX package's, from the float32 cast
    of the float64 update; W's o = 0 plane is the same sum in another
    order."""
    from mixedfem_tpu.ops import stencil as jst

    jm64, tplan, jplan = grid["jm"], grid["tplan"], grid["jplan"]
    jm = jax.tree.map(lambda a: a.astype(jnp.float32)
                      if hasattr(a, "dtype") and a.dtype == jnp.float64 else a,
                      jm64)
    V = grid["V"]
    cfg = dict(h=DT, outer_steps=1, newton_tol=0.0, itr_tol=1e-4,
               max_iterative_solver_iters=500, dtype="float32",
               mixed_variables=("mixed-stretch",), rhs_precision="float64",
               solver="pcg-block-jacobi")
    tcfg = TConfig(**cfg)
    x0 = V.astype(np.float32)
    v0 = np.zeros_like(x0)
    v0[:, 1] = -2.0 * V[:, 0] / 4.0
    jst_ = jnewton.init_state(jm, JConfig(**cfg), (), jnp.asarray(x0),
                              jnp.asarray(v0))
    tm, ts, _ = port(mesh=jm, state=jst_, dtype=F32)
    assert tnewton._select_body(tcfg, tcfg.solver, None, tplan, False, 3,
                                hp=True) == "lattice_cg"
    with SolveRecorder(tpcg, "_small_inv", iters_at=None) as rec:
        out = tnewton.newton_step(tm, tcfg, (), ts, None, (), tplan)
    assert out.stats.iterations == 1 and torch.isfinite(out.x).all()
    (args, _, _), = rec.calls
    got = args[0]
    # the JAX hp step's blocks at the same iterate
    s0 = np.asarray(jst_.s)
    assert s0.dtype == np.float32
    c32 = jax.tree.map(lambda a: a.astype(jnp.float32), jax.jit(jms.update)(
        _up(jm), jnp.asarray(x0, jnp.float64), jnp.asarray(s0, jnp.float64),
        DT))
    blocks = jm.mass_diag[:, None, None] * jnp.eye(3) + jms.diag_blocks(jm,
                                                                         c32)
    maskv = jm.free_mask[:, None, None]
    want = np.asarray(blocks * maskv + jnp.eye(3) * (1.0 - maskv))
    assert got.dtype == F32
    near(got, want, rtol=2e-6)
    W = jst.assemble_W(jplan, c32.Gw, jm.mass_coeff)
    o0 = np.asarray(jst.diag_blocks(jplan, W) * maskv
                    + jnp.eye(3) * (1.0 - maskv))
    near(got, o0, rtol=2e-6)
