"""Parity of mixedfem_tpu_torch's shells (3D triangle membranes) with
mixedfem_tpu's, in float64 on the CPU: the host precompute
(tri3d_dphidX, the rest normals, the shell mass, build_mesh_data with
shell=True), the normal-augmented deformation gradient and its
re-linearized Jacobian, the mixed-stretch update through K7's plain
version, and a 3-step drape of tests/test_shell.py's cloth(6, 6) through
newton_step (default pcg, no coarse space, no plan): positions and
stretches to 1e-8, equal Newton and CG counts and alphas. A plan passed
with a shell is ignored, as the JAX step ignores it."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mixedfem_tpu.config import SimConfig as JConfig
from mixedfem_tpu.mesh import discretization as jdisc
from mixedfem_tpu.mesh import mesh as jmesh
from mixedfem_tpu.optimizer import newton as jnewton
from mixedfem_tpu.variables import mixed_stretch as jms
from mixedfem_tpu_torch import cuda
from mixedfem_tpu_torch.config import SimConfig as TConfig
from mixedfem_tpu_torch.mesh import discretization as tdisc
from mixedfem_tpu_torch.mesh import mesh as tmesh
from mixedfem_tpu_torch.optimizer import newton as tnewton
from mixedfem_tpu_torch.solvers import operator as top
from mixedfem_tpu_torch.variables import mixed_stretch as tms

from torch_parity import (  # noqa: F401 (one_torch_thread is a fixture)
    close, cloth_arrays, one_torch_thread, port, t64, to_numpy,
)


@pytest.fixture(scope="module", autouse=True)
def _one_thread(one_torch_thread):
    """Every test of this module runs on one torch intra-op thread."""


@pytest.fixture(scope="module")
def cloth():
    V, T, kw = cloth_arrays()
    jm = jmesh.build_mesh_data(V, T, dtype=jnp.float64, **kw)
    tm, _, _ = port(mesh=jm)
    return V, T, kw, jm, tm


@pytest.fixture(scope="module")
def bent(cloth):
    """Positions off the plane (seeded), where the normal term of F and of
    its Jacobian is not zero."""
    V = cloth[0]
    rng = np.random.default_rng(0)
    return V + 0.05 * rng.standard_normal(V.shape)


def test_host_precompute(cloth):
    """tri3d_dphidX, the rest normals and the shell mass to 1e-14 on a
    seeded non-planar sheet."""
    V, T = cloth[0], cloth[1]
    rng = np.random.default_rng(1)
    Vb = V + 0.1 * rng.standard_normal(V.shape)
    close(tdisc.tri3d_dphidX(Vb, T), jdisc.tri3d_dphidX(Vb, T), rtol=1e-14,
          atol=1e-14)
    close(tdisc.tri3d_rest_normals(Vb, T), jdisc.tri3d_rest_normals(Vb, T),
          rtol=1e-14, atol=1e-14)
    vols = jdisc.tri_double_areas(Vb, T) * 5e-4
    dens = np.full(len(T), 100.0)
    close(tdisc.consistent_mass_coeff(vols, dens, 3, shell=True),
          jdisc.consistent_mass_coeff(vols, dens, 3, shell=True), rtol=1e-14)


def test_build_mesh_data(cloth):
    """The port's own build_mesh_data(shell=True) against JAX's: every
    field to 1e-12, the surface being the shell itself."""
    V, T, kw, jm, _ = cloth
    tm = tmesh.build_mesh_data(V, T, dtype=torch.float64, device="cpu", **kw)
    assert tm.shell and not tm.rod and tm.dim == 3
    for name in ("V0", "dphidX", "vols", "mass_coeff", "mass_lumped",
                 "mass_diag", "free_mask", "mu", "lam", "ext_force",
                 "rest_normal"):
        close(getattr(tm, name), getattr(jm, name), rtol=1e-12, atol=1e-15)
    for name in ("T", "F_srf", "E_srf"):
        np.testing.assert_array_equal(getattr(tm, name).numpy(),
                                      np.asarray(getattr(jm, name)))


def test_def_grad_and_jacobian(cloth, bent):
    """F = F0 + n N^T and dF/dx (E, k, r, a, c) to 1e-12 off the plane, and
    F = I at rest."""
    _, _, _, jm, tm = cloth
    close(tmesh.def_grad(tm, t64(cloth[0])),
          np.tile(np.eye(3), (tm.nelem, 1, 1)), rtol=0, atol=1e-12)
    xj = jnp.asarray(bent)
    close(tmesh.def_grad(tm, t64(bent)), jmesh.def_grad(jm, xj), rtol=1e-12,
          atol=1e-12)
    close(tmesh.shell_def_grad_jacobian(tm, t64(bent)),
          jmesh.shell_def_grad_jacobian(jm, xj), rtol=1e-12, atol=1e-12)


def test_update(cloth, bent):
    """The mixed-stretch coefficients of a shell (G from the Jacobian, Gw
    through contract_Gw's plain version) to 1e-10 of scale."""
    _, _, _, jm, tm = cloth
    xj = jnp.asarray(bent)
    s = np.asarray(jms.reset(jm, xj)[0])
    s = s + 0.01 * np.random.default_rng(2).standard_normal(s.shape)
    j = jms.update(jm, xj, jnp.asarray(s), 0.01)
    t = tms.update(tm, t64(bent), t64(s), 0.01)
    for name in ("G", "Gw", "H", "g", "Sv"):
        ref = np.asarray(getattr(j, name))
        close(getattr(t, name), ref, rtol=1e-10,
              atol=1e-10 * np.abs(ref).max())


STEP = dict(h=0.01, outer_steps=3, itr_tol=1e-8,
            mixed_variables=("mixed-stretch",), dtype="float64")


@pytest.fixture(scope="module")
def drape(cloth):
    """3 steps of both packages' newton_step from rest."""
    _, _, _, jm, _ = cloth
    jcfg, tcfg = JConfig(**STEP), TConfig(**STEP)
    x0 = jnp.asarray(jm.V0)
    st = jnewton.init_state(jm, jcfg, (), x0, jnp.zeros_like(x0))
    tm, ts, _ = port(mesh=jm, state=st)
    jstep = jax.jit(lambda s: jnewton.newton_step(jm, jcfg, (), s))
    out = []
    cuda.LAUNCHES.clear()
    for _ in range(3):
        st = jstep(st)
        ts = tnewton.newton_step(tm, tcfg, (), ts)
        out.append((to_numpy(st), ts))
    return tm, tcfg, out


def test_drape_trajectory(drape):
    """Positions and stretches to 1e-8; Newton counts, CG counts and alphas
    equal; the pinned corners stay; no kernel runs on the CPU."""
    tm, _, out = drape
    for js, ts in out:
        close(ts.x, js["x"], rtol=0, atol=1e-8)
        close(ts.s, js["s"], rtol=0, atol=1e-8)
        it = ts.stats.iterations
        assert it == int(js["stats"]["iterations"]) > 0
        np.testing.assert_array_equal(ts.stats.solver_iters.numpy(),
                                      js["stats"]["solver_iters"])
        close(ts.stats.alpha, js["stats"]["alpha"], rtol=0, atol=0)
        assert not ts.la.any()
    fixed = tm.free_mask == 0
    close(out[-1][1].x[fixed], tm.V0[fixed].numpy(), rtol=0, atol=1e-12)
    assert float(out[-1][1].x[:, 2].min()) < 0
    assert sum(cuda.LAUNCHES.values()) == 0


def test_plan_ignored(cloth, drape):
    """A banded plan passed with a shell changes nothing: the step sums
    over the mesh's incidence plan and its matvec is element_matvec, as in
    the JAX step."""
    tm, tcfg, out = drape
    x0 = tm.V0.clone()
    st = tnewton.init_state(tm, tcfg, (), x0, torch.zeros_like(x0))
    plan = top.build_banded_plan(tm)
    a = tnewton.newton_step(tm, tcfg, (), st)
    b = tnewton.newton_step(tm, tcfg, (), st, None, (), plan)
    assert torch.equal(a.x, b.x)
    close(a.x, out[0][1].x, rtol=0, atol=1e-12)
    assert tnewton._select_body(tcfg, "pcg", None, plan, False, 3,
                                shell=True) == "generic"
