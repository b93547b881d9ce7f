"""Parity of the port's vanilla (F-space) stretch variable with the JAX
package's, in float64 on the CPU: mesh.def_grad_adjoint and every function
of variables/stretch.py to 1e-12, over the incidence plan and over a
banded plan, and the condensed matvec with the vanilla rows
(operator.element_matvec, banded_matvec), with and without the mixed
variable, to 1e-12; on a deformed mesh of two models (3D and 2D). The
F-space densities themselves are tests/test_torch_vanilla_materials.py's."""

import jax.numpy as jnp
import numpy as np
import pytest

from mixedfem_tpu.mesh import mesh as jmesh
from mixedfem_tpu.solvers import operator as jop
from mixedfem_tpu.variables import mixed_stretch as jms
from mixedfem_tpu.variables import stretch as jvs
from mixedfem_tpu_torch.mesh import mesh as tmesh
from mixedfem_tpu_torch.solvers import operator as top
from mixedfem_tpu_torch.variables import mixed_stretch as tms
from mixedfem_tpu_torch.variables import stretch as tvs

from solver_parity import near
from torch_parity import (  # noqa: F401 (one_torch_thread is a fixture)
    beam_arrays, one_torch_thread, port, t64, to_numpy, tri_arrays,
)


@pytest.fixture(scope="module", autouse=True)
def _one_thread(one_torch_thread):
    """Every test of this module runs on one torch intra-op thread."""


DT = 0.02


def _mesh(dim, models=("Stable-Neohookean",), seed=0):
    """The deformed 360-tet beam or 200-triangle cantilever with `models`
    assigned round-robin, in both packages (a rotation-based model and one
    of F's invariants)."""
    V, T, kw, x = beam_arrays(seed=seed) if dim == 3 else tri_arrays(seed=seed)
    kw = dict(kw, models=models, model_id=np.arange(len(T)) % len(models))
    jm = jmesh.build_mesh_data(V, T, dtype=jnp.float64, **kw)
    tm, _, _ = port(mesh=jm)
    return jm, tm, x


@pytest.fixture(scope="module", params=[3, 2], ids=["3d", "2d"])
def mesh(request):
    jm, tm, x = _mesh(request.param, models=("ARAP", "Stable-Neohookean"))
    plan = top.build_banded_plan(tm, chunk=256)
    return jm, tm, x, plan


def test_def_grad_adjoint(mesh):
    jm, tm, x, plan = mesh
    Y = np.random.default_rng(7).standard_normal((tm.nelem, tm.dim, tm.dim))
    want = jmesh.def_grad_adjoint(jm, jnp.asarray(Y))
    near(tmesh.def_grad_adjoint(tm, t64(Y)), want, 1e-12)
    near(tmesh.def_grad_adjoint(tm, t64(Y), plan), want, 1e-12)


def test_stretch_functions(mesh):
    jm, tm, x, plan = mesh
    jc = jvs.update(jm, jnp.asarray(x), DT)
    tc = tvs.update(tm, t64(x), DT)
    near(tc.g, jc.g, 1e-12)
    near(tc.H, jc.H, 1e-12)
    near(tvs.energy(tm, t64(x)), jvs.energy(jm, jnp.asarray(x)), 1e-12)
    # the rest of the functions on JAX's coefficients carried across
    tc = tvs.VanillaCoeffs(**{k: t64(v) for k, v in to_numpy(jc).items()})
    p = np.random.default_rng(8).standard_normal((tm.nv, tm.dim))
    for pl in (None, plan):
        near(tvs.gradient(tm, tc, pl), jvs.gradient(jm, jc), 1e-12)
        near(tvs.gradient_at(tm, t64(x), DT, pl),
             jvs.gradient_at(jm, jnp.asarray(x), DT), 1e-12)
        near(tvs.matvec(tm, tc, t64(p), pl),
             jvs.matvec(jm, jc, jnp.asarray(p)), 1e-12)
        near(tvs.diag_blocks(tm, tc, pl), jvs.diag_blocks(jm, jc), 1e-12)


@pytest.mark.parametrize("mixed", [True, False], ids=["mixed", "vanilla-only"])
def test_condensed_matvec_with_vanilla(mesh, mixed):
    jm, tm, x, plan = mesh
    jv = jvs.update(jm, jnp.asarray(x), DT)
    tv = tvs.VanillaCoeffs(**{k: t64(v) for k, v in to_numpy(jv).items()})
    jc = tc = None
    if mixed:
        s = tms.reset(tm, t64(x))[0].numpy()
        jc = jms.update(jm, jnp.asarray(x), jnp.asarray(s), DT)
        tc = tms.StretchCoeffs(**{k: t64(v) for k, v in to_numpy(jc).items()})
    p = np.random.default_rng(9).standard_normal((tm.nv, tm.dim))
    want = jop.element_matvec(jm, jnp.asarray(p), ms_coeffs=jc, v_coeffs=jv)
    near(top.element_matvec(tm, t64(p), tc, tv), want, 1e-12)
    near(top.banded_matvec(tm, plan, t64(p), tc, tv), want, 1e-12)
