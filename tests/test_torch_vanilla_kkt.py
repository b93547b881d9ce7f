"""The vanilla stretch's KKT rows and refusals, against the JAX package
in float64 on the CPU: the KKT product with the vanilla Hessian in its
x-row (minres-kkt's extra_x_matvec) to 1e-12 and 10 MINRES iterations on
it to 1e-12 from the same coefficients (the Fung beam of
solver_parity.kkt_inputs); and the JAX step's refusals of the variable
(full-system and Laplacian paths without mixed-stretch, ADMM and dual-cg
with the vanilla variable), raised by both packages."""

import jax.numpy as jnp
import pytest
import torch

from mixedfem_tpu.config import SimConfig as JConfig
from mixedfem_tpu.mesh import mesh as jmesh
from mixedfem_tpu.optimizer import newton as jnewton
from mixedfem_tpu.solvers import minres as jmr
from mixedfem_tpu.variables import stretch as jvs
from mixedfem_tpu_torch.config import SimConfig as TConfig
from mixedfem_tpu_torch.optimizer import newton as tnewton
from mixedfem_tpu_torch.solvers import minres as tmr
from mixedfem_tpu_torch.variables import stretch as tvs

from solver_parity import kkt_inputs, near, random_tuple
from torch_parity import (  # noqa: F401 (one_torch_thread is a fixture)
    beam_arrays, one_torch_thread, port, t64, to_numpy,
)


@pytest.fixture(scope="module", autouse=True)
def _one_thread(one_torch_thread):
    """Every test of this module runs on one torch intra-op thread."""


def test_kkt_operator_and_minres_with_vanilla():
    """The KKT product with the vanilla Hessian in its x-row to 1e-12 and
    10 MINRES iterations on it to 1e-12, from the same coefficients."""
    d = kkt_inputs()
    jv = jvs.update(d["jm"], jnp.asarray(d["x"]), 0.02)
    tv = tvs.VanillaCoeffs(**{k: t64(v) for k, v in to_numpy(jv).items()})
    Aj = jmr.kkt_operator(d["jm"], d["jc"],
                          extra_x_matvec=lambda p: jvs.matvec(d["jm"], jv, p))
    At = tmr.kkt_operator(d["tm"], d["tc"],
                          extra_x_matvec=lambda p: tvs.matvec(d["tm"], tv, p))
    _, uj, ut = random_tuple([r.shape for r in d["jr"][:3]], 3)
    for a, b in zip(At(ut), Aj(uj)):
        near(a, b, 1e-12)
    Mj = jmr.kkt_block_diag_preconditioner(d["jm"], d["jc"])
    Mt = tmr.kkt_block_diag_preconditioner(d["tm"], d["tc"])
    xj = jmr.minres(Aj, d["jr"][:3],
                    tuple(jnp.zeros_like(r) for r in d["jr"][:3]),
                    max_iters=10, tol=1e-14, Minv=Mj)
    xt = tmr.minres(At, d["tr"][:3],
                    tuple(torch.zeros_like(r) for r in d["tr"][:3]),
                    max_iters=10, tol=1e-14, Minv=Mt)
    assert int(xt[1]) == int(xj[1]) == 10
    for a, b in zip(xt[0], xj[0]):
        near(a, b, 1e-12)


@pytest.mark.parametrize("solver,cfg", [
    ("minres-kkt", dict(mixed_variables=(), variables=("stretch",))),
    ("pcg-laplacian", dict(mixed_variables=(), variables=("stretch",))),
    ("admm", dict(variables=("stretch",))),
    ("dual-cg", dict(variables=("stretch",))),
], ids=["kkt-without-mixed", "laplacian-without-mixed", "admm-vanilla",
        "dual-cg-vanilla"])
def test_refusals(solver, cfg):
    """The JAX step's refusals of the vanilla variable, in both packages."""
    V, T, kw, _ = beam_arrays()
    jm = jmesh.build_mesh_data(V, T, dtype=jnp.float64, **kw)
    step = dict(h=0.02, outer_steps=1, solver=solver, **cfg)
    js = jnewton.init_state(jm, JConfig(**step), (), jnp.asarray(V),
                            jnp.zeros_like(jnp.asarray(V)))
    tm, ts, _ = port(mesh=jm, state=js)
    with pytest.raises(NotImplementedError):
        jnewton.newton_step(jm, JConfig(**step), (), js)
    with pytest.raises(NotImplementedError):
        tnewton.newton_step(tm, TConfig(**step), (), ts)
