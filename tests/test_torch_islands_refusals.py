"""Where mixedfem_tpu_torch refuses f64 islands (config.rhs_precision =
'float64'), against mixedfem_tpu, on the CPU: every on-device solver, with
no contact variables, with the nodal collision or friction variable over a
state that has frames (and collision over one that has none), on float32
and float64 states of a 12-tet beam. Both steps run until their first
computation (displacement.target, replaced by a stop); each either raises
the same exception type, with the JAX message for the islands' own
refusals, or reaches that point."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mixedfem_tpu.config import SimConfig as JConfig
from mixedfem_tpu.optimizer import newton as jnewton
from mixedfem_tpu.solvers import factory as jfactory
from mixedfem_tpu.solvers import gauss_seidel as jgs
from mixedfem_tpu.variables import mixed_collision as jmc
from mixedfem_tpu_torch.config import SimConfig as TConfig
from mixedfem_tpu_torch.optimizer import newton as tnewton
from mixedfem_tpu_torch.solvers import gauss_seidel as tgs

from test_newton import small_beam
from test_torch_islands import DT, F32, F64
from torch_parity import one_torch_thread, port  # noqa: F401 (a fixture)


@pytest.fixture(scope="module", autouse=True)
def _one_thread(one_torch_thread):
    """Every test of this module runs on one torch intra-op thread."""


class _Reached(Exception):
    """Raised in place of the step's first computation: its checks passed."""


def _reach(monkeypatch, module):
    def stop(*a, **k):
        raise _Reached

    monkeypatch.setattr(module.disp, "target", stop)


@pytest.fixture(scope="module")
def states():
    """Per (dtype, frames): both packages' mesh, state and coloring of
    small_beam(2, 1, 1), the state with one frame or none."""
    mesh, V = small_beam(2, 1, 1)
    out = {}
    for dtype in ("float32", "float64"):
        jd = jnp.float32 if dtype == "float32" else jnp.float64
        td = F32 if dtype == "float32" else F64
        jm = mesh if dtype == "float64" else jax.tree.map(
            lambda a: a.astype(jnp.float32)
            if hasattr(a, "dtype") and a.dtype == jnp.float64 else a, mesh)
        jst = jnewton.init_state(jm, JConfig(dtype=dtype), (),
                                 jnp.asarray(V, jd), jnp.zeros(V.shape, jd))
        jgsp = jgs.build_gs_plan(np.asarray(mesh.T), mesh.nv)
        tgsp = tgs.build_gs_plan(np.asarray(mesh.T), mesh.nv, dtype=td,
                                 device="cpu")
        for frames in (False, True):
            if frames:
                jst = jst.replace(contact=jmc.ContactFrames(
                    frames=jnp.zeros((1, 4), jnp.int32),
                    ftype=jnp.full((1,), 3, jnp.int32),
                    fmask=jnp.ones((1,), jd)))
            tm, ts, _ = port(mesh=jm, state=jst, dtype=td)
            out[dtype, frames] = (jm, jst, jgsp, tm, ts, tgsp)
    return out


SOLVERS = [n for n in jfactory.INTERNAL_SOLVERS
           if n not in ("direct", "pcg-ic", "amgcl")]


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("nodal", ["none", "collision", "friction",
                                   "collision without frames"])
@pytest.mark.parametrize("solver", SOLVERS)
def test_refusals(states, monkeypatch, solver, nodal, dtype):
    """The port raises (the same type, and the JAX message for the islands'
    own refusals) exactly where the JAX step raises, for
    rhs_precision='float64' with every on-device solver."""
    frames = nodal in ("collision", "friction")
    jm, jst, jgsp, tm, ts, tgsp = states[dtype, frames]
    variables = () if nodal == "none" else (nodal.split()[0],)
    cfg = dict(h=DT, outer_steps=1, dtype=dtype, solver=solver,
               variables=variables, rhs_precision="float64")
    jcfg, tcfg = JConfig(**cfg), TConfig(**cfg)
    outcome = {}
    for name, run, module in (
            ("jax", lambda: jnewton.newton_step(jm, jcfg, (), jst, None, (),
                                                None, jgsp), jnewton),
            ("port", lambda: tnewton.newton_step(tm, tcfg, (), ts, None, (),
                                                 None, tgsp), tnewton)):
        with monkeypatch.context() as mp:
            _reach(mp, module)
            try:
                run()
            except _Reached:
                outcome[name] = None
            except (NotImplementedError, ValueError) as err:
                outcome[name] = (type(err), str(err))
    j, t = outcome["jax"], outcome["port"]
    assert (j is None) == (t is None), (j, t)
    if j is not None:
        assert j[0] is t[0], (j, t)
        if "rhs_precision" in j[1]:
            assert j[1] == t[1]
    if dtype == "float64":
        # no islands on a float64 state: nothing of theirs is refused
        assert t is None or "rhs_precision" not in t[1]
    elif solver not in tnewton.ISLAND_SOLVERS:
        assert t is not None
