"""mixedfem_tpu_torch/parallel/vp_step.py with mixed IPC contact (2 gloo
ranks on the CPU) against mixedfem_tpu/parallel/vp_step.py on 2 virtual
CPU devices, float64: tests/test_vp_contact.py's drop mesh (a banded beam
and a box falling onto its middle, frames that span both objects' id
ranges), candidates within dhat rebuilt from the positions before each of
2 steps by each package's broadphase. Positions to 1e-8 of scale, Newton counts
equal, CG totals within 10% (contact Krylov counts are rounding's to
decide), some frames active."""

import jax.numpy as jnp
import numpy as np
import pytest

from mixedfem_tpu.config import SimConfig as JConfig
from mixedfem_tpu.parallel import vp_step as jvp
from mixedfem_tpu_torch import convert
from mixedfem_tpu_torch.config import SimConfig as TConfig
from mixedfem_tpu_torch.parallel import launch, ranks

from parallel_parity import (alongside, check, jax_vp_steps, plan_fields,
                             vp_call)
from test_vp_contact import _drop_mesh
from torch_parity import one_torch_thread  # noqa: F401 (a fixture)

D = 2
# the candidates' margin: dhat (tests/test_vp_contact.py takes 0.1, whose
# 18k candidates a step cost the CPU ranks most of a minute)
MARGIN = 0.05
CFG = dict(h=0.01, outer_steps=4, itr_tol=1e-11,
           max_iterative_solver_iters=20000,
           mixed_variables=("mixed-stretch", "mixed-collision"),
           dtype="float64", dhat=0.05, kappa=100.0)


@pytest.fixture(scope="module", autouse=True)
def _one_thread(one_torch_thread):
    """Every test of this module runs on one torch intra-op thread."""


def fixed_capacity(jm, x, cap=8192):
    """tests/test_vp_contact.py's _frames at positions x with the margin
    MARGIN, padded to one capacity for every step, so that the JAX step
    compiles once."""
    from mixedfem_tpu.collision import broadphase as bp
    from mixedfem_tpu.variables.mixed_collision import ContactFrames

    F_srf, E_srf = np.asarray(jm.F_srf), np.asarray(jm.E_srf)
    frames, types = bp.candidates_3d(np.asarray(x), F_srf, E_srf,
                                     np.unique(F_srf.reshape(-1)), MARGIN)
    f, t, m = bp.pad_candidates(frames, types, cap)
    return ContactFrames(frames=jnp.asarray(f), ftype=jnp.asarray(t),
                         fmask=jnp.asarray(m, jnp.float64))


def test_vp_contact_matches_jax():
    jm, V, nbeam = _drop_mesh()
    v0 = np.zeros_like(V)
    v0[nbeam:, 2] = -1.0
    plan = jvp.build_vp_plan(jm, D)
    nv = jm.nv
    contact = dict(F_srf=np.asarray(jm.F_srf), E_srf=np.asarray(jm.E_srf),
                   margin=MARGIN, nv=nv)
    call = vp_call(convert.vp_plan_from_numpy(plan_fields(plan)),
                   TConfig(**CFG), V, v0, contact=contact)
    got, want = alongside(
        lambda: launch.run_ranks(ranks.sequence, D, args=([call],)),
        lambda: jax_vp_steps(plan, JConfig(**CFG), jnp.asarray(V),
                             jnp.asarray(v0), 2,
                             frames=lambda x: fixed_capacity(jm, x[:nv])))
    got = [g[0] for g in got]
    check(got, want, nv, cg_band=0.10)
    assert max(o["frames"] for o in got[0]) > 0
