"""Parity of mixedfem_tpu_torch's f64 islands (config.rhs_precision =
'float64' on a float32 state) with mixedfem_tpu's, on the CPU.

The island pieces of one Newton iteration at a fixed float32 state
(newton.island_update, island_local_solve, island_merit: the inertia
gradient, the float64 coefficient update and rhs, the mixed-contact update
and rhs, the local solves, the merit at alpha = 0 and 0.5) against the JAX
step's float64 pieces (mixedfem_tpu/optimizer/newton.py:667-745, :1036-1050,
:1145-1149, :1175-1191) composed from the JAX package's functions on the
float64 copy of the same float32 mesh: the bench's beam, with and without
warm-start rotations, to 1e-12 relative (the drop scene with contact is
tests/test_torch_islands_contact.py's).
On a float64 state rhs_precision = 'float64' is the native run bit for
bit. The stencil-plan blocks of an island step are
tests/test_torch_islands_grid.py's, the refusals
tests/test_torch_islands_refusals.py's, and the float32
small_beam(8, 3, 3) island run tests/test_torch_islands_beam.py's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mixedfem_tpu.integrators import bdf as jbdf
from mixedfem_tpu.mesh import mesh as jmesh
from mixedfem_tpu.optimizer import newton as jnewton
from mixedfem_tpu.variables import displacement as jdisp
from mixedfem_tpu.variables import mixed_collision as jmc
from mixedfem_tpu.variables import mixed_stretch as jms
from mixedfem_tpu_torch.config import SimConfig as TConfig
from mixedfem_tpu_torch.integrators import bdf as tbdf
from mixedfem_tpu_torch.optimizer import newton as tnewton
from mixedfem_tpu_torch.variables import mixed_stretch as tms

from solver_parity import near
from torch_parity import (  # noqa: F401 (one_torch_thread is a fixture)
    beam_arrays, one_torch_thread, port,
)

F32, F64 = torch.float32, torch.float64
DT = 0.02


@pytest.fixture(scope="module", autouse=True)
def _one_thread(one_torch_thread):
    """Every test of this module runs on one torch intra-op thread."""


def _up(tree):
    """The JAX step's `_up`: every floating array of `tree` in float64."""
    return jax.tree.map(
        lambda a: a.astype(jnp.float64)
        if hasattr(a, "dtype") and jnp.issubdtype(a.dtype, jnp.floating)
        else a, tree)


def _jax_pieces(mesh, bdf, x, s, dx, blend, R_prev, cf, contact, dhat,
                kappa):
    """The JAX step's island pieces (its hp branches), on the float64 copies
    of the float32 mesh and BDF state."""
    mesh_hp, bdf_hp = _up(mesh), _up(bdf)
    x64, s64, dx64 = (a.astype(jnp.float64) for a in (x, s, dx))
    g = jdisp.gradient(mesh_hp, bdf_hp, x64, blend=blend)
    c = jms.update(mesh_hp, x64, s64, DT,
                   R_prev=None if R_prev is None else R_prev.astype(jnp.float64))
    b = -g + jms.rhs(mesh_hp, c, s64)
    cc = None
    if cf is not None:
        d, la, act = (a.astype(jnp.float64) for a in contact)
        cc = jmc.update(mesh_hp, cf, x64, d, la, act, dhat, kappa)
        b = b + jmc.rhs(mesh_hp, cf, cc)
    ds, la = jms.local_solve(mesh_hp, c, s64, dx64)
    out = dict(g=g, b=b, G=c.G, Gw=c.Gw, H=c.H, g6=c.g, Sv=c.Sv, R=c.R,
               ds=ds, la=la)
    cact = None
    if cc is not None:
        dd, cla = jmc.local_solve(mesh_hp, cf, cc, dx64)
        cact = cc.active.astype(x.dtype)
        out.update(D=cc.D, Gx=cc.Gx, cH=cc.H, cg=cc.g, dd=dd, cla=cla)
    h2 = bdf.h * bdf.h
    for a in (0.0, 0.5):
        e = jnewton._total_energy(mesh_hp, bdf_hp, h2, x64 + a * dx64,
                                  s64 + a * ds, la, True, False)
        if cc is not None:
            e = e + jnewton.mixed_contact_merit(
                cf, x64 + a * dx64, cc.d + a * dd, cact, cla, dhat, kappa,
                jnp.float64, mesh=mesh_hp)
        out[f"merit{a}"] = e
    return out


_JPIECES = jax.jit(_jax_pieces, static_argnums=(5, 9, 10))


def _port_pieces(tm, tbdf_, x, s, dx, blend, R_prev, cf, contact, dhat,
                 kappa):
    mesh_hp = tnewton._cast(tm, F64)
    bdf_hp = tnewton._cast(tbdf_, F64)
    g, b, c, cc = tnewton.island_update(
        mesh_hp, bdf_hp, x, s, DT, blend=blend, R_prev=R_prev, cf=cf,
        contact=contact, dhat=dhat, kappa=kappa)
    ds, la, dd, cla = tnewton.island_local_solve(mesh_hp, cf, c, cc, s,
                                                 torch.zeros_like(s), dx)
    out = dict(g=g, b=b, G=c.G, Gw=c.Gw, H=c.H, g6=c.g, Sv=c.Sv, R=c.R,
               ds=ds, la=la)
    cact = None
    if cc is not None:
        cact = cc.active.to(x.dtype)
        out.update(D=cc.D, Gx=cc.Gx, cH=cc.H, cg=cc.g, dd=dd, cla=cla)
    merit = tnewton.island_merit(mesh_hp, bdf_hp, tbdf_.h ** 2, x, s, dx,
                                 ds, la, cf=cf, cc=cc, dd=dd, cla=cla,
                                 cact=cact, dhat=dhat, kappa=kappa)
    for a in (0.0, 0.5):
        out[f"merit{a}"] = merit(a)
    return out


def _hold(got, want, n=None):
    """Every piece in float64 and to 1e-12 relative (the contact pieces of
    the port's n real frames against the first n of JAX's)."""
    for k, v in got.items():
        assert v.dtype == F64, k
        w = np.asarray(want[k])
        if k in ("D", "Gx", "cH", "cg", "dd", "cla"):
            w = w[:n]
        near(v, w, rtol=1e-12)


def _beam32(warm):
    V, T, kw, x = beam_arrays(seed=0)
    jm = jmesh.build_mesh_data(V, T, dtype=jnp.float32, **kw)
    tm = port(mesh=jm, dtype=F32)[0]
    rng = np.random.default_rng(4)
    x32 = x.astype(np.float32)
    s = np.asarray(tms.reset(port(mesh=jm)[0], torch.tensor(x))[0])
    s32 = (s + 0.01 * rng.standard_normal(s.shape)).astype(np.float32)
    v32 = (0.3 * rng.standard_normal(V.shape)).astype(np.float32)
    dx = (1e-3 * rng.standard_normal(V.shape) * (~kw["is_fixed"])[:, None]
          ).astype(np.float32)
    R = None
    if warm:
        R = np.asarray(tms.stretch_of_x(tm, torch.tensor(V, dtype=F32))[1])
    return jm, tm, x32, s32, v32, dx, R


@pytest.mark.parametrize("warm", [False, True])
def test_pieces_beam(warm):
    """The bench's beam (360 tets) at a float32 state: the island pieces
    to 1e-12 relative (a warm-start seed R_prev: the rest rotations)."""
    jm, tm, x, s, v, dx, R = _beam32(warm)
    jb = jbdf.bdf_init("BDF1", jnp.asarray(x), jnp.asarray(v), DT)
    tb = tbdf.bdf_init("BDF1", torch.tensor(x), torch.tensor(v), DT)
    want = _JPIECES(jm, jb, jnp.asarray(x), jnp.asarray(s), jnp.asarray(dx),
                    0.5, None if R is None else jnp.asarray(R), None, None,
                    0.0, 0.0)
    got = _port_pieces(tm, tb, torch.tensor(x), torch.tensor(s),
                       torch.tensor(dx), 0.5,
                       None if R is None else torch.tensor(R), None, None,
                       0.0, 0.0)
    _hold(got, want)
    assert float(got["merit0.5"]) != float(got["merit0.0"])


def test_float64_state_is_native_bit_for_bit():
    """rhs_precision='float64' on a float64 state runs no island: 2 steps
    of the beam equal the native run bit for bit."""
    V, T, kw, _ = beam_arrays()
    jm = jmesh.build_mesh_data(V, T, dtype=jnp.float64, **kw)
    tm = port(mesh=jm)[0]
    out = {}
    for rp in ("native", "float64"):
        cfg = TConfig(h=DT, outer_steps=3, newton_tol=0.0, itr_tol=1e-4,
                      max_iterative_solver_iters=500, rhs_precision=rp,
                      mixed_variables=("mixed-stretch",))
        x0 = torch.tensor(V)
        st = tnewton.init_state(tm, cfg, (), x0, torch.zeros_like(x0))
        for _ in range(2):
            st = tnewton.newton_step(tm, cfg, (), st)
        out[rp] = st
    a, b = out["native"], out["float64"]
    for f in ("x", "s", "la"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    for f in ("energy", "decrement", "alpha", "solver_iters"):
        assert torch.equal(getattr(a.stats, f), getattr(b.stats, f)), f
    assert a.stats.iterations == b.stats.iterations
