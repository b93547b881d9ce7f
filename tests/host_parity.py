"""Shared pieces of the parity tests of the host solve paths and the
vanilla stretch variable (tests/test_torch_host_*.py,
tests/test_torch_vanilla*.py): jitted stand-ins for the JAX functions its
host Newton loop calls op by op, and 3-step trajectories of both
packages' host step held to each other.

The JAX host loop (mixedfem_tpu/optimizer/newton_direct.py) calls the
coefficient updates and the merit eagerly; their Jacobi sweeps run as
`lax.scan`, which JAX compiles anew on every eager call (about 0.5 s
each, 10 s a step on a 360-tet beam). `jitted_jax` swaps those module
attributes for `jax.jit` of the same functions while a test runs them,
which changes nothing but their speed and XLA's fusion (rounding)."""

from __future__ import annotations

import contextlib

import jax
import numpy as np

from torch_parity import close, to_numpy


@contextlib.contextmanager
def jitted_jax():
    from mixedfem_tpu.ops import psd as jpsd
    from mixedfem_tpu.optimizer import newton as jn
    from mixedfem_tpu.variables import collision as jvc
    from mixedfem_tpu.variables import friction as jfr
    from mixedfem_tpu.variables import mixed_collision as jmc
    from mixedfem_tpu.variables import mixed_stretch as jms
    from mixedfem_tpu.variables import stretch as jvs

    patches = [
        (jms, "update", jax.jit(jms.update)),
        (jms, "local_solve", jax.jit(jms.local_solve)),
        (jvs, "update", jax.jit(jvs.update)),
        (jvs, "gradient_at", jax.jit(jvs.gradient_at)),
        (jvs, "energy", jax.jit(jvs.energy)),
        (jn, "_total_energy", jax.jit(jn._total_energy,
                                      static_argnums=(6, 7))),
        (jn, "mixed_contact_merit", jax.jit(
            jn.mixed_contact_merit, static_argnums=(7,),
            static_argnames=("ee_mollifier",))),
        (jmc, "update", jax.jit(jmc.update,
                                static_argnames=("ee_mollifier",))),
        (jvc, "energy", jax.jit(jvc.energy)),
        (jfr, "energy", jax.jit(jfr.energy)),
        # the nodal collision and friction updates stay eager (each eager
        # call of the PSD projection's sweeps compiles anew)
        (jpsd, "psd_fix", jax.jit(jpsd.psd_fix,
                                  static_argnames=("tol", "sweeps"))),
    ]
    saved = [(m, n, getattr(m, n)) for m, n, _ in patches]
    try:
        for m, n, f in patches:
            setattr(m, n, f)
        yield
    finally:
        for m, n, f in saved:
            setattr(m, n, f)


def host_steps(jstep, tstep, jstate, tstate, n=3):
    """n steps of both packages' host loop (jstep and tstep map a state to
    the next; JAX's under jitted_jax): [(JAX state as numpy, port
    state)]."""
    out = []
    with jitted_jax():
        for _ in range(n):
            jstate = jstep(jstate)
            tstate = tstep(tstate)
            out.append((to_numpy(jstate), tstate))
    return out


def compare_host_steps(out, label, band=0.0, atol=1e-8):
    """Positions and stretches to `atol`, equal Newton counts and alphas,
    and linear iteration counts equal or, with `band` > 0, within that
    fraction (at least 1; the margin is printed); the multipliers
    cleared."""
    for k, (js, ts) in enumerate(out):
        close(ts.x, js["x"], rtol=0, atol=atol)
        close(ts.s, js["s"], rtol=0, atol=atol)
        it = ts.stats.iterations
        assert it == int(js["stats"]["iterations"]), (label, k)
        close(ts.stats.alpha, js["stats"]["alpha"], rtol=0, atol=0)
        got = ts.stats.solver_iters[:it].tolist()
        want = np.asarray(js["stats"]["solver_iters"])[:it].tolist()
        for i, (g, w) in enumerate(zip(got, want)):
            if g != w:
                margin = max(1, int(np.ceil(band * w)))
                print(f"{label} step {k} Newton {i}: JAX {w}, port {g}, "
                      f"band {margin if band else 0}")
                assert band and abs(g - w) <= margin, (label, k, i)
        assert not ts.la.any()
