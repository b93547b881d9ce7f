"""Shared helpers of the tests/test_torch_parallel_es_*.py files: the
element-sharded Simulation.step of both packages on the same inputs.

The JAX side is mixedfem_tpu/parallel/sharding.py's shard_simulation on D
virtual CPU devices followed by the unchanged Simulation.step (newton_step
or newton_step_direct, with the broadphase for contact); the port's is
D gloo ranks on the CPU, each running mixedfem_tpu_torch/parallel/
ranks.py:simulation_steps (sharding.shard_scene, then Simulation.step
with the rank's comm). The two run side by side (parallel_parity.
alongside). Each step's record holds the positions, the stretch (whole),
the Newton and Krylov counts, the merit at the base point of every Newton
iteration and the real contact frames."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from mixedfem_tpu.config import SimConfig as JConfig
from mixedfem_tpu.io.scene import Simulation as JSimulation
from mixedfem_tpu.optimizer import newton as jnewton
from mixedfem_tpu.parallel import sharding as jsharding
from mixedfem_tpu_torch.config import SimConfig as TConfig
from mixedfem_tpu_torch.parallel import launch, ranks

from parallel_parity import alongside, check_steps
from torch_parity import to_numpy


def jax_frames(state) -> np.ndarray:
    """The real candidate frames of a JAX state, (n, 4)."""
    cf = state.contact
    n = int((np.asarray(cf.fmask) > 0).sum())
    return np.asarray(cf.frames)[:n]


def jax_sim_steps(mesh, config, x0, v0, D, steps, press=(), gs_plan=None,
                  jit=True):
    """`steps` Simulation.step calls of the JAX package from (x0, v0), the
    mesh and the state sharded over D virtual devices (D = 0: one device,
    unsharded). `press` is [(PressSpec, PressState)]; `jit` jits the
    on-device newton_step (the host solvers' step is a host loop). Per
    step a record as ranks.step_record makes it."""
    E = mesh.T.shape[0]
    st = jnewton.init_state(mesh, config, (), jnp.asarray(x0),
                            jnp.asarray(v0),
                            press_states=tuple(p for _, p in press))
    sim = JSimulation(mesh=mesh, config=config, bc_specs=(), state=st,
                      dim=mesh.V0.shape[1], obj_slices=[],
                      press_specs=tuple(s for s, _ in press), gs_plan=gs_plan)
    if D:
        sim.mesh, sim.state = jsharding.shard_simulation(
            sim.mesh, sim.state, jsharding.make_device_mesh(D))
    if jit:
        # Simulation.step with its newton_step jitted: one compile (per
        # contact capacity) instead of one per operation
        step = jax.jit(lambda m, st: jnewton.newton_step(
            m, config, (), st, press_specs=sim.press_specs, gs_plan=gs_plan))
        sim._one_step = lambda: step(sim.mesh, sim.state)
    out = []
    for _ in range(steps):
        sim.step()
        s = sim.state
        it = int(s.stats.iterations)
        out.append(dict(
            x=np.asarray(s.x), s=np.asarray(s.s)[:E], iterations=it,
            solver_iters=np.asarray(s.stats.solver_iters)[:it],
            energy=np.asarray(s.stats.energy)[:it],
            vanilla_grad=np.asarray(s.stats.vanilla_grad)[:it],
            frames=jax_frames(s)))
    return out


def port_ranks(mesh, cfg: dict, x0, v0, D, steps, **build):
    """The port's element-sharded Simulation.step on D gloo ranks (a
    run_ranks call): every rank's records."""
    return launch.run_ranks(ranks.simulation_steps, D, args=(
        to_numpy(mesh), TConfig(**cfg), np.asarray(x0), np.asarray(v0),
        steps), kwargs=build)


def power_start(shape):
    """The JAX step's power-iteration start vector (solvers/laplacian.py),
    for the port's pcg-laplacian and pcg-dualascent."""
    return np.asarray(jax.random.normal(jax.random.PRNGKey(0), shape,
                                        jnp.float64))


def run_both(mesh, cfg: dict, x0, v0, D, steps=2, press=(), gs_plan=None,
             also=None, **build):
    """(the port's ranks' records, JAX's sharded records), side by side;
    with `also` (a function of no arguments) ((the ranks' records, also()),
    JAX's records), also() run on the port's side after the ranks."""
    jcfg = JConfig(**cfg)
    jit = cfg.get("solver", "pcg") not in ("direct", "pcg-ic", "amgcl")
    port_press = tuple((to_numpy(s), to_numpy(p)) for s, p in press)

    def port():
        got = port_ranks(mesh, cfg, x0, v0, D, steps, press=port_press,
                         gs=gs_plan is not None, **build)
        return got if also is None else (got, also())

    return alongside(
        port,
        lambda: jax_sim_steps(mesh, jcfg, x0, v0, D, steps, press, gs_plan,
                              jit))


def check(got, want, tol=1e-8, band=0):
    """parallel_parity.check_steps (positions to `tol` of scale, Newton
    counts equal, Krylov counts within `band` outside the last Newton
    iteration) on every rank, the stretch to `tol` of its scale, and every
    rank's frames equal to JAX's."""
    check_steps(got, [(w["x"], w["iterations"], w["solver_iters"])
                      for w in want], tol, band)
    for k, w in enumerate(want):
        s_scale = max(np.abs(w["s"]).max(), 1e-12)
        for rank_runs in got:
            g = rank_runs[k]
            assert np.abs(g["s"] - w["s"]).max() / s_scale < tol, k
            np.testing.assert_array_equal(g["frames"], w["frames"])


def single_device(mesh, cfg: dict, x0, v0, steps=2, **build):
    """The port's unsharded Simulation.step on the CPU from the same host
    values: per step ranks.step_record's dict."""
    return ranks.simulation_steps(None, to_numpy(mesh), TConfig(**cfg),
                                  np.asarray(x0), np.asarray(v0), steps,
                                  device="cpu", **build)
