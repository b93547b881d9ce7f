"""A dry run of the three sharded steps over n ranks (the port of
__graft_entry__.py dryrun_multichip).

One step each, on tiny shapes, float32, asserting finite values and
movement: (1) the element-sharded step (parallel/sharding.py: newton_step
with a comm) on a 4 x 2 x 2 beam, (2) the vertex-partitioned step with the
two-level coarse space (parallel/vp_step.py) on a 16 x 2 x 2 beam, (3) the
sharded stencil step with the grid coarse space (parallel/stencil_shard.py)
on the 16 x 2 x 2 box grid. The n ranks start through parallel/launch.py
and build their data themselves:

    python -m mixedfem_tpu_torch.parallel.dryrun 4 --device cpu
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from mixedfem_tpu_torch.config import SimConfig, enu_to_lame
from mixedfem_tpu_torch.mesh import generators, mesh as meshmod
from mixedfem_tpu_torch.optimizer import newton
from mixedfem_tpu_torch.parallel import launch
from mixedfem_tpu_torch.parallel import sharding
from mixedfem_tpu_torch.parallel import stencil_shard as ss
from mixedfem_tpu_torch.parallel import vp_step as vp
from mixedfem_tpu_torch.solvers import coarse as coarsemod


def _build_sim(nx, ny, nz, device, outer_steps=2, grid=False, **over):
    """__graft_entry__.py _build_sim on the port, float32: the SNH beam
    (2, 0.5, 0.5), x = 0 pinned, gravity; with `grid` the elements in the
    stencil plan's cell-major order. (mesh, config, state, plan)."""
    from mixedfem_tpu_torch.ops import stencil as stmod

    V, T = generators.box_tet_mesh(nx, ny, nz, size=(2.0, 0.5, 0.5))
    plan = None
    if grid:
        plan, perm = stmod.build_stencil_plan(T, len(V), (nx + 1, ny + 1, nz + 1),
                                              device=device)
        T = T[perm]
    la, mu = enu_to_lame(1e6, 0.45)
    mesh = meshmod.build_mesh_data(
        V, T, density=np.full(len(T), 1000.0), mu=np.full(len(T), mu),
        lam=np.full(len(T), la), model_id=np.zeros(len(T), int),
        models=("Stable-Neohookean",), is_fixed=V[:, 0] < 1e-9,
        ext_force=np.tile(np.array([0.0, -9.8, 0.0]), (len(V), 1)),
        dtype=torch.float32, device=device)
    config = SimConfig(h=0.02, outer_steps=outer_steps,
                       max_iterative_solver_iters=100, itr_tol=1e-4,
                       dtype="float32", **over)
    x0 = torch.tensor(V, dtype=torch.float32, device=device)
    state = newton.init_state(mesh, config, (), x0, torch.zeros_like(x0))
    return mesh, config, state, plan


def _moved(x, x0, what):
    if not bool(torch.isfinite(x).all()):
        raise AssertionError(f"{what} non-finite")
    if not float((x - x0).abs().max()) > 0.0:
        raise AssertionError(f"{what} did not move")
    return float((x - x0).abs().max())


def dryrun_rank(comm) -> dict:
    """The three sharded steps of this rank; the largest displacement of
    each (the same on every rank)."""
    dev = comm.device
    out = {}
    # (1) the element-sharded step
    mesh, config, state, _ = _build_sim(4, 2, 2, dev)
    lmesh, lstate, _ = sharding.shard_simulation(mesh, state, comm)
    st = newton.newton_step(lmesh, config, (), lstate, comm=comm)
    out["element_sharded"] = _moved(st.x, state.x, "element-sharded step")

    # (2) the vertex-partitioned step with the two-level coarse space
    mesh, config, state, _ = _build_sim(16, 2, 2, dev,
                                        mixed_variables=("mixed-stretch",))
    cs = coarsemod.build_coarse_space(
        mesh.V0.cpu().numpy(), mesh.T.cpu().numpy(),
        mesh.free_mask.cpu().numpy() == 0, target_size=24,
        dtype=torch.float32, device=dev)
    plan = vp.build_vp_plan(mesh, comm.size, coarse=cs)
    rp = vp.rank_vp_plan(plan, comm.rank, dev)
    rows = slice(comm.rank * plan.nb, (comm.rank + 1) * plan.nb)
    xp = vp.pad_vertex_field(plan, state.x)[rows]
    s0, la0 = (torch.as_tensor(a[comm.rank], device=dev).float()
               for a in vp.init_vp_state(plan))
    x1, _v, _s, _la, it, _dec, _cg = vp.vp_newton_step(
        rp, config, comm, xp, torch.zeros_like(xp), s0, la0)
    if it < 1:
        raise AssertionError("vertex-partitioned step took no iteration")
    x_all = torch.cat(comm.all_gather(x1))[: mesh.nv]
    out["vertex_partitioned"] = _moved(x_all, state.x,
                                       "vertex-partitioned step")

    # (3) the sharded stencil step with the grid coarse space
    mesh, config, state, gplan = _build_sim(16, 2, 2, dev, grid=True,
                                            mixed_variables=("mixed-stretch",))
    cs3 = coarsemod.build_coarse_space_grid(
        mesh.V0.cpu().numpy(), mesh.T.cpu().numpy(),
        mesh.free_mask.cpu().numpy() == 0, (gplan.NI, gplan.NJ, gplan.NK),
        block=2, dtype=torch.float32, device=dev)
    sp = ss.build_shard_plan(gplan, comm.size)
    st3 = ss.sharded_newton_step(
        sp, comm, ss.rank_slab(sp, mesh, comm.rank, cs3), mesh, config, state,
        coarse=cs3)
    out["stencil_sharded"] = _moved(st3.x, state.x, "sharded stencil step")
    return out


def dryrun_multichip(n: int, device: str = "cpu", backend: str = "gloo"):
    """The three sharded steps on n ranks: on the CPU, or, with device
    'cuda', on the visible cards in turn (several ranks a card over gloo,
    staged through the host). Raises if a rank fails or a step is not
    finite or does not move; returns rank 0's displacements."""
    if device == "cuda":
        count = torch.cuda.device_count()
        if count == 0:
            raise RuntimeError("no CUDA device is available")
        devices = [f"cuda:{r % count}" for r in range(n)]
    else:
        devices = [device] * n
    return launch.run_ranks(dryrun_rank, n, backend=backend,
                            devices=devices)[0]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n", type=int)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--backend", default="gloo")
    args = ap.parse_args()
    print(dryrun_multichip(args.n, args.device, args.backend))


if __name__ == "__main__":
    main()
