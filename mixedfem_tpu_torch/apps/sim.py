"""Headless simulator CLI of the port (counterpart of apps/sim.py): load a
scene, step it, print the per-step stats table, export frames.

    python -m mixedfem_tpu_torch.apps.sim <scene.json> --dim 3 [-n STEPS]
        [--out DIR] [--export-obj] [--save-substeps] [--dtype float64]
        [--timing-csv PATH] [--solver NAME] [--device cuda|cpu]

The scene runs on the card unless --device cpu is given.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("scene")
    ap.add_argument("--dim", type=int, default=3, choices=(2, 3))
    ap.add_argument("-n", "--steps", type=int, default=None)
    ap.add_argument("--out", default="output")
    ap.add_argument("--export-obj", action="store_true")
    ap.add_argument("--save-substeps", action="store_true",
                    help="export sim_x0_%%04d.dmat / sim_v_%%04d.dmat per step")
    ap.add_argument("--dtype", default=None)
    ap.add_argument("--timing-csv", default=None,
                    help="append per-step wall-clock rows (timing.csv format)")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default cuda)")
    ap.add_argument("--solver", default=None,
                    help="override the scene's linear_solver: a reference "
                         "factory name or an internal path name of "
                         "solvers/factory.py (the host paths direct, "
                         "pcg-ic and amgcl among them)")
    args = ap.parse_args(argv)

    from mixedfem_tpu_torch.io import mesh_io
    from mixedfem_tpu_torch.io.scene import load_scene
    from mixedfem_tpu_torch.utils.timer import OptimizerData

    overrides = (
        {"linear_solver": args.solver} if args.solver is not None else None
    )
    sim = load_scene(args.scene, dim=args.dim, dtype=args.dtype,
                     overrides=overrides, device=args.device)
    n = args.steps if args.steps is not None else sim.config.timesteps
    os.makedirs(args.out, exist_ok=True)

    data = OptimizerData()
    F_srf = sim.mesh.F_srf.cpu().numpy()
    sync = (torch.cuda.synchronize if sim.mesh.device.type == "cuda"
            else (lambda: None))

    for step in range(n):
        data.timer.start("step")
        sim.step()
        sync()
        data.timer.stop("step")
        data.add_step_stats(sim.state.stats)
        if args.timing_csv:
            data.timer.write_csv(args.timing_csv, step)
            data.timer.clear()
        if sim.config.show_data:
            print(f"--- step {step}")
            data.print_data(sim.config.show_timing)
            data.clear()

        V = sim.state.x.cpu().numpy()
        if args.save_substeps:
            mesh_io.write_dmat(os.path.join(args.out, f"sim_x0_{step:04d}.dmat"), V)
            v = sim.state.bdf.v_hist[0].cpu().numpy()
            mesh_io.write_dmat(os.path.join(args.out, f"sim_v_{step:04d}.dmat"), v)
        if args.export_obj:
            for i, (Vr, Fr) in enumerate(sim.skinned_surfaces()):
                mesh_io.write_obj(
                    os.path.join(args.out, f"skin{i}_{step:04d}.obj"), Vr, Fr
                )
            mesh_io.write_obj(
                os.path.join(args.out, f"frame_{step:04d}.obj"), V, F_srf
            )

    X = sim.state.x.cpu().numpy()
    print("final positions bbox:", np.min(X, axis=0), np.max(X, axis=0))
    return sim


if __name__ == "__main__":
    main()
