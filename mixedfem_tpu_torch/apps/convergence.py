"""Convergence harness of the port (counterpart of apps/convergence.py):
run a scene's mixed Newton solver for N steps and record, at every Newton
iterate, the norm of the vanilla-FEM gradient there (the reference's
apps/convergence.cpp); write a (steps x max Newton iterations) matrix as
a .dmat, each row padded with its last value.

    python -m mixedfem_tpu_torch.apps.convergence <scene.json> [--dim 2|3]
        [-n STEPS] [--out output/convergence.dmat] [--dtype float64]
        [--sweep-tol | --sweep-dhat] [--device cuda|cpu]

--sweep-tol repeats the run at 15 iterative-solver tolerances from 1e-1
to 1e-7 (the reference's convergence_iterative.cpp), --sweep-dhat at 8
values of dhat from 1e-2 to 1e-4 (convergence_collision.cpp), each into
<out>_tolNN.dmat or <out>_dhatNN.dmat. The scene runs on the card unless
--device cpu is given.
"""

from __future__ import annotations

import argparse
import dataclasses
import os

import numpy as np


def run_convergence(scene, dim, steps, out_path, dtype=None, itr_tol=None,
                    dhat=None, device="cuda"):
    """Step the scene `steps` times with record_vanilla_gradient on and
    write the padded gradient-norm matrix to `out_path`; returns it."""
    from mixedfem_tpu_torch.io import mesh_io
    from mixedfem_tpu_torch.io.scene import load_scene

    sim = load_scene(scene, dim=dim, dtype=dtype, device=device)
    cfg = dataclasses.replace(sim.config, record_vanilla_gradient=True)
    if itr_tol is not None:
        cfg = dataclasses.replace(cfg, itr_tol=itr_tol)
    if dhat is not None:
        cfg = dataclasses.replace(cfg, dhat=dhat)
    sim.config = cfg

    M = cfg.outer_steps
    rows = []
    for step in range(steps):
        sim.step()
        it = sim.state.stats.iterations
        vg = sim.state.stats.vanilla_grad[:it].cpu().numpy()
        row = np.empty(M)
        row[:it] = vg
        row[it:] = vg[-1] if it else 0.0
        rows.append(row)
        print(f"step {step}: iters={it} grad_norms={vg}")
    Mx = np.stack(rows)
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    mesh_io.write_dmat(out_path, Mx)
    print("wrote", out_path, Mx.shape)
    return Mx


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("scene")
    ap.add_argument("--dim", type=int, default=2, choices=(2, 3))
    ap.add_argument("-n", "--steps", type=int, default=10)
    ap.add_argument("--out", default="output/convergence.dmat")
    ap.add_argument("--dtype", default=None)
    ap.add_argument("--sweep-tol", action="store_true")
    ap.add_argument("--sweep-dhat", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default cuda)")
    args = ap.parse_args(argv)

    common = dict(dtype=args.dtype, device=args.device)
    if args.sweep_tol:
        for i, tol in enumerate(np.logspace(-1, -7, 15)):
            out = args.out.replace(".dmat", f"_tol{i:02d}.dmat")
            run_convergence(args.scene, args.dim, args.steps, out,
                            itr_tol=float(tol), **common)
    elif args.sweep_dhat:
        for i, dh in enumerate(np.logspace(-2, -4, 8)):
            out = args.out.replace(".dmat", f"_dhat{i:02d}.dmat")
            run_convergence(args.scene, args.dim, args.steps, out,
                            dhat=float(dh), **common)
    else:
        run_convergence(args.scene, args.dim, args.steps, args.out, **common)


if __name__ == "__main__":
    main()
