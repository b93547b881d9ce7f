"""Where the nodal barrier's card and CPU steps part: chip_smoke.py phase
32's nodal collision and friction cases on tests/test_collision.py's 2D
drop scene as the JAX tests build it (float64, 2 Simulation.step calls of
3 Newton iterations), each run four ways: the unsharded step on the card
and on the CPU (in this process), and the element-sharded step on 2 card
ranks and on 2 CPU gloo ranks. Every Newton iteration's line search is
logged on every side (parallel/ranks.py LineSearchTrace): the decrement,
the CG count and error, the active frames and least distance, the CCD
bound alpha0, the accepted alpha, and merit(alpha) less the acceptance
threshold, beside the merit's rounding scale eps |E| (the search's own
band is 16 eps |E|). The unsharded runs also log, for each Newton
iteration, the point-edge frames whose closest-point parameter t lies
within 1e-12 of a clamp (0 or 1), with their t: the clamped distance's
Hessian differs on the two sides of a clamp, so a t that one side
computes as 0 and the other as an ulp above it takes two different
Hessians.

Run from the repository root on a machine with a CUDA card:
    python tools/es_floor.py [--itr-tol 1e-11 1e-8] [--out FILE]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
from mixedfem_tpu_torch.collision import distances as dist  # noqa: E402
from mixedfem_tpu_torch.config import SimConfig  # noqa: E402
from mixedfem_tpu_torch.parallel import launch, ranks  # noqa: E402
from mixedfem_tpu_torch.variables import collision as vcol  # noqa: E402

EPS = float(np.finfo(np.float64).eps)


def cases(itr_tol: float):
    """(name, args of ranks.simulation_steps) of phase 32's nodal cases on
    the JAX tests' drop scene (its box's middle vertex over the slab's)
    at CG tolerance itr_tol."""
    out = []
    for name, (fn, args, kw), _, _ in chip_smoke._es_small_cases(
            nodal_shift=0.0):
        if name not in ("nodal collision 2D", "friction 2D"):
            continue
        mesh_np, cfg, x0, v0, steps = args
        cfg = SimConfig(**dict(vars(cfg), itr_tol=itr_tol))
        out.append((name, (mesh_np, cfg, x0, v0, steps), kw))
    return out


def near_clamps(cf, x, within: float = 1e-12):
    """[(frame, t)] of the real point-edge frames whose clamped
    closest-point parameter t lies within `within` of 0 or 1."""
    frames, ftype = cf.real()
    pe = torch.nonzero(ftype == dist.PE).squeeze(1)
    v = x[frames[pe].long()]
    t = dist._pe_param(v[:, 0], v[:, 1], v[:, 2])
    near = torch.minimum(t, 1.0 - t) <= within
    return [(int(f), float(u)) for f, u in zip(pe[near], t[near])]


def unsharded(a, kw, device):
    """ranks.simulation_steps's records of the unsharded step on `device`,
    each line search with the near clamps of its Newton iteration."""
    update, seen = vcol.update, []

    def logged(cf, x, dhat, kappa):
        c = update(cf, x, dhat, kappa)
        seen.append((near_clamps(cf, x), c.H.cpu().numpy()))
        return c

    mesh_np, cfg, x0, v0, steps = a
    sim = ranks.build_simulation(mesh_np, cfg, x0, v0, torch.device(device),
                                 **kw)
    out = []
    vcol.update = logged
    try:
        with ranks.LineSearchTrace() as tr:
            for _ in range(steps):
                sim.step()
                rec = ranks.step_record(sim, sim.mesh.nelem, {})
                rec["line_search"] = tr.take(sim)
                # a contact step re-run with a wider margin updated before
                for r, (c, H) in zip(rec["line_search"],
                                     seen[len(seen) - rec["iterations"]:]):
                    r["clamp"], r["H"] = c, H
                seen.clear()
                out.append(rec)
    finally:
        vcol.update = update
    return out


def line(side, rec) -> str:
    """One Newton iteration's line search, as a log line."""
    m_end = rec["tried"][-1][1] - rec["thresh"] if rec["tried"] else float("nan")
    return (f"    {side:>9}: dec {rec['decrement']:.6e} cg {rec['cg']:3d} "
            f"err {rec['cg_err']:.3e} active {rec['active']} dmin "
            f"{rec['min_distance']:.9e} alpha0 {rec['alpha0']:.17g} alpha "
            f"{rec['alpha']:.6g} accept {rec['accept']:.0f} tries "
            f"{len(rec['tried'])} E {rec['E']:.17g} merit-thresh {m_end:.3e} "
            f"(eps|E| {EPS * abs(rec['E']):.3e})"
            + ("; t at a clamp: " + ", ".join(
                f"frame {f} t {t:.17g}" for f, t in rec["clamp"])
               if rec.get("clamp") else ""))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--itr-tol", type=float, nargs="+", default=[1e-11, 1e-8])
    ap.add_argument("--out", default=None, help="also write the records "
                    "as JSON there")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    print(chip_smoke.card_line(), flush=True)
    dump = {}
    for tol in args.itr_tol:
        for name, a, kw in cases(tol):
            runs = {"card": unsharded(a, kw, "cuda:0"),
                    "cpu": unsharded(a, kw, "cpu")}
            for side, devs in (("card r", ["cuda:0"] * 2), ("cpu r", None)):
                got = launch.run_ranks(ranks.simulation_steps, 2,
                                       devices=devs, args=a,
                                       kwargs=dict(kw, trace=True),
                                       timeout=60, deadline=600)
                for r, g in enumerate(got):
                    runs[f"{side}{r}"] = g
            print(f"{name}, CG tolerance {tol:g}", flush=True)
            for k in range(len(runs["cpu"])):
                ref = runs["cpu"][k]["x"]
                scale = np.abs(ref).max()
                for side, g in runs.items():
                    err = np.abs(g[k]["x"] - ref).max()
                    print(f"  step {k} {side}: |x - x_cpu| {err:.3e} of "
                          f"scale {scale:.3f}; Newton {g[k]['iterations']} "
                          f"CG {g[k]['solver_iters'].tolist()}")
                n = max(len(g[k]["line_search"]) for g in runs.values())
                for i in range(n):
                    print(f"  step {k} Newton {i}:")
                    hg, hc = (runs[s][k]["line_search"][i].get("H")
                              for s in ("card", "cpu"))
                    if hg is not None and hc is not None:
                        print(f"    the barrier's projected Hessians: max "
                              f"|H_card - H_cpu| {np.abs(hg - hc).max():.3e} "
                              f"of max |H| {np.abs(hc).max():.3e}")
                    for side, g in runs.items():
                        ls = g[k]["line_search"]
                        if i < len(ls):
                            print(line(side, ls[i]))
            dump[f"{name} {tol:g}"] = {
                side: [dict(x=r["x"].tolist(), line_search=[
                    {k: v for k, v in ls.items() if k != "H"}
                    for ls in r["line_search"]]) for r in g]
                for side, g in runs.items()}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(dump, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
