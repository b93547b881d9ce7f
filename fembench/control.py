"""The readings that a cell's limits are set from, on the chip at the
cell's own size:

    python3 -m fembench.control --workload NAME --program-seeds S... \
        --control-seeds S... [--control-dtype bfloat16]

--program-seeds: one episode of the program a seed, through the same
harness as a run (load, warm-up, one episode, the comparison): the lower
readings. --control-seeds: the control, the plain reference's own steps
(the configuration's judge, fembench/reference/<name>.py) put in the
program's place and computed in the precision below the configuration's
(float32 -> bfloat16): the upper readings. Each line is a JSON object;
nothing here is run by the benchmark's own runs.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

from fembench import check, scenes
from fembench.harness import Cell, run_cell

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
          "float64": torch.float64}


def control_readings(cell: Cell, seed: int, dtype, device) -> dict:
    """The readings of the reference's own steps (the configuration's
    judge, fembench/check.py), in `dtype`, in the program's place: one
    episode of the cell's traffic from `seed`."""
    judge = check.judge_of(cell.root, cell.config)
    _, meshes, _ = scenes.write_scene(cell.root, cell.config, cell.traffic,
                                      cell.workload["name"], seed)
    low = judge.prepare(cell.config, cell.traffic, meshes, device,
                        dtype=dtype)
    steps = judge.control_episode(low, int(cell.traffic["episode_steps"]))
    del low
    ref = judge.prepare(cell.config, cell.traffic, meshes, device)
    return judge.readings(ref, steps)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--program-seeds", type=int, nargs="*", default=[])
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--control-dtype", default="bfloat16", choices=DTYPES)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    cell = Cell.find(os.getcwd(), args.workload)
    for seed in args.program_seeds:
        t0 = time.perf_counter()
        out = run_cell(cell, seed, 0.0, False, device=args.device)
        print(json.dumps({"side": "program", "seed": seed,
                          "correct": out["correct"],
                          "readings": {k: v["value"] for k, v in
                                       out["checks"].items()},
                          "seconds": time.perf_counter() - t0}), flush=True)
    for seed in args.control_seeds:
        t0 = time.perf_counter()
        try:
            r = control_readings(cell, seed, DTYPES[args.control_dtype],
                                 torch.device(args.device))
        except RuntimeError as err:  # a control that crashes has failed
            r = {"error": str(err)[:500]}
        print(json.dumps({"side": f"control-{args.control_dtype}",
                          "seed": seed, "readings": r,
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
