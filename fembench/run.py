"""Run one cell of the benchmark once, from the root of a checkout:

    python3 -m fembench.run --workload NAME --seed N --seconds S --trace 0|1

The last line of standard output is the result: correct, attempted,
failed, metrics (the cell's end-to-end metrics, or with --trace 1 its
per-layer ones), device (and busy_s, window_s, breakdown when traced), and
last the numbers compared with their limits, which also end standard
error. Exits non-zero with no result when no card (or too few) is
present, and when a module of JAX or of the JAX package is loaded.
"""

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    root = os.getcwd()
    # the build and kernel caches: fixed directories inside the checkout
    cache = os.path.join(root, "fembench", ".cache")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_extensions")

    import torch

    from fembench.harness import Cell, forbidden_modules, run_cell

    cell = Cell.find(root, args.workload)
    chips = cell.workload["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"fembench: the cell needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count()} available", file=sys.stderr)
        return 2
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                   t_start=_T0)
    # last, once the window, the comparison and every reader have run
    found = forbidden_modules()
    if found:
        print(f"fembench: modules of JAX or of the JAX package are loaded: "
              f"{found}", file=sys.stderr)
        return 3
    for k, v in out["checks"].items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
