"""Per-step stats table and wall-clock timers (port of
mixedfem_tpu/utils/timer.py).

OptimizerData accumulates named scalar series per step (Iteration,
Energy, Energy res, Decrement, alpha, Solver iters, Solver error) and
prints them as a box-drawn table; Timer keeps (tag, key) wall-clock
accumulators and exports them as timing.csv rows
'Step,Tag,Key,Total,Average,Num Measurements'.
"""

from __future__ import annotations

import collections
import csv
import os
import time
from typing import Dict, List


class Timer:
    """Hierarchical (tag -> key) wall-clock accumulator."""

    def __init__(self):
        self._acc: Dict[tuple, List[float]] = collections.defaultdict(list)
        self._open: Dict[tuple, float] = {}

    def start(self, key: str, tag: str = ""):
        self._open[(tag, key)] = time.perf_counter()

    def stop(self, key: str, tag: str = ""):
        t0 = self._open.pop((tag, key), None)
        if t0 is not None:
            self._acc[(tag, key)].append(time.perf_counter() - t0)

    def rows(self):
        out = []
        for (tag, key), vals in sorted(self._acc.items()):
            total = sum(vals)
            out.append(dict(tag=tag, key=key, total_s=total,
                            avg_ms=1e3 * total / max(len(vals), 1),
                            count=len(vals)))
        return out

    def write_csv(self, path: str, step: int):
        """Append timing.csv rows (Step,Tag,Key,Total,Average,Num)."""
        new = not os.path.exists(path)
        with open(path, "a", newline="") as f:
            w = csv.writer(f)
            if new:
                w.writerow(["Step", "Tag", "Key", "Total", "Average",
                            "Num Measurements"])
            for r in self.rows():
                w.writerow([step, r["tag"], r["key"], r["total_s"],
                            r["avg_ms"], r["count"]])

    def clear(self):
        self._acc.clear()
        self._open.clear()


class OptimizerData:
    """Per-step named scalar series and their table."""

    def __init__(self):
        self.series: Dict[str, List[float]] = collections.OrderedDict()
        self.timer = Timer()

    def add(self, name: str, value):
        self.series.setdefault(name, []).append(float(value))

    def add_step_stats(self, stats) -> None:
        """Ingest a step's StepStats (one row per Newton iteration)."""
        it = int(stats.iterations)
        cols = {
            "Energy": stats.energy, "Energy res": stats.energy_res,
            "Decrement": stats.decrement, "alpha ": stats.alpha,
            "Solver iters": stats.solver_iters,
            "Solver error": stats.solver_error,
        }
        vals = {k: v[:it].tolist() for k, v in cols.items()}
        for i in range(it):
            self.add(" Iteration", i + 1)
            for k in cols:
                self.add(k, vals[k][i])

    def print_data(self, show_timing: bool = False):
        names = list(self.series.keys())
        if not names:
            return
        n = max(len(v) for v in self.series.values())
        widths = [max(len(k) + 2, 12) for k in names]
        print("┌" + "┬".join("─" * w for w in widths) + "┐")
        print("│" + "│".join(k.center(w) for k, w in zip(names, widths)) + "│")
        print("├" + "┼".join("─" * w for w in widths) + "┤")
        for i in range(n):
            cells = []
            for k, w in zip(names, widths):
                v = self.series[k]
                cells.append((f"{v[i]:.5g}" if i < len(v) else "").center(w))
            print("│" + "│".join(cells) + "│")
        print("└" + "┴".join("─" * w for w in widths) + "┘")
        if show_timing:
            for r in self.timer.rows():
                print(f"  [{r['tag']}/{r['key']}] total {r['total_s']:.3f}s "
                      f"avg {r['avg_ms']:.2f}ms n={r['count']}")

    def clear(self):
        self.series.clear()
