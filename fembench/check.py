"""The comparison that decides `correct`: what the timed path produced,
judged by the plain reference in float64.

The window replays episodes from the loaded state; a sample of them,
drawn from the seed, keeps each step's answer. Which fields of the
program's state are kept, which numbers are read from them and how, is
the configuration's judge: the module fembench/reference/<name>.py that
its `reference` key names. A judge has

    NUMBERS                      the compared numbers' names; the cell's
                                 file (fembench/workloads/<cell>.json)
                                 gives each a limit
    KEEP                         {state field: "vertex" | "element"}:
                                 what a step keeps; "element" rows are
                                 handed over in the file's element order
    prepare(config, traffic, meshes, device, dtype=float64) -> scene
    readings(scene, steps) -> {number: value} of one episode from rest
    failed(state, T) -> 0-d int32 on the device, no sync: 1 where the
                                 step's answer is unsound (T: the file's
                                 elements)
    control_episode(scene, steps) -> the reference's own steps, in the
                                 scene's dtype, in the program's place

and imports nothing of the program. The program's element rows are put in
the file's order through the program's own element table, matched to the
file's elements by their corners."""

from __future__ import annotations

from types import ModuleType
from typing import Optional

import numpy as np
import torch

from fembench import module_at


def judge_of(root: str, config: dict) -> ModuleType:
    """The judge module that the configuration's `reference` key names."""
    return module_at(root, "reference", config["reference"])


class EpisodeSample:
    """A reservoir of `k` whole episodes drawn uniformly from the window's
    (the last, partial one included), by the seed's generator."""

    def __init__(self, k: int, seed: int):
        self.k = k
        self.rng = np.random.default_rng([seed, 7])
        self.kept: list[list] = []
        self.seen = 0

    def offer(self, episode: list) -> None:
        self.seen += 1
        if len(self.kept) < self.k:
            self.kept.append(episode)
            return
        j = int(self.rng.integers(self.seen))
        if j < self.k:
            self.kept[j] = episode


def file_rows(T_prog: np.ndarray, T_file: np.ndarray) -> Optional[np.ndarray]:
    """perm with T_prog[perm[i]] the file's element i (corners as sets),
    or None where the program's elements are not the file's in another
    order."""
    a, b = np.sort(T_prog, axis=1), np.sort(T_file, axis=1)
    if a.shape != b.shape:
        return None
    ia, ib = np.lexsort(a.T[::-1]), np.lexsort(b.T[::-1])
    if not np.array_equal(a[ia], b[ib]):
        return None
    perm = np.empty(len(b), np.int64)
    perm[ib] = ia
    return perm


def in_file_order(steps: list[dict], keep: dict, perm) -> list[dict]:
    """The kept steps with their "element" fields' rows in the file's
    order (perm from file_rows)."""
    return [{k: v[torch.as_tensor(perm, device=v.device)]
             if keep[k] == "element" else v for k, v in step.items()}
            for step in steps]


def judge(readings: list[dict], limits: dict,
          numbers: tuple) -> tuple[bool, dict]:
    """Whether every number is within its limit, and {name: {value,
    limit}} with each number the largest over the episodes (inf where none
    was read)."""
    shown, ok = {}, bool(readings)
    for k in numbers:
        v = max((r[k] for r in readings), default=float("inf"))
        shown[k] = {"value": v, "limit": limits[k]}
        ok = ok and v <= limits[k]
    return ok, shown
