"""One run of one cell: generate the scene from the seed, load it through
mixedfem_tpu_torch.io.scene.load_scene, warm up, replay episodes of
Simulation.step for the window, judge a sample of them against the plain
reference, and read the cell's metrics through their readers.

Everything that belongs to one configuration, traffic mix, cell or metric
is a file found by its name in BENCHMARK.json:

    fembench/configs/<config>.json    scene, mesh recipe, precision, judge
    fembench/traffic/<traffic>.json   step length, episode length
    fembench/workloads/<cell>.json    the limits of the comparison
    fembench/metrics/<metric>.py      read(ctx) -> number or None
    fembench/reference/<judge>.py     the comparison (fembench/check.py)
    fembench/meshes/<recipe>.py       an object's mesh (fembench/scenes.py)

so a cell, a configuration or a metric is added by adding files and
entries, and nothing here branches on a cell.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import os
import sys
import time
from typing import Optional

import numpy as np
import torch

from fembench import check, module_at, scenes, trace

# top-level module names that no run may hold once its window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "mixedfem_tpu")
# whole episodes that the comparison keeps, drawn from the seed
KEPT_EPISODES = 2


def read_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    """A cell's entries and files, resolved from BENCHMARK.json by name."""

    root: str
    bench: dict
    workload: dict
    config: dict
    traffic: dict
    limits: dict

    @classmethod
    def find(cls, root: str, name: str, bench: Optional[dict] = None) -> "Cell":
        bench = bench or read_json(os.path.join(root, "BENCHMARK.json"))
        workload = next((w for w in bench["workloads"] if w["name"] == name),
                        None)
        if workload is None:
            raise KeyError(f"no workload '{name}' in BENCHMARK.json")
        entry = next(c for c in bench["configs"]
                     if c["name"] == workload["config"])
        config = read_json(os.path.join(root, entry["file"]))
        here = os.path.join(root, "fembench")
        traffic = read_json(os.path.join(here, "traffic",
                                         f"{workload['traffic']}.json"))
        limits = read_json(os.path.join(here, "workloads", f"{name}.json"))
        return cls(root, bench, workload, config, traffic, limits["limits"])

    def metrics(self, trace_on: bool) -> list[dict]:
        """The cell's end-to-end metrics (untraced) or per-layer ones."""
        name = self.workload["name"]
        if not trace_on:
            return [m for m in self.bench["end_to_end"]
                    if name in m.get("workloads", [name])]
        e2e = {m["name"] for m in self.metrics(False)}
        return [m for m in self.bench["per_layer"]
                if name in m.get("workloads", [name]) and m["moves"] in e2e]


def reader(root: str, metric: str):
    """The `read` function of fembench/metrics/<metric>.py."""
    return module_at(root, "metrics", metric).read


def forbidden_modules() -> list[str]:
    """Loaded modules whose whole top-level name is forbidden."""
    return sorted({m for m in list(sys.modules)
                   if m.split(".", 1)[0] in FORBIDDEN})


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize()


def run_cell(cell: Cell, seed: int, seconds: float, trace_on: bool, *,
             device: str = "cuda", t_start: Optional[float] = None,
             log=None) -> dict:
    """Run the cell once and return the result line's object (with the
    compared numbers under "checks"). `t_start` is the process's start on
    the host clock (set-up is counted from it)."""
    from mixedfem_tpu_torch import cuda as kernels
    from mixedfem_tpu_torch.io.scene import load_scene

    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    t_start = time.perf_counter() if t_start is None else t_start
    dev = torch.device(device)
    cfg, traffic = cell.config, cell.traffic
    name = cell.workload["name"]
    judge = check.judge_of(cell.root, cfg)

    path, meshes, gen_s = scenes.write_scene(cell.root, cfg, traffic, name,
                                             seed)
    log(f"scene files {path}: {gen_s:.3f} s (not counted in setup_s)")
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    sim = load_scene(path, cfg.get("dim", 3), dtype=cfg["precision"],
                     device=device)
    _sync(dev)
    load_s = time.perf_counter() - t0
    T_file = torch.as_tensor(np.concatenate(
        [t + sum(len(v) for v, _ in meshes[:i]) for i, (_, t) in
         enumerate(meshes)]), device=dev, dtype=torch.int64)
    state0 = sim.state

    # warm-up: one step from the loaded state, every kernel built and
    # every shape of the window seen
    sim.step()
    _sync(dev)
    sim.state = state0
    setup_s = time.perf_counter() - t_start - gen_s
    log(f"load_s {load_s:.3f}, setup_s {setup_s:.3f}")

    steps_per_episode = int(traffic["episode_steps"])
    sample = check.EpisodeSample(KEPT_EPISODES, seed)
    stats, bad = [], []
    bp0 = sim.broadphase_ms
    traced = None
    episodes = 0
    w0 = time.perf_counter()
    while True:
        tracing = trace_on and episodes == 0
        if tracing:
            tracer = trace.Tracer(dev)
            tracer.start()
            kernels.clear_launches()
        sim.state = state0
        kept = []
        for _ in range(steps_per_episode):
            r0 = sim.retries
            st = sim.step()
            stats.append((st.stats, sim.retries - r0))
            bad.append(judge.failed(st, T_file))
            kept.append({k: getattr(st, k) for k in judge.KEEP})
        episodes += 1
        sample.offer(kept)
        if tracing:
            _sync(dev)
            traced = tracer.stop(
                dict(kernels.LAUNCHES), steps_per_episode,
                sum(int(s.iterations) for s, _ in stats[-steps_per_episode:]))
        if time.perf_counter() - w0 >= seconds:
            break
    _sync(dev)
    window_s = time.perf_counter() - w0
    steps = episodes * steps_per_episode
    peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0

    newton = [int(s.iterations) for s, _ in stats]
    cg = [int(s.solver_iters[:s.iterations].sum()) for s, _ in stats]
    retries = [r for _, r in stats]
    failed = sum(int(b) or int(r >= 4) for b, r in
                 zip(torch.stack(bad).tolist(), retries))
    counters = dict(
        steps=steps, newton=sum(newton), cg=sum(cg), retries=sum(retries),
        broadphase_ms=sim.broadphase_ms - bp0,
    )
    log(f"window {window_s:.3f} s, {episodes} episodes, {steps} steps, "
        f"Newton {newton}, CG {cg}")

    # the shapes the kernels ran at, and the program's element rows in the
    # file's order, read from the program's own tables
    s0 = getattr(state0, "s", None)
    shapes = dict(E=int(sim.mesh.nelem), nv=int(sim.mesh.nv),
                  k=int(sim.mesh.T.shape[1]), d=int(state0.x.shape[1]),
                  N=int(s0.shape[1]) if s0 is not None and s0.dim() == 2
                  else None,
                  value_bytes=state0.x.element_size())
    perm = check.file_rows(sim.mesh.T.cpu().numpy(), T_file.cpu().numpy())

    # the comparison, once the window has closed and the program's state
    # is freed (the sampled answers stay)
    del sim, state0, stats, bad
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    c0 = time.perf_counter()
    if perm is None:
        log("comparison: the program's elements are not the file's")
        readings = []
    else:
        ref = judge.prepare(cfg, traffic, meshes, dev)
        readings = [judge.readings(ref, check.in_file_order(ep, judge.KEEP,
                                                            perm))
                    for ep in sample.kept]
    correct, shown = check.judge(readings, cell.limits, judge.NUMBERS)
    log(f"comparison: {len(sample.kept)} episodes of {sample.seen}, "
        f"{time.perf_counter() - c0:.3f} s")

    ctx = dict(host=dict(load_s=load_s, setup_s=setup_s, window_s=window_s,
                         peak_bytes=peak),
               counters=counters, trace=traced, shapes=shapes)
    metrics = {}
    for m in cell.metrics(trace_on):
        v = reader(cell.root, m["name"])(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    device_line = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": (torch.cuda.get_device_name(0) if dev.type == "cuda"
                            else "cpu"),
                   "count": cell.workload["chips"],
                   "memory_peak_bytes": int(peak)}
    out = {"correct": bool(correct), "attempted": steps, "failed": failed,
           "metrics": metrics, "device": device_line}
    if traced is not None:
        device_line["busy_s"] = traced["busy_s"]
        device_line["window_s"] = traced["window_s"]
        out["breakdown"] = traced["breakdown"]
    out["checks"] = shown
    return out
