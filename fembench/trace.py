"""The traced episode: a torch.profiler trace of one episode of the window,
reduced to what the per-layer readers take.

Device operations (kernels, copies, sets) are matched to the host's spans
(record_function, `newton.update` and the like) through the runtime call
that launched them: an operation belongs to every span open on the host
thread when its launch was made. Busy time is the union of the device
operations' intervals; idle time is the rest of the episode, summed by
what the host was doing then: the innermost span and operator open.
"""

from __future__ import annotations

import collections
import json
import os
import tempfile
import torch
from torch.profiler import ProfilerActivity, record_function

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
EPISODE = "fembench.episode"


class Tracer:
    """torch.profiler around one episode, with the harness's own span
    marking the episode on the host thread."""

    def __init__(self, device: torch.device):
        acts = [ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=acts)
        self.span = record_function(EPISODE)

    def start(self) -> None:
        self.prof.__enter__()
        self.span.__enter__()

    def stop(self, launches: dict, steps: int, newton: int) -> dict:
        self.span.__exit__(None, None, None)
        self.prof.__exit__(None, None, None)
        with tempfile.TemporaryDirectory() as d:
            path = os.path.join(d, "trace.json")
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        return summarize(events, launches, steps, newton)


def short_name(name: str) -> str:
    """A device operation's name without its return type, namespace and
    argument list."""
    if name.endswith(")"):
        depth = 0
        for i in range(len(name) - 1, 0, -1):
            depth += {")": 1, "(": -1}.get(name[i], 0)
            if depth == 0:
                name = name[:i]
                break
    for prefix in ("void ", "(anonymous namespace)::"):
        name = name.replace(prefix, "")
    return name.strip()


def enclosing(intervals, times):
    """For each time of the ascending `times`, the names of the intervals
    (start, end, name) of one thread that contain it, outermost first
    (intervals of one thread nest)."""
    ivs = sorted(intervals, key=lambda iv: (iv[0], -iv[1]))
    out, stack, i = [], [], 0
    for t in times:
        while i < len(ivs) and ivs[i][0] <= t:
            while stack and stack[-1][1] <= ivs[i][0]:
                stack.pop()
            stack.append(ivs[i])
            i += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        out.append(tuple(iv[2] for iv in stack if iv[1] >= t))
    return out


def _top(counter: dict, n: int = 10):
    return [[k, v] for k, v in sorted(counter.items(), key=lambda kv: -kv[1])[:n]]


def summarize(events: list, launches: dict, steps: int, newton: int) -> dict:
    """The readers' view of one traced episode (the harness's span): its
    length and busy seconds, device
    seconds and launches per kernel name, device seconds per host span,
    and the breakdown (top device operations, idle time by what the host
    was doing). Times of the chrome trace are in microseconds."""
    xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
    episode = [e for e in xs if e.get("name") == EPISODE
               and e.get("cat") == "user_annotation"]
    if not episode:
        raise ValueError("the trace has no episode span")
    ep = episode[0]
    tid, w0, w1 = ep.get("tid"), ep["ts"], ep["ts"] + ep["dur"]
    host = [e for e in xs if e.get("tid") == tid and e.get("pid") == ep.get("pid")]
    spans = [(e["ts"], e["ts"] + e["dur"], e["name"]) for e in host
             if e.get("cat") == "user_annotation" and e["name"] != EPISODE]
    ops = [(e["ts"], e["ts"] + e["dur"], e["name"]) for e in host
           if e.get("cat") == "cpu_op"]
    launch_ts = {}
    for e in xs:
        if e.get("cat") in ("cuda_runtime", "cuda_driver"):
            corr = (e.get("args") or {}).get("correlation")
            if corr is not None:
                launch_ts[corr] = e["ts"]
    dev = sorted((e for e in xs if e.get("cat") in DEVICE_CATS),
                 key=lambda e: e["ts"])

    # busy time: the union of the device operations' intervals
    busy, merged = 0.0, []
    for e in dev:
        a, b = max(e["ts"], w0), min(e["ts"] + e["dur"], w1)
        if b <= a:
            continue
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    busy = sum(b - a for a, b in merged)

    per_kernel = collections.defaultdict(lambda: [0, 0.0])
    for e in dev:
        k = per_kernel[short_name(e["name"])]
        k[0] += 1
        k[1] += e["dur"] * 1e-6

    span_s = collections.Counter()
    timed = [(launch_ts[c], e["dur"]) for e in dev
             if (c := (e.get("args") or {}).get("correlation")) in launch_ts]
    timed.sort()
    for (t, dur), names in zip(timed, enclosing(spans, [t for t, _ in timed])):
        for n in set(names):
            span_s[n] += dur * 1e-6

    # idle stretches of the episode, named by the host's span and operator
    gaps, prev = [], w0
    for a, b in merged:
        if a > prev:
            gaps.append((prev, a - prev))
        prev = max(prev, b)
    if w1 > prev:
        gaps.append((prev, w1 - prev))
    # the host's state between consecutive span and operator boundaries
    bounds = sorted({w0, w1} | {t for a, b, _ in spans + ops for t in (a, b)
                                if w0 < t < w1})
    mids = [(a + b) / 2 for a, b in zip(bounds, bounds[1:])]
    segs = [(a, b, f"{sp[-1] if sp else 'outside spans'}/{op[-1] if op else '-'}")
            for a, b, sp, op in zip(bounds, bounds[1:], enclosing(spans, mids),
                                    enclosing(ops, mids))]
    idle, i = collections.Counter(), 0
    for ga, gdur in gaps:
        gb = ga + gdur
        while i < len(segs) and segs[i][1] <= ga:
            i += 1
        j = i
        while j < len(segs) and segs[j][0] < gb:
            a, b, label = segs[j]
            idle[label] += (min(gb, b) - max(ga, a)) * 1e-6
            j += 1

    return dict(
        window_s=(w1 - w0) * 1e-6, busy_s=busy * 1e-6, steps=steps, newton=newton,
        kernels={k: {"n": n, "s": s} for k, (n, s) in per_kernel.items()},
        span_s=dict(span_s), launches=dict(launches),
        breakdown=dict(
            device_ops=_top({k: s for k, (n, s) in per_kernel.items()}),
            idle_gaps=_top(idle)),
    )
