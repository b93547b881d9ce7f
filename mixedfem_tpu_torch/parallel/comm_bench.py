"""Time the two ways of gathering a tensor over gloo ranks that
parallel/comm.py could take for psum: its ring (size - 1 shifts, what
Comm.psum does on gloo) and gloo's own all_gather, both followed by the
same rank-ordered sum, at the sizes the sharded steps send:

  1, 2      a CG dot product, and the pair (r . z, r . r)
  3000      the vertex-partitioned step's coarse residual a CG iteration
            (500 aggregates x 6 modes, phase 26's beam)
  20000     a mid-sized message
  126000    the vertex-partitioned step's aggregate-pair sums a Newton
            iteration (about 3,500 pairs x 36)

Run: python -m mixedfem_tpu_torch.parallel.comm_bench [RANKS] [--device
cuda] [--iters N]. Each rank times N psums of each size and way after 5
untimed ones; the slowest rank's mean us per psum is printed, one line a
size, with the ratio all_gather / ring. On a CUDA device the ranks share
the card and stage through pinned host buffers, as the sharded steps do.
"""

from __future__ import annotations

import argparse
import json
import time

import torch
import torch.distributed as dist

SIZES = (1, 2, 3000, 20000, 126000)


def _psum_all_gather(comm, t):
    """gloo's all_gather of t, then the rank-ordered sum (the alternative
    to Comm.psum's ring)."""
    src = comm._wire(t, "bench_src")
    parts = [torch.empty_like(src) for _ in range(comm.size)]
    dist.all_gather(parts, src, group=comm.group)
    acc = parts[0].clone()
    for p in parts[1:]:
        acc += p
    return comm._back(acc)


def time_gathers(comm, sizes, iters: int):
    """{size: {"ring": us, "all_gather": us}} of this rank, float32."""
    out = {}
    for m in sizes:
        t = torch.full((m,), 1.0 + comm.rank, device=comm.device)
        ways = {"ring": comm.psum,
                "all_gather": lambda x: _psum_all_gather(comm, x)}
        row = {}
        for name, fn in ways.items():
            for _ in range(5):
                fn(t)
            t0 = time.perf_counter()
            for _ in range(iters):
                got = fn(t)
            if comm.device.type == "cuda":
                torch.cuda.synchronize(comm.device)
            row[name] = (time.perf_counter() - t0) / iters * 1e6
            want = sum(1.0 + r for r in range(comm.size))
            if not bool((got == want).all()):
                raise AssertionError(f"{name} psum of {m} values is wrong")
        out[m] = row
    return out


def main() -> None:
    from mixedfem_tpu_torch.parallel import launch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("ranks", type=int, nargs="?", default=4)
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--iters", type=int, default=200)
    a = ap.parse_args()
    res = launch.run_ranks(time_gathers, a.ranks, devices=[a.device] * a.ranks,
                           args=(SIZES, a.iters))
    rows = {}
    for m in SIZES:
        ring = max(r[m]["ring"] for r in res)
        ag = max(r[m]["all_gather"] for r in res)
        rows[m] = dict(ring_us=ring, all_gather_us=ag, ratio=ag / ring)
        print(f"{a.ranks} gloo ranks on {a.device}, {m} floats: ring "
              f"{ring:.1f} us, all_gather {ag:.1f} us, ratio {ag / ring:.2f}")
    print(json.dumps({"comm_bench": {"ranks": a.ranks, "device": a.device,
                                     "iters": a.iters, "sizes": rows}}))


if __name__ == "__main__":
    main()
