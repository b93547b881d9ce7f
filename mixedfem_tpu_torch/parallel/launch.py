"""Start the ranks of a sharded run: what ``jax.sharding.Mesh`` over the
devices is to the JAX package's parallel/ modules.

``run_ranks(fn, world, backend, devices, args)`` starts `world` processes
with the ``spawn`` method. Each sets one torch intra-op thread, joins the
process group through a ``FileStore`` in a fresh temporary directory (no
TCP port to collide with another run), builds its ``Comm`` on its device
and returns ``fn(comm, *args, **kwargs)``. The results come back in
rank order; they cross a process boundary, so they are pickled (return
numpy arrays and plain values). `fn` and its arguments are pickled too:
`fn` is a module-level function of a module that the ranks can import.

Nothing hangs: the process group times its collectives out after
`timeout` seconds, the launcher waits at most `deadline` seconds for all
the ranks, and when a rank fails, or the deadline passes, it kills the
others and raises with that rank's traceback.

When a rank runs on a CUDA device the kernels are built once here, before
the ranks start, so that the ranks do not each run nvcc.
"""

from __future__ import annotations

import datetime
import multiprocessing as mp
import os
import pickle
import queue
import shutil
import tempfile
import time
import traceback

import torch


def _rank_main(rank, world, backend, device, store, timeout, call, out):
    import torch.distributed as dist

    from mixedfem_tpu_torch.parallel.comm import Comm

    torch.set_num_threads(1)
    try:
        with open(call, "rb") as f:
            fn, args, kwargs = pickle.load(f)
        dev = torch.device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group(
            backend, init_method=f"file://{store}", rank=rank,
            world_size=world, timeout=datetime.timedelta(seconds=timeout))
        try:
            comm = Comm(rank=rank, size=world, device=dev)
            result = fn(comm, *args, **kwargs)
        finally:
            dist.destroy_process_group()
        out.put((rank, True, result))
    except Exception:  # reported to the launcher, which raises it
        out.put((rank, False, traceback.format_exc()))


def _indexed(device) -> torch.device:
    """A device with its index: torch.cuda.set_device refuses a bare
    'cuda', which names the current card, card 0 in a fresh rank."""
    d = torch.device(device)
    return torch.device("cuda", 0) if d.type == "cuda" and d.index is None else d


def run_ranks(fn, world: int, backend: str = "gloo", devices=None, args=(),
              kwargs=None, timeout: float = 60.0,
              deadline: float | None = None) -> list:
    """fn(comm, *args, **kwargs) on `world` ranks, rank r on
    devices[r] (default: all on the CPU); the results in rank order.
    Raises RuntimeError with the traceback of the first rank that fails,
    or when the ranks have not all finished `deadline` seconds after the
    start (default 4 x timeout)."""
    if world < 1:
        raise ValueError(f"{world} ranks")
    devices = ["cpu"] * world if devices is None else [
        str(_indexed(d)) for d in devices]
    if len(devices) != world:
        raise ValueError(f"{len(devices)} devices for {world} ranks")
    if backend == "nccl" and len(set(devices)) != world:
        raise ValueError("nccl refuses two ranks on one device; run several "
                         "ranks on one card over gloo")
    if timeout > 60:
        raise ValueError("the process group's timeout is at most 60 s")
    deadline = 4 * timeout if deadline is None else deadline
    if any(torch.device(d).type == "cuda" for d in devices):
        from mixedfem_tpu_torch import cuda

        cuda.build()
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    tmp = tempfile.mkdtemp(prefix="mfem_ranks_")
    store = os.path.join(tmp, "store")
    procs = []
    try:
        # the call goes to the ranks through a file: a process's start
        # writes its arguments into a pipe that the parent too holds open,
        # so a rank that died before reading large ones would block it
        call = os.path.join(tmp, "call.pkl")
        with open(call, "wb") as f:
            pickle.dump((fn, tuple(args), dict(kwargs or {})), f,
                        protocol=pickle.HIGHEST_PROTOCOL)
        for r in range(world):
            p = ctx.Process(
                target=_rank_main,
                args=(r, world, backend, devices[r], store, timeout, call,
                      out),
                daemon=True)
            p.start()
            procs.append(p)
        results = [None] * world
        done = 0
        end = time.monotonic() + deadline
        while done < world:
            left = end - time.monotonic()
            if left <= 0:
                raise RuntimeError(
                    f"ranks {[r for r in range(world) if results[r] is None]}"
                    f" did not finish within {deadline:.0f} s")
            try:
                rank, ok, value = out.get(timeout=min(left, 0.5))
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if results[r] is None and p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(
                        f"rank {dead[0]} died with exit code "
                        f"{procs[dead[0]].exitcode} and no report")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} of {world} failed:\n{value}")
            results[rank] = (value,)
            done += 1
        for p in procs:
            p.join(timeout=30)
        return [r[0] for r in results]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
        for p in procs:
            p.join(timeout=10)
        out.close()
        shutil.rmtree(tmp, ignore_errors=True)
