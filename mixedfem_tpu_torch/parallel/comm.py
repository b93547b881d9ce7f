"""The collective layer of the sharded steps: what ``shard_map``'s
``psum``, ``pmax`` and ``ppermute`` are to the JAX package's parallel/
modules, over a ``torch.distributed`` process group.

The step code is written SPMD-style, one function per rank, as a
``shard_map`` body is; it holds a ``Comm`` and calls:

  psum(t)        the sum over ranks, the same bits on every rank: an
                 all_gather, then the parts added in rank order, so a given
                 number of ranks gives the same result on any transport
  pmax(t)        the elementwise maximum over ranks
  shift(t, s)    the ring ppermute: rank i sends t to rank (i + s) % size
                 and returns what rank (i - s) % size sent. The ring wraps
                 around, as the JAX package's permutations do, so rank 0's
                 left halo holds rank size-1's tail; the plans leave it unused
  ring(a, b)     shift(a, +1) and shift(b, -1) posted together (a halo)
  all_gather(t)  every rank's t, in rank order

Transports. ``nccl`` takes CUDA tensors as they are and needs one device a
rank: a Comm refuses two ranks on one device (NCCL itself refuses them).
``gloo`` takes CPU tensors; a Comm on a CUDA device stages every collective
through pinned host buffers, since gloo takes CUDA tensors for some
collectives only and for no send or receive. That staged gloo is the
transport of several ranks on one card.

Every collective adds its host milliseconds (the staging copies included)
and the bytes it sends to ``stats``.
"""

from __future__ import annotations

import time

import torch
import torch.distributed as dist


class Comm:
    """One rank's handle on its process group, on its device."""

    def __init__(self, group=None, rank: int | None = None,
                 size: int | None = None, device="cpu"):
        self.group = group
        self.rank = dist.get_rank(group) if rank is None else int(rank)
        self.size = dist.get_world_size(group) if size is None else int(size)
        self.device = torch.device(device)
        self.backend = dist.get_backend(group)
        if self.backend == "nccl":
            if self.device.type != "cuda":
                raise ValueError("nccl takes CUDA tensors: give each rank a "
                                 "CUDA device")
            self._check_distinct_devices()
        elif self.backend != "gloo":
            raise ValueError(f"backend {self.backend!r}: the sharded steps "
                             "run on nccl or gloo")
        # gloo with CUDA tensors: every collective goes through host buffers
        self.staged = self.backend == "gloo" and self.device.type == "cuda"
        self._pinned: dict = {}
        self.stats = {"ms": 0.0, "bytes": 0, "calls": 0}

    def _check_distinct_devices(self) -> None:
        probe = dist.new_group(backend="gloo")
        try:
            seen = [None] * self.size
            dist.all_gather_object(
                seen, (torch.cuda.get_device_properties(self.device).uuid,
                       self.rank), group=probe)
        finally:
            dist.destroy_process_group(probe)
        uuids = [str(u) for u, _ in seen]
        if len(set(uuids)) != len(uuids):
            raise ValueError("nccl refuses two ranks on one device; run "
                             "several ranks on one card over gloo")

    @property
    def transport(self) -> str:
        return f"{self.backend}{' (host-staged)' if self.staged else ''}"

    def clear_stats(self) -> None:
        self.stats = {"ms": 0.0, "bytes": 0, "calls": 0}

    # -- staging -----------------------------------------------------------

    def _host(self, t: torch.Tensor, slot: str) -> torch.Tensor:
        """A pinned host buffer of t's shape and dtype, reused per slot."""
        key = (slot, tuple(t.shape), t.dtype)
        buf = self._pinned.get(key)
        if buf is None:
            buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            self._pinned[key] = buf
        return buf

    def _wire(self, t: torch.Tensor, slot: str) -> torch.Tensor:
        t = t.contiguous()
        if not self.staged:
            return t
        buf = self._host(t, slot)
        buf.copy_(t)
        return buf

    def _back(self, t: torch.Tensor) -> torch.Tensor:
        return t.to(self.device, non_blocking=False) if self.staged else t

    def _tick(self, t0: float, nbytes: int) -> None:
        self.stats["ms"] += (time.perf_counter() - t0) * 1e3
        self.stats["bytes"] += int(nbytes)
        self.stats["calls"] += 1

    # -- collectives -------------------------------------------------------

    def _gather_wire(self, t: torch.Tensor):
        """Every rank's t in rank order, as wire tensors, and the bytes this
        rank sent (its part reaches each other rank). On gloo the parts go
        round the ring, size - 1 shifts: gloo's own all_gather took about
        twice as long at every size the sharded steps send
        (parallel/comm_bench.py compares the two). NCCL's all_gather as
        it is."""
        src = self._wire(t, "gather_src")
        nbytes = src.numel() * src.element_size() * (self.size - 1)
        if self.backend == "nccl":
            parts = [torch.empty_like(src) for _ in range(self.size)]
            dist.all_gather(parts, src, group=self.group)
            return parts, nbytes
        parts = [None] * self.size
        parts[self.rank] = cur = src
        for j in range(1, self.size):
            (cur,) = self._exchange([(cur, 1)])     # rank - j's part
            parts[(self.rank - j) % self.size] = cur
        return parts, nbytes

    def all_gather(self, t: torch.Tensor) -> list:
        """Every rank's t (same shape on every rank), in rank order."""
        t0 = time.perf_counter()
        parts, nbytes = self._gather_wire(t)
        out = [self._back(p) for p in parts]
        self._tick(t0, nbytes)
        return out

    def psum(self, t: torch.Tensor) -> torch.Tensor:
        """The sum over ranks, added in rank order."""
        t0 = time.perf_counter()
        parts, nbytes = self._gather_wire(t)
        acc = parts[0].clone()
        for p in parts[1:]:
            acc += p
        out = self._back(acc)
        self._tick(t0, nbytes)
        return out

    def pmax(self, t: torch.Tensor) -> torch.Tensor:
        """The elementwise maximum over ranks."""
        t0 = time.perf_counter()
        parts, nbytes = self._gather_wire(t)
        acc = parts[0].clone()
        for p in parts[1:]:
            acc = torch.maximum(acc, p)
        out = self._back(acc)
        self._tick(t0, nbytes)
        return out

    def shift(self, t: torch.Tensor, step: int) -> torch.Tensor:
        """Send t to rank (rank + step) % size and return what rank
        (rank - step) % size sent (a tensor of t's shape)."""
        if step not in (1, -1):
            raise ValueError(f"a ring shift of {step}: shift takes +1 or -1")
        return self._p2p([(t, step)])[0]

    def ring(self, to_next: torch.Tensor, to_prev: torch.Tensor):
        """Both ring shifts at once: to_next goes to rank + 1 and to_prev to
        rank - 1; returns (what rank - 1 sent to its next, what rank + 1
        sent to its prev), i.e. (shift(to_next, +1), shift(to_prev, -1))."""
        return self._p2p([(to_next, 1), (to_prev, -1)])

    def _exchange(self, sends):
        """Ring sends of wire tensors [(t, step)], each to rank + step,
        posted together: every receive first, then every send, in one order
        on all ranks (a tag per step keeps two messages to one neighbour
        apart). Returns, for each, what rank - step sent with that step."""
        recv, ops = [], []
        for t, step in sends:
            dst = torch.empty_like(t)
            tag = 1 if step == 1 else 2
            recv.append((dist.irecv, dst, (self.rank - step) % self.size, tag))
            ops.append((dist.isend, t, (self.rank + step) % self.size, tag))
        if self.backend == "nccl":
            reqs = dist.batch_isend_irecv([
                dist.P2POp(f, b, peer, group=self.group, tag=tag)
                for f, b, peer, tag in recv + ops])
        else:
            reqs = [f(b, peer, group=self.group, tag=tag)
                    for f, b, peer, tag in recv + ops]
        for r in reqs:
            r.wait()
        return [b for _, b, _, _ in recv]

    def _p2p(self, sends):
        """ring and shift: the sends staged, exchanged and brought back."""
        if self.size == 1:
            return [t.clone() for t, _ in sends]
        t0 = time.perf_counter()
        live = [(i, self._wire(t, f"p2p_src{i}"), step)
                for i, (t, step) in enumerate(sends) if t.numel()]
        got = self._exchange([(w, step) for _, w, step in live])
        out = [t.clone() for t, _ in sends]
        for (i, _, _), g in zip(live, got):
            out[i] = self._back(g)
        self._tick(t0, sum(w.numel() * w.element_size() for _, w, _ in live))
        return out
