"""The collectives of the sharded renderer over torch.distributed.

One rank per process (or, in tests, per thread) and one card per rank.
`Comm` wraps a process group and offers the few collectives the sharded
frames need, each through the group object's own methods, so that a
group made without `init_process_group` (ranks as threads) works too:

  * `all_gather` of equal-shaped tensors, in rank order;
  * `all_gather_rows`: row blocks of differing lengths, whose counts
    the caller knows, concatenated in rank order (the rows travel padded
    to the largest count: all_gather takes equal shapes);
  * `sum_in_rank_order`: ((init + x_0) + x_1) + ..., the order in which
    a single process adds its bands, so the sum is reproducible;
  * `broadcast` of a tensor and `broadcast_flag` of a small integer;
  * `barrier`.

The backend decides where the tensors travel.  NCCL takes card tensors
and refuses CPU ones (ValueError).  Gloo takes CPU tensors: a card
tensor is staged through host memory and the result copied back to its
card.  This is chosen by the backend, never as a fallback.

Every collective adds one to `calls` and its output's bytes to `bytes`
(what this rank receives); with `timed` set, each is bracketed by CUDA
events on a card (host time on the CPU), and `collective_ms()` sums them.
"""

from __future__ import annotations

import datetime
import time

import torch
import torch.distributed as dist

BACKENDS = ("nccl", "gloo")


class Comm:
    def __init__(self, group, rank: int, world: int, device, backend: str,
                 owns_group: bool = False):
        if backend not in BACKENDS:
            raise ValueError(f"unsupported backend {backend!r}: use one of "
                             f"{BACKENDS}")
        self.group = group
        self.rank = int(rank)
        self.world = int(world)
        self.device = torch.device(device)
        self.backend = backend
        self.owns_group = owns_group
        self.timed = False
        self.reset_counts()

    # ---- construction --------------------------------------------------
    @classmethod
    def init(cls, backend: str, addr: str, port: int, rank: int, world: int,
             device, timeout: float = 600.0) -> "Comm":
        """Join a process group over TCP at addr:port as `rank` of `world`;
        a collective that waits longer than `timeout` seconds raises."""
        dist.init_process_group(
            backend=backend, init_method=f"tcp://{addr}:{port}", rank=rank,
            world_size=world, timeout=datetime.timedelta(seconds=timeout))
        group = dist.distributed_c10d._get_default_group()
        return cls(group, rank, world, device, backend, owns_group=True)

    @classmethod
    def from_group(cls, pg, rank: int, world: int, device) -> "Comm":
        """Wrap an existing process group object (e.g. a ProcessGroupGloo
        over a HashStore, ranks as threads)."""
        return cls(pg, rank, world, device, pg.name())

    def close(self):
        if self.owns_group and dist.is_initialized():
            dist.destroy_process_group()
        self.owns_group = False

    # ---- counters ------------------------------------------------------
    def reset_counts(self):
        self.calls = 0
        self.bytes = 0
        self.kinds = {}
        self._events = []
        self._host_ms = 0.0

    def collective_ms(self) -> float:
        """Milliseconds spent in the timed collectives since the last
        reset_counts (synchronises the card)."""
        ms = self._host_ms
        if self._events:
            torch.cuda.synchronize(self._events[0][0].device)
            ms += sum(a.elapsed_time(b) for a, b in self._events)
        return ms

    def _count(self, kind: str, nbytes: int):
        self.calls += 1
        self.bytes += int(nbytes)
        self.kinds[kind] = self.kinds.get(kind, 0) + 1

    def _run(self, kind, x, body):
        """Run body(x_on_the_backend's_device) -> (result, bytes), staging
        card tensors through the host on gloo."""
        if self.backend == "nccl" and x.device.type != "cuda":
            raise ValueError(f"{kind}: the NCCL backend takes card tensors; "
                             f"got a tensor on {x.device}")
        stage = self.backend == "gloo" and x.device.type != "cpu"
        start = None
        if self.timed and x.device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            start.record()
        t0 = time.perf_counter()
        out, nbytes = body(x.cpu() if stage else x.contiguous())
        if stage:
            out = ([o.to(x.device) for o in out] if isinstance(out, list)
                   else out.to(x.device))
        if start is not None:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            self._events.append((start, end))
        elif self.timed:
            self._host_ms += (time.perf_counter() - t0) * 1000.0
        self._count(kind, nbytes)
        return out

    # ---- collectives ---------------------------------------------------
    def all_gather(self, x: torch.Tensor) -> list:
        """Every rank's `x` (equal shapes), in rank order."""
        def body(y):
            out = [torch.empty_like(y) for _ in range(self.world)]
            self.group.allgather([out], [y]).wait()
            return out, y.numel() * y.element_size() * self.world
        return self._run("all_gather", x, body)

    def all_gather_rows(self, x: torch.Tensor, counts) -> torch.Tensor:
        """Concatenate every rank's row block `x` (n_r, ...) in rank order;
        `counts` holds every rank's n_r."""
        counts = [int(c) for c in counts]
        if counts[self.rank] != x.shape[0]:
            raise ValueError(f"rank {self.rank} holds {x.shape[0]} rows, "
                             f"its count says {counts[self.rank]}")
        top = max(counts)
        if x.shape[0] < top:
            pad = x.new_zeros((top - x.shape[0],) + tuple(x.shape[1:]))
            x = torch.cat([x, pad])
        parts = self.all_gather(x)
        return torch.cat([p[:c] for p, c in zip(parts, counts)])

    def sum_in_rank_order(self, x: torch.Tensor, init=None) -> torch.Tensor:
        """((init + x_0) + x_1) + ... over the ranks' `x`, on every rank;
        without `init`, x_0 + x_1 + ...."""
        out = init
        for part in self.all_gather(x):
            out = part if out is None else out + part
        return out

    def broadcast(self, x: torch.Tensor, src: int = 0) -> torch.Tensor:
        """Rank `src`'s `x` on every rank, as a new tensor."""
        def body(y):
            y = y.clone()
            opts = dist.BroadcastOptions()
            opts.rootRank = src
            self.group.broadcast([y], opts).wait()
            return y, y.numel() * y.element_size()
        return self._run("broadcast", x, body)

    def broadcast_flag(self, value: int, src: int = 0) -> int:
        """Rank `src`'s small integer on every rank."""
        t = torch.tensor([int(value)], dtype=torch.int64, device=self.device)
        return int(self.broadcast(t, src)[0])

    def barrier(self):
        self.group.barrier(dist.BarrierOptions()).wait()
