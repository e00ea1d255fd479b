"""The parallel engines' collectives on ``torch.distributed``.

The JAX package runs one SPMD program under ``shard_map`` and reduces with
XLA's collectives; the port runs one process per rank and calls
``torch.distributed`` through ``Comm``, one process group with the
operations the engines use:

    JAX                          Comm
    psum                         all_reduce (sum)
    pmax                         all_reduce(op="max")
    all_gather(tiled=True)       all_gather (all_gather_into_tensor)
    all_to_all(tiled=True)       all_to_all (all_to_all_single)
    ppermute j -> j + 1          ring_shift (batch_isend_irecv)
    axis_index                   rank
    process_allgather of flags   all_true (all_reduce MIN of a flag)

Sums reduce in the tensor's own dtype, as ``jax.lax.psum`` does: a bf16
activation is all-reduced in bf16.

Routes. NCCL takes CUDA tensors; gloo takes CPU tensors, and CUDA tensors
for its collectives (all_reduce, all_gather_into_tensor, all_to_all_single:
it stages them itself) but not for point-to-point: gloo's send hands the
device pointer to its socket ("writev: Bad address", torch 2.11+cu128 on
an H100). So ``ring_shift`` of CUDA tensors under gloo takes the named
route ``"gloo-p2p-pinned"``: the tensors are copied into pinned host
buffers, shifted there and copied back. Every other case is ``"direct"``.
Nothing switches silently: ``stats`` holds each operation's route, calls
and bytes, and a staged route is logged once per group when first taken.
"""

from __future__ import annotations

import logging
import time
import torch
import torch.distributed as dist

log = logging.getLogger(__name__)

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
        "min": dist.ReduceOp.MIN}
STAGED_ROUTE = "gloo-p2p-pinned"


class Comm:
    """One process group's collectives (``group`` None: the default group
    of every rank). ``timed`` adds each call's host-clock seconds to
    ``stats``, synchronising the device before and after it (a
    measurement mode: the engines run with it off)."""

    def __init__(self, group=None, *, timed: bool = False):
        self.group = group
        self.rank = dist.get_rank(group)
        self.size = dist.get_world_size(group)
        self.backend = str(dist.get_backend(group))
        self.timed = timed
        self.stats: dict = {}

    def _route(self, op: str, t: torch.Tensor) -> str:
        if op == "ring_shift" and self.backend == "gloo" and t.is_cuda:
            return STAGED_ROUTE
        return "direct"

    def _count(self, op: str, route: str, nbytes: int, seconds: float):
        s = self.stats.get(op)
        if s is None:
            s = self.stats[op] = {"route": route, "calls": 0, "bytes": 0,
                                  "seconds": 0.0}
            if route != "direct":
                log.warning("%s of CUDA tensors over %s takes the %s "
                            "route", op, self.backend, route)
        s["calls"] += 1
        s["bytes"] += nbytes
        s["seconds"] += seconds

    def _clock(self, t: torch.Tensor) -> float:
        if self.timed and t.is_cuda:
            torch.cuda.synchronize(t.device)
        return time.perf_counter()

    def reset_stats(self) -> None:
        self.stats = {}

    # -- collectives --------------------------------------------------------

    def all_reduce(self, x: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """x reduced over the group, in place and in x's dtype (x must be
        contiguous); returns x."""
        t0 = self._clock(x)
        dist.all_reduce(x, op=_OPS[op], group=self.group)
        self._count("all_reduce", "direct", x.numel() * x.element_size(),
                    self._clock(x) - t0)
        return x

    def all_gather(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """Every rank's x concatenated along ``dim`` in rank order."""
        x = x.movedim(dim, 0).contiguous()
        t0 = self._clock(x)
        out = torch.empty((self.size * x.shape[0],) + tuple(x.shape[1:]),
                          dtype=x.dtype, device=x.device)
        dist.all_gather_into_tensor(out, x, group=self.group)
        self._count("all_gather", "direct", out.numel() * out.element_size(),
                    self._clock(x) - t0)
        return out.movedim(0, dim)

    def all_to_all(self, x: torch.Tensor, split_dim: int,
                   concat_dim: int) -> torch.Tensor:
        """Tiled all-to-all: block j of x along ``split_dim`` goes to rank j,
        and the blocks received are concatenated along ``concat_dim`` in
        rank order (``jax.lax.all_to_all(..., tiled=True)``)."""
        n = self.size
        xs = x.unflatten(split_dim, (n, x.shape[split_dim] // n))
        send = xs.movedim(split_dim, 0).contiguous()
        recv = torch.empty_like(send)
        t0 = self._clock(x)
        dist.all_to_all_single(recv, send, group=self.group)
        self._count("all_to_all", "direct", send.numel() * send.element_size(),
                    self._clock(x) - t0)
        # recv [src, ...]: the source axis goes in front of concat_dim
        return recv.movedim(0, concat_dim).flatten(concat_dim, concat_dim + 1)

    def ring_shift(self, tensors: list) -> list:
        """Each tensor of this rank goes to rank + 1; returns those of rank
        - 1 (``ppermute`` with perm j -> j + 1 mod size)."""
        route = self._route("ring_shift", tensors[0])
        t0 = self._clock(tensors[0])
        src = [t.contiguous() for t in tensors]
        if route == STAGED_ROUTE:
            src = [_pinned_copy(t) for t in src]
        dst = [torch.empty_like(t) for t in src]
        nxt, prv = (self.rank + 1) % self.size, (self.rank - 1) % self.size
        ops = []
        for s, d in zip(src, dst):
            ops.append(dist.P2POp(dist.isend, s, self._global(nxt),
                                  self.group))
            ops.append(dist.P2POp(dist.irecv, d, self._global(prv),
                                  self.group))
        for w in dist.batch_isend_irecv(ops):
            w.wait()
        if route == STAGED_ROUTE:
            dst = [d.to(t.device, non_blocking=True)
                   for d, t in zip(dst, tensors)]
        self._count("ring_shift", route,
                    sum(t.numel() * t.element_size() for t in src),
                    self._clock(tensors[0]) - t0)
        return dst

    def all_true(self, flag: bool) -> bool:
        """True when ``flag`` is true on every rank (all_reduce MIN of a
        flag, on the CPU under gloo)."""
        dev = "cpu" if self.backend == "gloo" else torch.device(
            "cuda", torch.cuda.current_device())
        t = torch.tensor([1 if flag else 0], dtype=torch.int32, device=dev)
        t0 = time.perf_counter()
        dist.all_reduce(t, op=dist.ReduceOp.MIN, group=self.group)
        out = bool(t.item())
        self._count("all_true", "direct", 4, time.perf_counter() - t0)
        return out

    def all_gather_object(self, obj) -> list:
        """Every rank's picklable ``obj``, in rank order."""
        out = [None] * self.size
        dist.all_gather_object(out, obj, group=self.group)
        return out

    def _global(self, r: int) -> int:
        return r if self.group is None else dist.get_global_rank(self.group,
                                                                 r)


def _pinned_copy(t: torch.Tensor) -> torch.Tensor:
    """A pinned host copy of a CUDA tensor (the copy waits for the stream's
    pending work: the host reads it next)."""
    out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    out.copy_(t)
    return out

