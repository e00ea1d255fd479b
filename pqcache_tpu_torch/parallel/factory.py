"""Typed-config entry point for the parallel engines.

Counterpart of ``pqcache_tpu/parallel/factory.py``. ``ParallelConfig``
names the mesh, ``data x tensor``, and ``make_mesh`` turns it into this
rank's place in it: one process per (dp, tp) position, dp outermost, so
that global rank = dp_rank · tp + tp_rank, a dp group spans hosts and each
tp group stays inside one. ``make_engine`` builds the engine the config
describes.

Usage, in every rank of a ``torch.distributed`` world of data·tensor
processes (``parallel/launch.py`` on one host, ``torchrun`` with
``dcn.init_distributed`` across hosts):

    cfg = EngineConfig(parallel=ParallelConfig(data=2, tensor=4), ...)
    eng = make_engine(cfg, params, prefill_len=32768, max_new_tokens=64,
                      device=f"cuda:{local_rank}")
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.distributed as dist

from pqcache_tpu_torch import resolve_device
from pqcache_tpu_torch.config import EngineConfig, ParallelConfig
from pqcache_tpu_torch.parallel.collectives import Comm


@dataclasses.dataclass
class RankMesh:
    """This process's place in the (dp, tp) mesh. A comm is None where its
    group has one rank: nothing to reduce (the single-device code path)."""
    dp: int
    tp: int
    dp_rank: int
    tp_rank: int
    tp_comm: Optional[Comm]
    dp_comm: Optional[Comm]
    world_comm: Optional[Comm]
    device: torch.device

    @property
    def shape(self) -> dict:
        return {"dp": self.dp, "tp": self.tp}


def make_mesh(pcfg: ParallelConfig, device=None) -> RankMesh:
    """The (dp=data, tp=tensor) mesh over the ranks of the initialized
    world, which must hold data·tensor processes (a single process needs no
    world for data = tensor = 1). Every rank calls this collectively: each
    group is created by all ranks, in one order. device: this rank's
    device, cuda unless given."""
    device = resolve_device(device)
    n = pcfg.data * pcfg.tensor
    if not dist.is_initialized():
        if n != 1:
            raise ValueError(f"ParallelConfig data={pcfg.data} x tensor="
                             f"{pcfg.tensor} needs a torch.distributed "
                             f"world of {n} processes")
        return RankMesh(1, 1, 0, 0, None, None, None, device)
    world, rank = dist.get_world_size(), dist.get_rank()
    if world != n:
        raise ValueError(f"ParallelConfig wants data={pcfg.data} x tensor="
                         f"{pcfg.tensor} = {n} ranks; the world has {world}")
    dp_rank, tp_rank = divmod(rank, pcfg.tensor)
    tp_comm = dp_comm = None
    for d in range(pcfg.data):
        g = dist.new_group([d * pcfg.tensor + t for t in range(pcfg.tensor)])
        if d == dp_rank and pcfg.tensor > 1:
            tp_comm = Comm(g)
    for t in range(pcfg.tensor):
        g = dist.new_group([d * pcfg.tensor + t for d in range(pcfg.data)])
        if t == tp_rank and pcfg.data > 1:
            dp_comm = Comm(g)
    return RankMesh(pcfg.data, pcfg.tensor, dp_rank, tp_rank, tp_comm,
                    dp_comm, Comm() if n > 1 else None, device)


def make_engine(cfg: EngineConfig, params: dict, *, prefill_len: int,
                max_new_tokens: int, batched: Optional[bool] = None,
                dtype=torch.bfloat16, device=None, sharded: bool = False):
    """Build the engine ``cfg.parallel`` describes. batched=None picks by
    the mesh: data > 1 gives the slot-pool ``BatchTPEngine``, data == 1
    the single-sequence ``TPEngine``; batched=True forces the pool engine
    on a pure-tp mesh. params: the whole model, or with ``sharded`` this
    rank's shard (``sharding.init_params_shard``)."""
    mesh = make_mesh(cfg.parallel, device)
    if batched is None:
        batched = cfg.parallel.data > 1
    if batched:
        from pqcache_tpu_torch.parallel.batch_tp import BatchTPEngine
        return BatchTPEngine(cfg, params, mesh, prefill_len=prefill_len,
                             max_new_tokens=max_new_tokens, dtype=dtype,
                             sharded=sharded)
    from pqcache_tpu_torch.parallel.tp_decode import TPEngine
    return TPEngine(cfg, params, mesh, prefill_len=prefill_len,
                    max_new_tokens=max_new_tokens, dtype=dtype,
                    sharded=sharded)
