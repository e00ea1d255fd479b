"""dp x tp SHARDED host-offload tier: the beyond-HBM cache hierarchy over
a mesh of ranks.

Counterpart of ``pqcache_tpu/parallel/offload_tp.py``. The reference runs
one cache manager PER RANK, each owning the kv-head slice of every layer's
pinned host buffers and device cache (pq_search.py:46-64;
cache_manager.py:53-147). So does this tier, one process per (dp, tp)
rank:

  * ``dp`` shards the slot pool (each data-parallel group its own
    sequences), ``tp`` the kv heads, with the two all-reduces per layer of
    ``parallel/tp_decode.py``;
  * every rank runs the batched offload engine (``runtime/offload_batch``)
    at its local shapes, B / dp slots x H_kv / tp heads: its own
    ``HostKVStore`` over its head slice and its group's slots (pinned host
    leaves keyed by slot-prefixed block ids, its own native LFU with the
    slot proxy, hit / miss classification) and its own slice of the device
    block cache.

That per-rank store is the JAX package's ``_ShardResidency``: there one
process addressed every device, so a host-side manager per (dp, tp, layer)
shard staged each shard's misses into one mesh-wide upload; here each
process stages its own misses on its own copy stream. Exact and one-step
stale selection (``cache.stale_select``) both run per rank, as on one
device. The logits are replicated over tp, so every rank of a group takes
the same tokens; the engine checks that they agree.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from pqcache_tpu_torch.config import EngineConfig
from pqcache_tpu_torch.parallel.sharding import gather_layer
from pqcache_tpu_torch.parallel.tp_decode import (local_model_config,
                                                  local_params)
from pqcache_tpu_torch.runtime.offload_batch import BatchOffloadEngine


class ShardedOffloadEngine:
    """Batch offload decode over a (dp, tp) mesh (``factory.make_mesh``)
    with a host-store shard per rank. params: the whole model, or with
    ``sharded`` this rank's shard; each rank keeps only its shard
    (``tp_decode.local_params``; ``generate_ring`` rebuilds one layer at a
    time from the group's shards)."""

    def __init__(self, cfg: EngineConfig, params: dict, mesh,
                 batch_size: int, dtype=torch.bfloat16,
                 sharded: bool = False):
        self.mesh = mesh
        self.dp, self.tp = mesh.dp, mesh.tp
        if batch_size % self.dp:
            raise ValueError(f"batch {batch_size} % dp {self.dp} != 0")
        self.B = batch_size
        self.B_loc = batch_size // self.dp
        self.cfg = cfg
        self.cfg_local = local_model_config(cfg, self.tp)
        self.dtype = dtype
        self.comm = mesh.tp_comm
        # the compute core: the single-device batched engine at the LOCAL
        # shapes, with the tp all-reduces and global k-means++ seeding
        self.core = BatchOffloadEngine(
            self.cfg_local, local_params(params, mesh, dtype, sharded),
            batch_size=self.B_loc, dtype=dtype, device=mesh.device,
            comm=self.comm, shard=(mesh.tp_rank, self.tp))

    def _agree(self, outs: List[list]) -> List[list]:
        """The tp group's token lists, checked equal across its ranks."""
        if self.comm is not None:
            if any(o != outs for o in self.comm.all_gather_object(outs)):
                raise RuntimeError("tensor-parallel ranks disagree on "
                                   "tokens")
        return outs

    def generate_batch(self, prompts, max_new_tokens: int,
                       eos_ids=()) -> List[list]:
        """Prefill and decode B prompts; dp group g serves prompts
        [g·B/dp, (g+1)·B/dp). Every rank returns all B token lists."""
        if len(prompts) != self.B:
            raise ValueError(f"need {self.B} prompts, got {len(prompts)}")
        g = self.mesh.dp_rank
        mine = self._agree(self.core.generate_batch(
            list(prompts[g * self.B_loc:(g + 1) * self.B_loc]),
            max_new_tokens, eos_ids))
        if self.mesh.dp_comm is None:
            return mine
        return [o for part in self.mesh.dp_comm.all_gather_object(mine)
                for o in part]

    @torch.no_grad()
    def generate_ring(self, prompt_ids, max_new_tokens: int, eos_ids=(),
                      inner: int = 512) -> list:
        """RING PREFILL -> OFFLOAD handoff: the prompt prefills
        sequence-sharded over the tp group (``ring_prefill.ring_forward``,
        each layer's weights gathered from the shards as it comes), one
        all-to-all reshards its K/V head-major, and each rank admits its
        head slice into its core (``admit_prefilled``: the standard tail
        update with global k-means++ seeding, its own store); decode then
        matches ``generate_batch`` on the same prompt. Needs dp == 1 and
        B == 1."""
        from pqcache_tpu_torch.parallel.ring_prefill import ring_forward
        if self.dp != 1 or self.B != 1:
            raise ValueError("generate_ring requires dp == 1 and B == 1")
        core = self.core
        ids = np.asarray(prompt_ids, np.int64)
        true_len = int(ids.shape[0])
        core.setup(true_len, max_new_tokens)
        if core.chunked:
            raise ValueError("generate_ring prefills by ring attention; "
                             "unset runtime.prefill_chunk")
        P = core.P
        if P % self.tp:
            raise ValueError(f"prefill length {P} not divisible by tp "
                             f"{self.tp}")
        pad = P - true_len
        tokens = torch.zeros((P,), dtype=torch.int64, device=core.device)
        tokens[pad:] = torch.from_numpy(ids).to(core.device)
        C = P // self.tp
        r = self.mesh.tp_rank
        logits, kv = ring_forward(
            self.cfg.model, core.params, tokens[r * C:(r + 1) * C], pad,
            true_len, self.comm, inner=inner,
            layer_params=lambda idx: gather_layer(core.params, idx,
                                                  self.comm))
        kv_h = kv if self.comm is None else self.comm.all_to_all(
            kv, split_dim=1, concat_dim=2)            # [L, H_loc, P, 2D]
        del kv
        core.admit_prefilled(0, kv_h, logits, pad, true_len)
        del kv_h
        return self._agree(core.decode_until_done(max_new_tokens,
                                                  eos_ids))[0]

    @property
    def hit_rate(self) -> float:
        """Device-cache hit rate over every rank's store."""
        st = self.core.store
        hm = torch.tensor([float(st.hits), float(st.misses)])
        if self.mesh.world_comm is not None:
            hm = torch.tensor(self.mesh.world_comm.all_gather_object(
                hm.tolist())).sum(0)
        h, m = hm.tolist()
        return h / (h + m) if h + m else 0.0
