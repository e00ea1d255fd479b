"""Single-sequence generation on the host-offload tier.

Counterpart of ``pqcache_tpu/runtime/offload_engine.py`` (``OffloadEngine``):
the offload core of ``runtime/offload_batch.py`` at one slot, driven a
token at a time, so that ``stream`` yields each token as its step ends.
"""

from __future__ import annotations

import numpy as np
import torch

from pqcache_tpu_torch.config import EngineConfig
from pqcache_tpu_torch.runtime.offload_batch import BatchOffloadEngine

_LIVE = np.ones((1,), bool)


class OffloadEngine(BatchOffloadEngine):
    """Single-sequence pq_search generation with host-offloaded KV: the
    offload core at one slot. device: cuda unless given; params are moved
    there in ``dtype``. ``selection_log`` (set to [] before ``generate``)
    records each exact step's per-layer block selections [H_kv, kb];
    ``logits_log`` the logits [V] of the prefill and of every step."""

    def __init__(self, cfg: EngineConfig, params: dict, dtype=torch.bfloat16,
                 device=None):
        super().__init__(cfg, params, batch_size=1, dtype=dtype,
                         device=device)

    def generate(self, prompt_ids, max_new_tokens: int, eos_ids=(), *,
                 noise=None, forced=None) -> list:
        return list(self.stream(prompt_ids, max_new_tokens, eos_ids,
                                noise=noise, forced=forced))

    @torch.no_grad()
    def stream(self, prompt_ids, max_new_tokens: int, eos_ids=(), *,
               noise=None, forced=None):
        """Generate, yielding each token as its step completes.

        noise: the sampler's noise source (``fill_``); a GumbelNoise of
        sample_seed when None. forced: teacher forcing for accuracy checks
        — after step i the next step is fed forced[i] instead of the
        token the step produced (which is still yielded)."""
        ids = np.asarray(prompt_ids, np.int64)
        self.setup(int(ids.shape[0]), max_new_tokens, noise)
        adm = self._admission_start(0, 0, ids)
        while not self._admission_step(adm):
            pass
        fed = self.slots[0].tokens[0]
        yield fed
        if forced is not None:
            fed = int(forced[0])
        for step in range(max_new_tokens - 1):
            if fed in eos_ids:
                break
            nxt = int(self._decode_step(np.asarray([fed]), _LIVE)[0])
            if self.logits_log is not None:
                self.logits_log[-1] = self.logits_log[-1][0]
            # the store's own count of complete-block rows, as a
            # single-sequence store keeps it
            self.store.valid[:] = self._valid[0]
            yield nxt
            fed = nxt if forced is None else int(forced[step + 1])
        self.store.flush()
