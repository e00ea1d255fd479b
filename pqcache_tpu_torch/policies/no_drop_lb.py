"""`no_drop_lb` policy: the oracle budget baseline.

Counterpart of ``pqcache_tpu/policies/no_drop_lb.py`` (the reference's
fullKVLimitBasedCompressor, baseline_compressor.py:205-294). The full KV
cache stays; at every decode step the exact softmax scores of the step,
summed over each GQA group over the non-sink, non-recent region, keep the
top ``high_budget`` positions there, plus the sink and the recent window,
and the kept set is re-softmaxed. No top-k retrieval at the same budget can
do better. Prefill is dense attention (K2). Each layer writes its new token
at slot ``length`` inside ``decode_attn``. State is updated in place.
"""

from __future__ import annotations

import math

import torch

from pqcache_tpu_torch import resolve_device
from pqcache_tpu_torch.config import EngineConfig
from pqcache_tpu_torch.core.budget import Budget
from pqcache_tpu_torch.core.pq import _topk_stable
from pqcache_tpu_torch.ops.attention_ref import NEG_INF
from pqcache_tpu_torch.ops.dispatch import dense_prefill_attention
from pqcache_tpu_torch.policies.base import register_policy, use_kernels
from pqcache_tpu_torch.runtime.state import DenseState, make_dense_state


@register_policy("no_drop_lb")
class NoDropLBPolicy:
    deferred_appends = False

    def __init__(self, cfg: EngineConfig, budget: Budget, device=None):
        self.cfg = cfg
        self.budget = budget
        self.device = resolve_device(device)
        self.max_len = budget.prefill_len + budget.max_new_tokens
        m = cfg.model
        self.H_kv, self.group, self.D = m.num_kv_heads, m.num_groups, m.head_dim
        self.use_kernel = use_kernels(cfg)
        # baseline_compressor.py:248-251 with h2o_ratio = 1 - recent_ratio
        n = budget.prefill_len - budget.sink
        total = int(n * cfg.budget.compress_ratio)
        self.high_budget = int(total * (1.0 - cfg.budget.recent_ratio))
        self.local_budget = total - self.high_budget

    def init_state(self, dtype=torch.bfloat16) -> DenseState:
        return make_dense_state(self.cfg, self.max_len, dtype=dtype,
                                device=self.device)

    def prefill_attn(self, state: DenseState, idx: int, q, k, v,
                     pad_len: int, true_len: int):
        P = q.shape[1]
        out, _ = dense_prefill_attention(q, k, v, pad_len,
                                         use_kernel=self.use_kernel)
        state.k_cache[idx, :, :P] = k
        state.v_cache[idx, :, :P] = v
        state.length, state.start, state.pos = P, int(pad_len), int(true_len)
        return out

    def decode_attn(self, state: DenseState, idx: int, q, k_new, v_new,
                    shared):
        length, start = shared["length"], shared["start"]
        dt = state.k_cache.dtype
        state.k_cache[idx, :, length] = k_new[:, 0].to(dt)
        state.v_cache[idx, :, length] = v_new[:, 0].to(dt)
        k_cache, v_cache = state.k_cache[idx], state.v_cache[idx]
        T = k_cache.shape[1]
        kpos = torch.arange(T, device=q.device)
        valid = (kpos >= start) & (kpos <= length)
        # budget regions (baseline_compressor.py:265-266): the recent window
        # moves with the sequence; the sink is the first `sink` real tokens
        mid = (valid & (kpos >= start + self.budget.sink)
               & (kpos < length + 1 - self.local_budget))
        qg = q.reshape(self.H_kv, self.group, self.D).float()
        logits = torch.einsum("hgd,htd->hgt", qg,
                              k_cache.float()) / math.sqrt(self.D)
        logits = torch.where(valid, logits, NEG_INF)
        # exact current-step importance (baseline_compressor.py:268-272)
        g_scores = torch.softmax(logits, -1).sum(1)          # [H_kv, T]
        g_mid = torch.where(mid, g_scores, -torch.inf)
        _, top = _topk_stable(g_mid, max(self.high_budget, 1))
        keep_mid = torch.zeros((self.H_kv, T), dtype=torch.bool,
                               device=q.device).scatter_(1, top, True) & mid
        keep = valid & (~mid | keep_mid)
        w = torch.softmax(torch.where(keep[:, None, :], logits, NEG_INF), -1)
        out = torch.einsum("hgt,htd->hgd", w, v_cache.float())
        return out.reshape(-1, 1, self.D).to(q.dtype), None

    def shared_pre(self, state: DenseState):
        return {"length": state.length, "start": state.start}

    def shared_post(self, state: DenseState, shared) -> None:
        state.length += 1
        state.pos += 1
