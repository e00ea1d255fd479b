"""`h2o` policy: Heavy-Hitter Oracle with accumulated attention scores.

Counterpart of ``pqcache_tpu/policies/h2o.py``. The full KV cache stays, but
attention is masked to [sink | the heavy_budget mid tokens of largest
accumulated score | recent window]. Prefill scores are the per-key softmax
columns of K4 (``score_func`` "sum" or "max"), summed over each GQA group;
after each decode step the step's attention probabilities are added to the
scores and the keep-mask is rebuilt. Scores outside the kept set are zeroed.

Decode attends the valid span [start, length] of the cache under the mask
(JAX masks the whole buffer; slots outside the span carry probability 0
there, so the scores and the output are the same). Each layer writes its new
token at slot ``length`` inside ``decode_attn``, as JAX does. State is
updated in place.
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


@register_policy("h2o")
class H2OPolicy:
    deferred_appends = False

    def __init__(self, cfg: EngineConfig, budget: Budget, device=None):
        self.cfg = cfg
        self.budget = budget
        self.device = resolve_device(device)
        self.max_len = budget.prefill_len + budget.max_new_tokens
        m = cfg.model
        self.H_kv, self.group, self.D = m.num_kv_heads, m.num_groups, m.head_dim
        self.use_kernel = use_kernels(cfg)
        # budgets fixed at prefill (baseline_compressor.py:121-123)
        n = budget.prefill_len - budget.sink
        r = cfg.budget.compress_ratio
        self.heavy_budget = int(r * (1.0 - cfg.budget.recent_ratio) * n)
        self.recent_budget = int(r * cfg.budget.recent_ratio * n)

    def init_state(self, dtype=torch.bfloat16) -> DenseState:
        return make_dense_state(self.cfg, self.max_len, with_scores=True,
                                dtype=dtype, device=self.device)

    def _build_mask(self, scores: torch.Tensor, start: int, length: int):
        """Keep-mask over cache slots [H_kv, T]: sink + recent + the top
        heavy_budget mid slots by score (baseline_compressor.py:133-148).
        Ties go to the lower slot, as in jax.lax.top_k."""
        T = scores.shape[-1]
        kpos = torch.arange(T, device=scores.device)
        valid = (kpos >= start) & (kpos <= length)
        mid = (valid & (kpos >= start + self.budget.sink)
               & (kpos < length + 1 - self.recent_budget))
        g_mid = torch.where(mid, scores, -torch.inf)
        _, top = _topk_stable(g_mid, max(self.heavy_budget, 1))
        keep_mid = torch.zeros((self.H_kv, T), dtype=torch.bool,
                               device=scores.device).scatter_(1, top, True)
        return valid & (~mid | keep_mid)

    def prefill_attn(self, state: DenseState, idx: int, q, k, v,
                     pad_len: int, true_len: int):
        P = q.shape[1]
        out, F = dense_prefill_attention(
            q, k, v, pad_len, with_scores=True,
            score_mode=self.cfg.runtime.score_func,
            use_kernel=self.use_kernel)
        # GQA reduction of per-q-head columns -> per-kv-head scores
        # (baseline_compressor.py:169-171)
        scores = torch.zeros_like(state.scores[idx])
        scores[:, :P] = F.reshape(self.H_kv, self.group, P).sum(1)
        mask = self._build_mask(scores, int(pad_len), P - 1)
        state.k_cache[idx, :, :P] = k
        state.v_cache[idx, :, :P] = v
        state.scores[idx] = torch.where(mask, scores, 0.0)
        state.mask[idx] = mask
        state.length, state.start, state.pos = P, int(pad_len), int(true_len)
        return out

    def decode_attn(self, state: DenseState, idx: int, q, k_new, v_new,
                    shared):
        length, start = shared["length"], shared["start"]
        dt = state.k_cache.dtype
        state.k_cache[idx, :, length] = k_new[:, 0].to(dt)
        state.v_cache[idx, :, length] = v_new[:, 0].to(dt)
        span = slice(start, length + 1)
        # the new token (the span's last slot) is always attendable
        keep = state.mask[idx, :, span].clone()
        keep[:, -1] = True
        qg = q.reshape(self.H_kv, self.group, self.D).float()
        logits = torch.einsum("hgd,htd->hgt", qg,
                              state.k_cache[idx, :, span].float()) / math.sqrt(
                                  self.D)
        w = torch.softmax(torch.where(keep[:, None, :], logits, NEG_INF), -1)
        out = torch.einsum("hgt,htd->hgd", w,
                           state.v_cache[idx, :, span].float())
        # accumulate scores and rebuild the mask (baseline_compressor.py:155-198)
        scores = state.scores[idx]
        scores[:, span] += w.sum(1)
        mask = self._build_mask(scores, start, length)
        state.scores[idx] = torch.where(mask, scores, 0.0)
        state.mask[idx] = mask
        return out.reshape(-1, 1, self.D).to(q.dtype), None

    def shared_pre(self, state: DenseState):
        return {"length": state.length, "start": state.start}

    def shared_post(self, state: DenseState, shared) -> None:
        state.length += 1
        state.pos += 1
