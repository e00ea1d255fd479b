"""`sparq_f` policy: SparQ approximate attention.

Counterpart of ``pqcache_tpu/policies/sparq.py`` (the reference's
SparQCompressorGPU, sparq.py:108-180, over the vendored AnnAttention,
ann_attention.py:77-119, 254-352). K/V stay in a dense device cache. Per
decode step and layer:

  1. the top-r components of |q| summed over each GQA group select r
     columns of K; approximate logits over them, scaled by
     sqrt((|q_r|_1 / |q|_1) * D);
  2. the local window and the sink forced in, the group sum ranked, the
     top (k + sink) positions taken;
  3. dense attention over the taken positions (the new token among them);
  4. with ``sparq_mean_v_trick``, the approximate probability mass left
     out goes to the running mean of the values.

Every ``jax.lax.top_k`` of the JAX policy breaks ties toward the lower
index; ``core/pq._topk_stable`` does the same here. Prefill is dense
attention (K2). Each layer writes its new token at slot ``length`` inside
``decode_attn``. State is updated in place.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from pqcache_tpu_torch import resolve_device
from pqcache_tpu_torch.config import EngineConfig
from pqcache_tpu_torch.core.budget import Budget
from pqcache_tpu_torch.core.pq import _topk_stable
from pqcache_tpu_torch.ops.attention_ref import NEG_INF
from pqcache_tpu_torch.ops.dispatch import dense_prefill_attention
from pqcache_tpu_torch.policies.base import register_policy, use_kernels
from pqcache_tpu_torch.runtime.state import DenseState, make_dense_state


@dataclass
class SparqState:
    dense: DenseState
    mean_v: torch.Tensor     # [L, H_kv, 1, D] f32 running mean of the values


@register_policy("sparq_f")
class SparqPolicy:
    deferred_appends = False

    def __init__(self, cfg: EngineConfig, budget: Budget, device=None):
        self.cfg = cfg
        self.budget = budget
        self.device = resolve_device(device)
        self.max_len = budget.prefill_len + budget.max_new_tokens
        m = cfg.model
        self.H_kv, self.group, self.D = m.num_kv_heads, m.num_groups, m.head_dim
        self.use_kernel = use_kernels(cfg)
        self.r = min(cfg.runtime.sparq_topr, m.head_dim)
        self.mean_v_trick = cfg.runtime.sparq_mean_v_trick
        # sparq.py:63-64: budget = ctx * compress, local = budget * recent
        self.k_budget = int(budget.prefill_len * cfg.budget.compress_ratio)
        self.local_k = int(self.k_budget * cfg.budget.recent_ratio)

    def init_state(self, dtype=torch.bfloat16) -> SparqState:
        dense = make_dense_state(self.cfg, self.max_len, dtype=dtype,
                                 device=self.device)
        L = self.cfg.model.num_layers
        return SparqState(dense=dense, mean_v=torch.zeros(
            (L, self.H_kv, 1, self.D), device=self.device))

    def prefill_attn(self, state: SparqState, idx: int, q, k, v,
                     pad_len: int, true_len: int):
        P = q.shape[1]
        out, _ = dense_prefill_attention(q, k, v, pad_len,
                                         use_kernel=self.use_kernel)
        d = state.dense
        d.k_cache[idx, :, :P] = k
        d.v_cache[idx, :, :P] = v
        d.length, d.start, d.pos = P, int(pad_len), int(true_len)
        # the running mean over the real values (sparq.py:61)
        state.mean_v[idx] = (v[:, int(pad_len):].float().sum(1, keepdim=True)
                             / max(P - int(pad_len), 1))
        return out

    def decode_attn(self, state: SparqState, idx: int, q, k_new, v_new,
                    shared):
        length, start = shared["length"], shared["start"]
        d = state.dense
        dt = d.k_cache.dtype
        d.k_cache[idx, :, length] = k_new[:, 0].to(dt)
        d.v_cache[idx, :, length] = v_new[:, 0].to(dt)
        k_cache, v_cache = d.k_cache[idx], d.v_cache[idx]
        T = k_cache.shape[1]
        kpos = torch.arange(T, device=q.device)
        valid = (kpos >= start) & (kpos <= length)
        qg = q.reshape(self.H_kv, self.group, self.D).float()

        # 1. top-r |q| components, group-summed (ann_attention.py:94-97)
        _, ridx = _topk_stable(qg.abs().sum(1), self.r)      # [H_kv, r]
        q_r = qg.gather(-1, ridx[:, None, :].expand(-1, self.group, -1))
        k_r = k_cache.float().gather(-1, ridx[:, None, :].expand(-1, T, -1))
        # scale = sqrt(coverage * D) (ann_attention.py:111-118)
        cov = q_r.abs().sum(-1) / torch.clamp(qg.abs().sum(-1), min=1e-9)
        scale = torch.sqrt(cov * self.D)[..., None]          # [H_kv, g, 1]
        approx = torch.einsum("hgr,htr->hgt", q_r, k_r) / scale
        approx = torch.where(valid, approx, NEG_INF)

        # 2. force local + sink, group-sum, top-(k + sink)
        # (ann_attention.py:292-304)
        forced = valid & ((kpos >= length + 1 - self.local_k)
                          | (kpos < start + self.budget.sink))
        g_score = torch.where(forced, 1e30, approx).sum(1)    # [H_kv, T]
        n_sel = min(self.k_budget + self.budget.sink, T)
        _, sel = _topk_stable(torch.where(valid, g_score, -torch.inf), n_sel)

        # 3. dense attention over the selected set (invalid picks masked)
        rows = sel[:, :, None].expand(-1, -1, self.D)
        k_sel = k_cache.gather(1, rows).float()
        v_sel = v_cache.gather(1, rows).float()
        sel_valid = valid[sel]                                # [H_kv, n_sel]
        logits = torch.einsum("hgd,hsd->hgs", qg, k_sel) / math.sqrt(self.D)
        w = torch.softmax(torch.where(sel_valid[:, None, :], logits,
                                      NEG_INF), -1)
        out = torch.einsum("hgs,hsd->hgd", w, v_sel)

        # 4. mean-value reallocation (ann_attention.py:315-330)
        n_real = float(length + 1 - start)
        mean_v = (state.mean_v[idx] * (n_real - 1)
                  + v_new.float()) / n_real
        if self.mean_v_trick:
            norm_all = torch.softmax(approx, -1)              # [H_kv, g, T]
            kv_weight = norm_all.gather(
                -1, sel[:, None, :].expand(-1, self.group, -1)).sum(-1)
            out = (out * kv_weight[..., None]
                   + (1.0 - kv_weight[..., None]) * mean_v)
        state.mean_v[idx] = mean_v
        return out.reshape(-1, 1, self.D).to(q.dtype), None

    def shared_pre(self, state: SparqState):
        return {"length": state.dense.length, "start": state.dense.start}

    def shared_post(self, state: SparqState, shared) -> None:
        state.dense.length += 1
        state.dense.pos += 1
