"""`infllm` policy: block-level context retrieval (InfLLM-style baseline).

Counterpart of ``pqcache_tpu/policies/infllm.py``. The context is cut into
fixed blocks of ``cache.block_size`` tokens; each block's N_REPR
representative tokens are those that received the most attention mass
during prefill (K4's "sum" columns, summed over each GQA group). At decode,
blocks are ranked by the GQA-summed maximum q . k_repr similarity and the
top ones are gathered whole into the window [sink | blocks | local | new].
Generated tokens form new blocks as they stream in: the attention mass that
local-window tokens receive is accumulated per step, and when a step
completes a block, its representative tokens are chosen by that mass.

Each layer writes its new token at slot ``length`` inside ``decode_attn``,
as JAX does: the local window and a block completed this step read it back.
JAX's dynamic slices move their start so the window fits, and its gathers
clamp indices into range; both are reproduced explicitly here (torch slicing
would silently shorten the window, and an out-of-range index would raise).
State is updated in place.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from pqcache_tpu_torch import resolve_device
from pqcache_tpu_torch.config import EngineConfig
from pqcache_tpu_torch.core.budget import Budget
from pqcache_tpu_torch.core.pq import _topk_stable
from pqcache_tpu_torch.ops.attention_ref import decode_window_attention
from pqcache_tpu_torch.ops.dispatch import dense_prefill_attention
from pqcache_tpu_torch.policies.base import register_policy, use_kernels
from pqcache_tpu_torch.runtime.state import DenseState, make_dense_state

N_REPR = 4  # representative tokens per block


@dataclass
class InfLLMState:
    dense: DenseState
    k_repr: torch.Tensor      # [L, H_kv, n_blocks, N_REPR, D]
    repr_valid: torch.Tensor  # [L, H_kv, n_blocks, N_REPR] bool
    gen_scores: torch.Tensor  # [L, H_kv, max_len] f32: decode attention mass
                              # received per token (streaming repr selection)


def _fit(start: int, size: int, extent: int) -> int:
    """The start jax.lax.dynamic_slice uses: moved so [start, start + size)
    lies inside [0, extent)."""
    return min(max(start, 0), extent - size)


@register_policy("infllm")
class InfLLMPolicy:
    deferred_appends = False

    def __init__(self, cfg: EngineConfig, budget: Budget, device=None):
        self.cfg = cfg
        self.budget = budget
        self.device = resolve_device(device)
        self.max_len = budget.prefill_len + budget.max_new_tokens
        m = cfg.model
        self.H_kv, self.group, self.D = m.num_kv_heads, m.num_groups, m.head_dim
        self.use_kernel = use_kernels(cfg)
        self.block = cfg.cache.block_size
        # the block grid covers the generated region too (streaming formation)
        self.n_blocks = (self.max_len + self.block - 1) // self.block
        # token budget -> number of retrieved blocks
        self.n_sel = max(budget.topk // self.block, 1)

    def init_state(self, dtype=torch.bfloat16) -> InfLLMState:
        L = self.cfg.model.num_layers
        z = dict(device=self.device)
        return InfLLMState(
            dense=make_dense_state(self.cfg, self.max_len, dtype=dtype, **z),
            k_repr=torch.zeros((L, self.H_kv, self.n_blocks, N_REPR, self.D),
                               dtype=dtype, **z),
            repr_valid=torch.zeros((L, self.H_kv, self.n_blocks, N_REPR),
                                   dtype=torch.bool, **z),
            gen_scores=torch.zeros((L, self.H_kv, self.max_len), **z))

    def prefill_attn(self, state: InfLLMState, idx: int, q, k, v,
                     pad_len: int, true_len: int):
        P = q.shape[1]
        out, F = dense_prefill_attention(q, k, v, pad_len, with_scores=True,
                                         use_kernel=self.use_kernel)
        # per-block representative tokens: the top N_REPR by received mass
        nb, bs = self.n_blocks, self.block
        kpos = torch.arange(nb * bs, device=q.device)
        s = torch.full((self.H_kv, nb * bs), -torch.inf, device=q.device)
        s[:, :P] = F.reshape(self.H_kv, self.group, P).sum(1)
        s = torch.where((kpos >= pad_len) & (kpos < P), s, -torch.inf)
        top_v, top_i = _topk_stable(s.reshape(self.H_kv, nb, bs), N_REPR)
        abs_idx = torch.clamp(top_i + kpos[::bs, None], max=P - 1)
        heads = torch.arange(self.H_kv, device=q.device)[:, None, None]
        d = state.dense
        d.k_cache[idx, :, :P] = k
        d.v_cache[idx, :, :P] = v
        d.length, d.start, d.pos = P, int(pad_len), int(true_len)
        state.k_repr[idx] = k[heads, abs_idx]           # [H_kv, nb, R, D]
        state.repr_valid[idx] = torch.isfinite(top_v)
        return out

    def decode_attn(self, state: InfLLMState, idx: int, q, k_new, v_new,
                    shared):
        b, bs = self.budget, self.block
        length, start = shared["length"], shared["start"]
        d = state.dense
        dt = d.k_cache.dtype
        d.k_cache[idx, :, length] = k_new[:, 0].to(dt)
        d.v_cache[idx, :, length] = v_new[:, 0].to(dt)
        k_l, v_l = d.k_cache[idx], d.v_cache[idx]          # [H_kv, T, D]
        T = k_l.shape[1]
        dev = q.device
        heads = torch.arange(self.H_kv, device=dev)[:, None]

        # block ranking: GQA sum of the max representative similarity
        qg = q.reshape(self.H_kv, self.group, self.D).float()
        sims = torch.einsum("hgd,hbrd->hgbr", qg, state.k_repr[idx].float())
        sims = torch.where(state.repr_valid[idx][:, None], sims, -torch.inf)
        block_score = sims.amax(-1).sum(1)                 # [H_kv, nb]
        # blocks inside the local window (or not yet formed) are excluded
        local_lo = length + 1 - b.local
        blk_start = torch.arange(self.n_blocks, device=dev) * bs
        block_score = torch.where(blk_start + bs <= local_lo, block_score,
                                  -torch.inf)
        sel_score, sel = _topk_stable(block_score, self.n_sel)
        # a selected block takes part only with a finite score (fewer than
        # n_sel finite blocks leave -inf ones selected)
        sel_ok = torch.isfinite(sel_score)

        # whole blocks, gathered with indices clamped into the cache as JAX
        # gathers clamp; a block straddling `start` masks its pad rows
        tok_idx = (sel[:, :, None] * bs
                   + torch.arange(bs, device=dev)).reshape(self.H_kv, -1)
        rows = tok_idx.clamp(max=T - 1)
        blk_mask = sel_ok.repeat_interleave(bs, 1) & (tok_idx >= start)

        # window = [sink | blocks | local | new]
        s0 = _fit(start, b.sink, T)
        lo = max(local_lo, 0)
        l0 = _fit(lo, b.local + 1, T)
        # JAX builds the local mask from the unmoved start
        loc_pos = lo + torch.arange(b.local + 1, device=dev)
        loc_mask = ((loc_pos >= start) & (loc_pos <= length)).expand(
            self.H_kv, -1)
        win = slice(l0, l0 + b.local + 1)
        k_win = torch.cat([k_l[:, s0:s0 + b.sink], k_l[heads, rows],
                           k_l[:, win]], 1)
        v_win = torch.cat([v_l[:, s0:s0 + b.sink], v_l[heads, rows],
                           v_l[:, win]], 1)
        win_mask = torch.cat([
            torch.ones((self.H_kv, b.sink), dtype=torch.bool, device=dev),
            blk_mask, loc_mask], 1)
        out, probs = decode_window_attention(q, k_win, v_win, win_mask,
                                             return_probs=True)

        # streaming block formation: accumulate the mass the local-window
        # tokens received (context_manager.py:196-815)
        gen = state.gen_scores[idx]                        # [H_kv, max_len]
        G = gen.shape[1]
        g0 = _fit(lo, b.local + 1, G)
        gen[:, g0:g0 + b.local + 1] += probs[:, b.sink + blk_mask.shape[1]:]
        # a step that completes a block picks its representative tokens by
        # accumulated mass and makes the block retrievable
        n_tok = length + 1
        if n_tok % bs == 0:
            cb = max(n_tok // bs - 1, 0)
            blk_lo = cb * bs
            b0 = _fit(blk_lo, bs, G)
            _, sidx = _topk_stable(gen[:, b0:b0 + bs], N_REPR)
            c0 = _fit(cb, 1, self.n_blocks)
            state.k_repr[idx, :, c0] = k_l[heads, sidx + blk_lo]
            state.repr_valid[idx, :, c0] = True
        return out, None

    def shared_pre(self, state: InfLLMState):
        return {"length": state.dense.length, "start": state.dense.start}

    def shared_post(self, state: InfLLMState, shared) -> None:
        state.dense.length += 1
        state.dense.pos += 1
