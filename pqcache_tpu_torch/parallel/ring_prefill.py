"""Sequence-parallel (ring) prefill: prompts beyond one card's memory.

Counterpart of ``pqcache_tpu/parallel/ring_prefill.py``. Each rank holds a
contiguous P / sp-token slice of the left-padded prompt (activations, K/V
and PQ codes all scale with P / sp) and causal attention runs as RING
ATTENTION: the K/V slices travel around the group (``Comm.ring_shift``,
JAX's ppermute) while every rank accumulates online-softmax attention of
its queries against each visiting slice, tiled by ``inner`` keys to bound
the [g, Cq, inner] logits. Norms and MLP are per token and need no
communication. The accumulation is plain PyTorch in float32, as the JAX
step is XLA einsums: no Pallas kernel is on this path.

A visiting slice from a later rank lies wholly in the future of every
query here, so its accumulation (which would add nothing: every logit is
masked) is skipped, and the last rotation, whose slices no rank reads, is
not sent: both give the JAX program's values.

Codebooks train by DISTRIBUTED Lloyd (``core/pq.kmeans(comm=...)``): the
per-iteration sums and counts are all-reduced, so the centroids are
replicated while the codes stay beside their K/V rows (``sp_prefill``).

The serving handoff (``gather_state_tp``) is one all-to-all that reshards
the K/V from sequence-major to head-major, then the local policy's
``prefill_tail`` per layer: the code path the TP engines prefill through,
so decode after a ring prefill gives ``generate``'s tokens.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from pqcache_tpu_torch.config import EngineConfig
from pqcache_tpu_torch.core import pq
from pqcache_tpu_torch.models import llama

NEG_INF = -1e30


def _block_attn_accum(q, k, v, qpos, kpos, kvalid, m, l, acc, *,
                      inner: int = 512):
    """Accumulate online-softmax attention of q against one K/V block, in
    place. q [H, Cq, D]; k/v [H_kv, Ck, D]; qpos [Cq], kpos [Ck] global
    positions; kvalid [Ck] bool. Carries m / l [H_kv, g, Cq] and acc
    [H_kv, g, Cq, D] f32."""
    H, Cq, D = q.shape
    H_kv, Ck, _ = k.shape
    qg = q.reshape(H_kv, H // H_kv, Cq, D).float() * (1.0 / D ** 0.5)
    for c0 in range(0, Ck, inner):
        k_i = k[:, c0:c0 + inner].float()
        v_i = v[:, c0:c0 + inner].float()
        mask = kvalid[None, c0:c0 + inner] & (
            kpos[None, c0:c0 + inner] <= qpos[:, None])       # [Cq, k]
        lg = torch.einsum("hgqd,hkd->hgqk", qg, k_i)
        lg = torch.where(mask, lg, NEG_INF)
        m_new = torch.maximum(m, lg.amax(-1))
        p = torch.where(mask, torch.exp(lg - m_new[..., None]), 0.0)
        corr = torch.exp(m - m_new)
        l.mul_(corr).add_(p.sum(-1))
        acc.mul_(corr[..., None]).add_(torch.einsum("hgqk,hkd->hgqd", p, v_i))
        m.copy_(m_new)


def ring_attention(q, k, v, qpos, kpos, kvalid, comm, *, inner: int = 512):
    """Causal ring attention over a sequence-sharded prompt, rank r holding
    slice r: q [H, C, D], k/v [H_kv, C, D], with their global positions and
    key validity. Returns out [H, C, D] in q's dtype. comm None: one
    slice."""
    H, Cq, D = q.shape
    H_kv = k.shape[0]
    g = H // H_kv
    sp, rank = (1, 0) if comm is None else (comm.size, comm.rank)
    m = torch.full((H_kv, g, Cq), NEG_INF, device=q.device)
    l = torch.zeros((H_kv, g, Cq), device=q.device)
    acc = torch.zeros((H_kv, g, Cq, D), device=q.device)
    blk = [k, v, kpos, kvalid]
    for s in range(sp):
        if (rank - s) % sp <= rank:       # a later rank's slice is future
            _block_attn_accum(q, blk[0], blk[1], qpos, blk[2], blk[3], m, l,
                              acc, inner=inner)
        if s < sp - 1:
            blk = comm.ring_shift(blk)
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(H, Cq, D).to(q.dtype)


@torch.no_grad()
def ring_forward(model_cfg, params: dict, tokens_local: torch.Tensor,
                 pad_len: int, true_len: int, comm, *, inner: int = 512,
                 layer_params: Optional[Callable[[int], dict]] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sequence-sharded full-decoder forward, ring attention per layer.

    tokens_local [C]: this rank's slice [r·C, (r+1)·C) of the LEFT-padded
    P-token prompt. Every rank computes all heads for its tokens, with
    layer idx's whole weights ``layer_params(idx)``: by default params'
    own (replicated weights); the TP engines rebuild each layer from the
    group's shards as they reach it (``sharding.gather_layer``), so no
    process holds the whole model. params gives the embedding, the final
    norm and the LM head. Returns (logits [V] f32 of the last real token,
    replicated; kv_local [L, H_kv, C, 2D], this slice's K‖V rows)."""
    m = model_cfg
    C = tokens_local.shape[0]
    r = 0 if comm is None else comm.rank
    g0 = r * C
    dev = tokens_local.device
    hidden = llama.embed_lookup(params, tokens_local)
    gpos = g0 + torch.arange(C, device=dev)
    cos, sin = llama.rope_cos_sin(m, torch.clamp(gpos - pad_len, min=0))
    valid = (gpos >= pad_len) & (gpos < pad_len + true_len)
    if layer_params is None:
        def layer_params(idx):
            return llama._layer_params(params, idx)
    kvs = []
    for idx in range(m.num_layers):
        lp = layer_params(idx)
        h_norm = llama.rms_norm(hidden, lp["ln1"], m.rms_norm_eps)
        yq, yk, yv = llama._products(h_norm, lp, ("wq", "wk", "wv"))
        k, v = llama._rope_kv(m, yk, yv, cos, sin)
        q = llama._rope_q(m, yq, cos, sin)
        out = ring_attention(q, k, v, gpos, gpos, valid, comm, inner=inner)
        hidden = llama._finish_layer(m, lp, hidden,
                                     out.transpose(0, 1).reshape(C, -1))
        kvs.append(torch.cat([k, v], -1))
    # the last real token (global index pad + true_len - 1) lives on one
    # rank; the others contribute zeros to the sum that replicates it
    last_g = pad_len + true_len - 1
    h_last = torch.zeros_like(hidden[:1])
    if g0 <= last_g < g0 + C:
        h_last.copy_(hidden[last_g - g0:last_g - g0 + 1])
    if comm is not None:
        comm.all_reduce(h_last)
    return llama._logits(m, params, h_last), torch.stack(kvs)


@torch.no_grad()
def sp_prefill(cfg: EngineConfig, params: dict, tokens_local: torch.Tensor,
               pad_len: int, true_len: int, comm, *, inner: int = 512):
    """Sequence-sharded prefill and distributed PQ build. Returns (logits
    [V] replicated, kv_local [L, H_kv, C, 2D], codes_local [L, H_kv, S, C]
    uint8 (the codes of sink and pad rows are meaningless: mask them by
    position), centroids [L, H_kv, S, C_cent, d(+1)] replicated, phi
    [L, H_kv·S, 1, 1] replicated: the "ip" lift's GLOBAL per-group largest
    |x|^2, one all-reduce max; zeros for "euc")."""
    m = cfg.model
    S = cfg.pq.n_subvec_per_head
    C_cent = cfg.pq.n_centroids
    C = tokens_local.shape[0]
    r = 0 if comm is None else comm.rank
    logits, kv_layers = ring_forward(m, params, tokens_local, pad_len,
                                     true_len, comm, inner=inner)
    gpos = r * C + torch.arange(C, device=tokens_local.device)
    # retrieval candidates: the real tokens after the sink
    is_tail = (gpos >= pad_len + cfg.budget.sink_size) & (
        gpos < pad_len + true_len)
    G = m.num_kv_heads * S
    cents, codes, phis = [], [], []
    for kv in kv_layers:
        xb = pq.to_groups(kv[..., :m.head_dim], S).float()
        if cfg.pq.metric == "ip":
            norms = (xb * xb).sum(-1, keepdim=True)          # [G, C, 1]
            phi = torch.where(is_tail[None, :, None], norms,
                              0.0).amax(-2, keepdim=True)
            if comm is not None:
                comm.all_reduce(phi, op="max")
            xb = torch.cat([xb, torch.sqrt(torch.clamp(phi - norms,
                                                       min=0.0))], -1)
        else:
            phi = torch.zeros((G, 1, 1), device=xb.device)
        res = pq.kmeans(xb, C_cent, iters=cfg.pq.kmeans_iters,
                        seed=cfg.pq.kmeans_seed, comm=comm,
                        valid_mask=is_tail[None, :])
        cents.append(res.centroids.reshape(m.num_kv_heads, S, C_cent, -1))
        codes.append(res.codes.reshape(m.num_kv_heads, S, C).to(torch.uint8))
        phis.append(phi)
    return (logits, kv_layers, torch.stack(codes), torch.stack(cents),
            torch.stack(phis))


@torch.no_grad()
def gather_state_tp(policy, kv_layers: torch.Tensor, pad_len: int,
                    true_len: int, comm, dtype=torch.bfloat16):
    """Ring-prefill -> decode handoff. kv_layers [L, H_kv, C, 2D]: this
    rank's token slice, all kv heads. One all-to-all sends token slice j of
    head block i to rank i (H_kv % sp == 0), giving [L, H_kv / sp, sp·C,
    2D], the whole sequence of this rank's heads in global order; the
    local ``policy`` (heads divided by sp, ``policy.shard`` set) then
    builds the PQ state through its ``prefill_tail``. Returns the state."""
    D = policy.D
    kv_h = (kv_layers if comm is None
            else comm.all_to_all(kv_layers, split_dim=1, concat_dim=2))
    state = policy.init_state(dtype)
    for idx in range(kv_h.shape[0]):
        policy.prefill_tail(state, idx, kv_h[idx, ..., :D],
                            kv_h[idx, ..., D:], pad_len, true_len)
    return state
