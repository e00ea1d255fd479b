"""DeepSeek-V2's decoder (``config.DeepseekV2Config``, arXiv 2405.04434)
in PyTorch: multi-head latent attention (MLA) and a mixture of experts.

The same entry points as ``models/afmoe.py`` (``init_params``,
``prefill``, ``prefill_chunked``, ``decode_step_batched``), the same
``pq_search`` policy and the same ``BatchedDecoder``; the layer equations
(``models/deepseek_v2_ref.py`` is their plain float32 reference, in the
expanded form throughout):

  h = h + attn(norm_in(h));  h = h + mlp(norm_post(h))
  attn(x): q = x W_q, per head [q_nope | q_pe];  [c | k_pe] = x W_kv_a,
           c = RMSNorm(c) (kv_norm);  per head k_nope = c W_uk,h^T and
           v = c W_uv,h (the two halves of DeepSeek's kv_b_proj);
           RoPE on q_pe and k_pe (YaRN inverse frequencies, adjacent pairs
           rotated, as DeepSeek's view_as_complex does), k_pe shared by the
           heads; logits [q_nope | q_pe] . [k_nope | k_pe] times
           ``softmax_scale``; out = concat_h(p v) W_o.
  mlp(x):  SwiGLU on the first ``first_k_dense_replace`` layers, else f32
           softmax router scores over the experts, the greedy top k, weights
           the selected scores (renormalised only with norm_topk_prob) times
           routed_scaling_factor; out = shared(x) + sum_e w_e expert_e(x)
           (``afmoe.experts``: grouped products, no capacity limit).

Prefill runs attention in the expanded form: each slab's latent rows
expand through W_uk / W_uv into every head's k_nope and v, and K2 runs at
q/k width qk_nope + qk_rope (192) with v width v_head_dim (128). The
absorbed form would multiply the whole 128k cache by 576-wide queries,
about 3.4 times the FLOPs. Decode runs the absorbed form against the
cache: the latent row [c | k_pe] is ONE kv head of head_dim 576, its first
kv_lora_rank columns the value, shared by every query head; head h's
query is [q_nope,h W_uk,h | q_pe,h] and its output (sum p c) W_uv,h. The
policy sees a GQA layer of one kv head and 16 query heads, and its
attention scales logits by 1/sqrt(576): the absorbed query is multiplied
by softmax_scale sqrt(576) once, in f32, before it is rounded to the
cache's dtype, so that the policy's scale gives MLA's.

Parameters are grouped by the layer's MLP kind, each group stacked over
its layers: ``params["dense"]`` and ``params["moe"]`` (``router`` [L_m,
E, X], ``experts_gate/up`` [L_m, X, E, I_e], ``experts_down`` [L_m, X,
I_e, E], the shared experts' ``shared_gate/up/down`` as one SwiGLU of
num_shared_experts x I_e); both carry the attention's ``wq`` [E, H·192],
``w_kv_a`` [E, 576], ``kv_norm`` [512], ``w_uk`` [H, 128, 512], ``w_uv``
[H, 512, 128], ``wo`` [H·128, E] and the norms ``ln_in``, ``ln_post``.
Weight products go through ``llama._mm``; norms, the
router and the expert combine run in f32.

Spans (``runtime/stages.py``): every prefill entry point is a ``prefill``
span; inside it each layer's slab attention (the W_uk / W_uv expansion of
the slab's latent rows and the K2 call) is a ``prefill_mla`` span and
each MoE layer's MLP a ``prefill_moe`` span (ids ``layer``); the counter
``moe.expert_load_max.layer<i>`` holds layer i's busiest expert's routed
rows over the mean. In a decode step the scope ``mla_absorb`` marks the
W_uk absorption of the query and the W_uv product of the output, and
``moe_route`` / ``moe_experts`` the router and the expert products.
"""

from __future__ import annotations

import math

import torch

from pqcache_tpu_torch import resolve_device
from pqcache_tpu_torch.config import DeepseekV2Config, yarn_mscale
from pqcache_tpu_torch.models.afmoe import experts, swiglu
from pqcache_tpu_torch.models.llama import (_logits, _mm, embed_lookup,
                                            lm_head_logits, rms_norm)
from pqcache_tpu_torch.ops.attention_ref import _bmm_f32
from pqcache_tpu_torch.ops.dispatch import prefill_chunk_attention
from pqcache_tpu_torch.runtime.stages import count, scope, span, stage

_NORMS = ("ln_in", "ln_post")


def init_params(cfg: DeepseekV2Config, generator: torch.Generator,
                dtype=torch.bfloat16, device=None, std: float = 0.02) -> dict:
    """Random parameters (normal, std ``std``; norms at 1) in the layout
    above, drawn from ``generator`` (on ``device``, cuda unless given)."""
    device = resolve_device(device)
    E, H = cfg.hidden_size, cfg.num_heads
    R, Dr = cfg.kv_lora_rank, cfg.qk_rope_head_dim
    Dn, Dv = cfg.qk_nope_head_dim, cfg.v_head_dim
    X, Ie = cfg.num_experts, cfg.moe_intermediate_size
    Ld = cfg.first_k_dense_replace
    Lm = cfg.num_layers - Ld

    def draw(*shape):
        return (torch.randn(shape, generator=generator, device=device)
                * std).to(dtype)

    def group(L, mats):
        g = {k: torch.stack([draw(*shape) for _ in range(L)])
             for k, shape in mats.items()}
        for k in _NORMS:
            g[k] = torch.ones((L, E), dtype=dtype, device=device)
        g["kv_norm"] = torch.ones((L, R), dtype=dtype, device=device)
        return g

    attn = dict(wq=(E, H * (Dn + Dr)), w_kv_a=(E, R + Dr),
                w_uk=(H, Dn, R), w_uv=(H, R, Dv), wo=(H * Dv, E))
    Is = Ie * cfg.num_shared_experts
    params = {
        "embed": draw(cfg.vocab_size, E),
        "final_norm": torch.ones(E, dtype=dtype, device=device),
        "dense": group(Ld, dict(attn, gate=(E, cfg.intermediate_size),
                                up=(E, cfg.intermediate_size),
                                down=(cfg.intermediate_size, E))),
        "moe": group(Lm, dict(attn, router=(E, X),
                              experts_gate=(X, E, Ie),
                              experts_up=(X, E, Ie),
                              experts_down=(X, Ie, E),
                              shared_gate=(E, Is), shared_up=(E, Is),
                              shared_down=(Is, E))),
    }
    params["lm_head"] = (params["embed"].T.contiguous()
                         if cfg.tie_word_embeddings
                         else draw(E, cfg.vocab_size))
    return params


def layer_params(cfg: DeepseekV2Config, params: dict, idx: int) -> dict:
    """Layer idx's arrays, from its kind's group."""
    Ld = cfg.first_k_dense_replace
    grp, j = ((params["dense"], idx) if idx < Ld
              else (params["moe"], idx - Ld))
    return {k: v[j] for k, v in grp.items()}


# -- RoPE ---------------------------------------------------------------------

def rope_inv_freq(cfg: DeepseekV2Config, device=None) -> torch.Tensor:
    """Inverse frequencies [qk_rope / 2] f32 of the rope columns: YaRN's
    blend of the interpolated (1 / factor) and the original frequencies
    over DeepSeek's correction range, or the plain ones without YaRN."""
    dim, base = cfg.qk_rope_head_dim, cfg.rope_theta
    pos = base ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                device=device) / dim)
    extra = 1.0 / pos
    f = cfg.yarn_factor
    if not f:
        return extra

    def corr(rot):
        return (dim * math.log(cfg.yarn_original_max_position
                               / (rot * 2 * math.pi))
                / (2 * math.log(base)))
    low = max(math.floor(corr(cfg.yarn_beta_fast)), 0)
    high = min(math.ceil(corr(cfg.yarn_beta_slow)), dim - 1)
    if low == high:
        high += 0.001
    ramp = torch.clamp((torch.arange(dim // 2, dtype=torch.float32,
                                     device=device) - low) / (high - low),
                       0, 1)
    keep = 1.0 - ramp                 # 1: the original frequency
    return extra / f * (1.0 - keep) + extra * keep


def rope_cos_sin(cfg: DeepseekV2Config, positions: torch.Tensor):
    """positions [...] int -> (cos, sin) [..., qk_rope / 2] f32, times
    YaRN's mscale(factor, mscale) / mscale(factor, mscale_all_dim) (1 at
    DeepSeek-V2's published 0.707 / 0.707)."""
    ang = positions.float()[..., None] * rope_inv_freq(cfg, positions.device)
    c, s = torch.cos(ang), torch.sin(ang)
    if cfg.yarn_factor and cfg.yarn_mscale_all_dim:
        m = (yarn_mscale(cfg.yarn_factor, cfg.yarn_mscale)
             / yarn_mscale(cfg.yarn_factor, cfg.yarn_mscale_all_dim))
        c, s = c * m, s * m
    return c, s


def rope_pairs(x: torch.Tensor, cos, sin) -> torch.Tensor:
    """Rotate adjacent pairs (x[..., 2i], x[..., 2i + 1]) of x [..., d] by
    the angles of cos/sin [..., d / 2] (broadcast against x's leading
    axes), as DeepSeek's complex multiply does; computed in f32, returned
    in x's dtype."""
    xf = x.float().reshape(*x.shape[:-1], -1, 2)
    a, b = xf[..., 0], xf[..., 1]
    return torch.stack([a * cos - b * sin, a * sin + b * cos],
                       -1).flatten(-2).to(x.dtype)


# -- attention pieces --------------------------------------------------------

def latent_rows(cfg: DeepseekV2Config, lp: dict, x: torch.Tensor, cos, sin):
    """The cached latent rows [T, 576] = [RMSNorm(c) | rope(k_pe)] of normed
    rows x [T, E] at the angles cos/sin [T, qk_rope / 2]."""
    R = cfg.kv_lora_rank
    y = _mm(x, lp, "w_kv_a")
    c = rms_norm(y[:, :R], lp["kv_norm"], cfg.rms_norm_eps)
    return torch.cat([c, rope_pairs(y[:, R:], cos, sin)], -1)


def queries(cfg: DeepseekV2Config, lp: dict, x: torch.Tensor, cos, sin):
    """Per-head queries of normed rows x [T, E] at the angles cos/sin
    [T, 1, qk_rope / 2]: (q_nope [T, H, 128], rope'd q_pe [T, H, 64])."""
    T, Dn = x.shape[0], cfg.qk_nope_head_dim
    q = _mm(x, lp, "wq").reshape(T, cfg.num_heads, cfg.qk_head_dim)
    return q[..., :Dn], rope_pairs(q[..., Dn:], cos, sin)


def expand(lp: dict, lat: torch.Tensor, H: int):
    """The expanded keys [H, T, 192] and values [H, T, 128] of latent rows
    lat [T, 576]: k = [c W_uk,h^T | k_pe], v = c W_uv,h."""
    R = lp["w_uk"].shape[-1]
    c = lat[:, :R]
    k_nope = torch.matmul(c, lp["w_uk"].transpose(1, 2))      # [H, T, 128]
    k_pe = lat[None, :, R:].expand(H, -1, -1)
    return torch.cat([k_nope, k_pe], -1), torch.matmul(c, lp["w_uv"])


def absorb(cfg: DeepseekV2Config, lp: dict, q_nope, q_pe, dtype):
    """The absorbed queries [B, H, 576] of q_nope [B, H, 128], q_pe
    [B, H, 64]: [q_nope,h W_uk,h | q_pe,h] in f32, times softmax_scale
    sqrt(576) (the policy scales by 1/sqrt(576)), rounded to ``dtype``
    once."""
    q_lat = _bmm_f32(q_nope.transpose(0, 1), lp["w_uk"]).transpose(0, 1)
    s = cfg.softmax_scale * math.sqrt(cfg.head_dim)
    return (torch.cat([q_lat, q_pe.float()], -1) * s).to(dtype)


# -- the MLP -----------------------------------------------------------------

def route(cfg: DeepseekV2Config, lp: dict, x: torch.Tensor):
    """Rows x [T, E] -> (combine weights [T, k] f32, experts [T, k]): f32
    softmax of x W_router, the greedy top k, their scores (divided by their
    sum + 1e-20 with norm_topk_prob) times routed_scaling_factor."""
    s = torch.softmax(x.float() @ lp["router"].float(), -1)
    w, sel = torch.topk(s, cfg.num_experts_per_tok, dim=-1)
    if cfg.norm_topk_prob:
        w = w / (w.sum(-1, keepdim=True) + 1e-20)
    return w * cfg.routed_scaling_factor, sel


def moe(cfg: DeepseekV2Config, lp: dict, x: torch.Tensor, routes=None):
    """The MoE MLP of normed rows x [T, E]. Returns (out [T, E] in x's
    dtype, the rows each expert took [X] on the device); appends the
    selected experts [T, k] to ``routes`` where given."""
    with scope("moe_route"):
        w, sel = route(cfg, lp, x)
    if routes is not None:
        routes.append(sel)
    with scope("moe_experts"):
        shared = swiglu(x, lp, ("shared_gate", "shared_up", "shared_down"))
        routed, counts = experts(lp, x, w, sel)
        return (shared.float() + routed).to(x.dtype), counts


def _mlp(cfg: DeepseekV2Config, lp: dict, idx: int, hidden, *,
         prefill: bool, routes=None):
    """The MLP's residual update of rows hidden [T, E]; a prefill's MoE in
    a ``prefill_moe`` span. Returns (the new rows, the MoE's per-expert
    counts or None)."""
    x = rms_norm(hidden, lp["ln_post"], cfg.rms_norm_eps)
    counts = None
    if idx < cfg.first_k_dense_replace:
        m = swiglu(x, lp, ("gate", "up", "down"))
    elif prefill:
        with span("prefill_moe", layer=idx):
            m, counts = moe(cfg, lp, x)
    else:
        m, _ = moe(cfg, lp, x, routes=routes)
    return hidden + m, counts


# -- prefill -------------------------------------------------------------------

@torch.no_grad()
def prefill_chunked(cfg: DeepseekV2Config, params: dict, policy, state,
                    tokens: torch.Tensor, pad_len: int, true_len: int, *,
                    chunk: int, comm=None):
    """A LEFT-padded prompt tokens [P] in slabs of ``chunk`` rows: per layer
    (A) the latent rows of all rows, (B) per slab its queries, the W_uk /
    W_uv expansion of its latent rows into the layer's expanded keys and
    values (kept for the later slabs), K2 at q_offset against the keys
    before it (192 / 128, ``softmax_scale``) and its MLP, (C) the policy's
    ``prefill_tail`` on the latent rows (keys [1, P, 576], values their
    first kv_lora_rank columns). Returns the last token's logits [V] f32."""
    if comm is not None:
        raise ValueError("deepseek_v2 has no tensor-parallel path")
    P = tokens.shape[0]
    if P % chunk:
        raise ValueError(f"prefill length {P} not a multiple of chunk "
                         f"{chunk}")
    use_kernel = getattr(policy, "use_kernel", True)
    H, R, eps = cfg.num_heads, cfg.kv_lora_rank, cfg.rms_norm_eps
    with span("prefill", tokens=P):
        hidden = embed_lookup(params, tokens)
        positions = torch.clamp(
            torch.arange(P, device=tokens.device) - pad_len, min=0)
        cos, sin = rope_cos_sin(cfg, positions)
        for idx in range(cfg.num_layers):
            lp = layer_params(cfg, params, idx)
            lat = torch.empty((P, cfg.head_dim), dtype=hidden.dtype,
                              device=hidden.device)
            for c0 in range(0, P, chunk):
                c1 = c0 + chunk
                lat[c0:c1] = latent_rows(
                    cfg, lp, rms_norm(hidden[c0:c1], lp["ln_in"], eps),
                    cos[c0:c1], sin[c0:c1])
            k = torch.empty((H, P, cfg.qk_head_dim), dtype=hidden.dtype,
                            device=hidden.device)
            v = torch.empty((H, P, cfg.v_head_dim), dtype=hidden.dtype,
                            device=hidden.device)
            loads = None
            for c0 in range(0, P, chunk):
                c1 = c0 + chunk
                x = rms_norm(hidden[c0:c1], lp["ln_in"], eps)
                q_nope, q_pe = queries(cfg, lp, x, cos[c0:c1, None],
                                       sin[c0:c1, None])
                q = torch.cat([q_nope, q_pe], -1).transpose(0, 1)
                with span("prefill_mla", layer=idx):
                    k[:, c0:c1], v[:, c0:c1] = expand(lp, lat[c0:c1], H)
                    att = prefill_chunk_attention(
                        q.contiguous(), k[:, :c1], v[:, :c1], pad_len,
                        q_offset=c0, use_kernel=use_kernel,
                        scale=cfg.softmax_scale)
                o = _mm(att.transpose(0, 1).reshape(c1 - c0, -1), lp, "wo")
                hidden[c0:c1], counts = _mlp(cfg, lp, idx,
                                             hidden[c0:c1] + o, prefill=True)
                if counts is not None:
                    loads = counts if loads is None else loads + counts
            del k, v
            if loads is not None:
                loads = loads.tolist()
                count(f"moe.expert_load_max.layer{idx}",
                      max(loads) * len(loads) / max(sum(loads), 1))
            policy.prefill_tail(state, idx, lat[None], lat[None, :, :R],
                                pad_len, true_len)
        return _logits(cfg, params, hidden[P - 1:P])


@torch.no_grad()
def prefill(cfg: DeepseekV2Config, params: dict, policy, state,
            tokens: torch.Tensor, pad_len: int, true_len: int, comm=None):
    """``prefill_chunked`` in one slab of the whole prompt."""
    return prefill_chunked(cfg, params, policy, state, tokens, pad_len,
                           true_len, chunk=tokens.shape[0], comm=comm)


# -- decode --------------------------------------------------------------------

@torch.no_grad()
def decode_step_batched(cfg: DeepseekV2Config, params: dict, policy, state,
                        tokens: torch.Tensor, pos: torch.Tensor, comm=None,
                        routes=None):
    """One greedy-decode step for B slots: tokens, pos [B] int tensors on
    the device. Returns logits [B, V] f32. Every count stays on the device,
    so the step can be captured into a CUDA graph. ``routes``: a list that
    receives each MoE layer's selected experts [B, k] (eager steps)."""
    if comm is not None:
        raise ValueError("deepseek_v2 has no tensor-parallel path")
    B = tokens.shape[0]
    H, R, eps = cfg.num_heads, cfg.kv_lora_rank, cfg.rms_norm_eps
    with stage("embed_rope"):
        hidden = embed_lookup(params, tokens)                # [B, E]
        cos, sin = rope_cos_sin(cfg, pos)                    # [B, 32]
        shared = policy.shared_pre_batched(state)
    ks, vs = [], []
    for idx in range(cfg.num_layers):
        lp = layer_params(cfg, params, idx)
        with stage("qkv"):
            x = rms_norm(hidden, lp["ln_in"], eps)
            q_nope, q_pe = queries(cfg, lp, x, cos[:, None], sin[:, None])
            lat = latent_rows(cfg, lp, x, cos, sin)          # [B, 576]
        with scope("mla_absorb"):
            q = absorb(cfg, lp, q_nope, q_pe, lat.dtype)     # [B, H, 576]
        attn, payload = policy.decode_attn_batched(
            state, idx, q, lat[:, None], lat[:, None, :R], shared)
        ks.append(payload[0])
        vs.append(payload[1])
        with scope("mla_absorb"):
            o = torch.matmul(attn.transpose(0, 1), lp["w_uv"])  # [H, B, 128]
        with stage("out_mlp"):
            o = _mm(o.transpose(0, 1).reshape(B, -1), lp, "wo")
            hidden, _ = _mlp(cfg, lp, idx, hidden + o, prefill=False,
                             routes=routes)
    with stage("commit"):
        policy.commit_appends_batched(
            state, (torch.stack(ks), torch.stack(vs)), shared)
        policy.shared_post_batched(state, shared)
    with stage("lm_head"):
        last = rms_norm(hidden, params["final_norm"], eps)
        return lm_head_logits(params, last)

