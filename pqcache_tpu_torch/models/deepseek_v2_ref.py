"""Plain float32 reference of DeepSeek-V2's decoder
(``config.DeepseekV2Config``).

The whole forward pass of one unpadded token sequence from the parameters
of ``models/deepseek_v2.py`` (read, cast to float32, never changed): plain
torch operations, no kernel of the port, no cache, no batching, no
chunking. It follows the published equations (arXiv 2405.04434; DeepSeek's
``modeling_deepseek.py``, transformers' ``modeling_deepseek_v2.py``) in
the expanded form, no absorption:

  per layer: h = h + attn(norm_in(h)); h = h + mlp(norm_post(h))
  attn(x): q = x W_q, per head [q_nope (128) | q_pe (64)];
    [c (512) | k_pe (64)] = x W_kv_a, c = RMSNorm(c) (kv_a_layernorm);
    per head [k_nope | v] = c W_kv_b (here k_nope = c W_uk,h^T, v = c W_uv,h);
    RoPE on q_pe and k_pe: YaRN inverse frequencies, adjacent pairs
    (2i, 2i + 1) rotated as DeepSeek's view_as_complex does; k_pe shared by
    the heads; causal softmax of [q_nope | q_pe] . [k_nope | k_pe] times
    softmax_scale; o_proj of the heads' outputs
  mlp(x): SwiGLU on the first first_k_dense_replace layers; else the MoE:
    s = softmax(x W_router) in f32, experts = the greedy top k of s,
    w = s_sel (renormalised only with norm_topk_prob) * routed_scaling_factor,
    out = shared(x) + sum_e w_e expert_e(x), every routed row computed
  logits = norm(h) lm_head

Departures from the published model: the softmax scale is
qk_head_dim^-0.5 times YaRN's mscale(factor, mscale_all_dim)^2, as
DeepSeek's own modelling code and transformers' deepseek_v3 compute it;
transformers' in-tree deepseek_v2 leaves that factor out. The port's
weights are random (from a seed), every norm weight at 1. Float32
throughout; TF32 is switched off here so that a card computes float32
products in float32.
"""

from __future__ import annotations

import math

import torch

from pqcache_tpu_torch.models.afmoe_ref import rms_norm, swiglu

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def _mscale(factor: float, m: float) -> float:
    return 0.1 * m * math.log(factor) + 1.0 if factor > 1 else 1.0


def inv_freq(cfg) -> torch.Tensor:
    """YaRN's inverse frequencies of the rope columns (DeepSeek's
    DeepseekV2YarnRotaryEmbedding), or the plain ones without YaRN."""
    dim, base = cfg.qk_rope_head_dim, cfg.rope_theta
    extra = 1.0 / base ** (torch.arange(0, dim, 2).float() / dim)
    if not cfg.yarn_factor:
        return extra
    inter = extra / cfg.yarn_factor

    def corr(rot):
        return (dim * math.log(cfg.yarn_original_max_position
                               / (rot * 2 * math.pi))
                / (2 * math.log(base)))
    low = max(math.floor(corr(cfg.yarn_beta_fast)), 0)
    high = min(math.ceil(corr(cfg.yarn_beta_slow)), dim - 1)
    if low == high:
        high += 0.001
    ramp = ((torch.arange(dim // 2).float() - low) / (high - low)).clamp(0, 1)
    mask = 1.0 - ramp
    return inter * (1.0 - mask) + extra * mask


def rope(x: torch.Tensor, pos: torch.Tensor, cfg) -> torch.Tensor:
    """x [..., T, d] rotated by adjacent pairs at positions pos [T], as a
    complex multiply by e^(i pos f) times YaRN's cos/sin scale."""
    ang = pos.float()[:, None] * inv_freq(cfg).to(x.device)
    scale = 1.0
    if cfg.yarn_factor and cfg.yarn_mscale_all_dim:
        scale = (_mscale(cfg.yarn_factor, cfg.yarn_mscale)
                 / _mscale(cfg.yarn_factor, cfg.yarn_mscale_all_dim))
    z = torch.polar(torch.full_like(ang, scale), ang)
    xc = torch.view_as_complex(x.float().reshape(*x.shape[:-1], -1, 2)
                               .contiguous())
    return torch.view_as_real(xc * z).flatten(-2)


def softmax_scale(cfg) -> float:
    s = (cfg.qk_nope_head_dim + cfg.qk_rope_head_dim) ** -0.5
    if cfg.yarn_factor and cfg.yarn_mscale_all_dim:
        s *= _mscale(cfg.yarn_factor, cfg.yarn_mscale_all_dim) ** 2
    return s


def layer(cfg, params: dict, idx: int) -> dict:
    """Layer idx's arrays in float32."""
    Ld = cfg.first_k_dense_replace
    grp, j = ((params["dense"], idx) if idx < Ld
              else (params["moe"], idx - Ld))
    return {k: v[j].float() for k, v in grp.items()}


def route(cfg, lp: dict, x: torch.Tensor):
    """(weights [T, k], experts [T, k]) of rows x [T, E]."""
    s = torch.softmax(x @ lp["router"], -1)
    w, sel = torch.topk(s, cfg.num_experts_per_tok, dim=-1)
    if cfg.norm_topk_prob:
        w = w / (w.sum(-1, keepdim=True) + 1e-20)
    return w * cfg.routed_scaling_factor, sel


def moe(cfg, lp: dict, x: torch.Tensor, routes=None) -> torch.Tensor:
    """The shared experts plus each routed expert over the rows that
    selected it, weighted."""
    w, sel = route(cfg, lp, x)
    if routes is not None:
        routes.append(sel)
    out = swiglu(x, lp["shared_gate"], lp["shared_up"], lp["shared_down"])
    for e in range(lp["experts_gate"].shape[0]):
        rows, slot = torch.nonzero(sel == e, as_tuple=True)
        if rows.numel():
            y = swiglu(x[rows], lp["experts_gate"][e], lp["experts_up"][e],
                       lp["experts_down"][e])
            out = out.index_add(0, rows, y * w[rows, slot, None])
    return out


def attention(cfg, lp: dict, x: torch.Tensor) -> torch.Tensor:
    """Causal MLA self-attention of normed rows x [T, E], positions
    0..T-1, in the expanded form."""
    T = x.shape[0]
    H, R = cfg.num_heads, cfg.kv_lora_rank
    Dn, Dr = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    pos = torch.arange(T, device=x.device)
    q = (x @ lp["wq"]).reshape(T, H, Dn + Dr).transpose(0, 1)   # [H, T, .]
    y = x @ lp["w_kv_a"]
    c = rms_norm(y[:, :R], lp["kv_norm"], cfg.rms_norm_eps)
    k_pe = rope(y[:, R:], pos, cfg)                            # [T, Dr]
    k_nope = torch.einsum("tr,hdr->htd", c, lp["w_uk"])
    v = torch.einsum("tr,hrd->htd", c, lp["w_uv"])
    q = torch.cat([q[..., :Dn], rope(q[..., Dn:], pos, cfg)], -1)
    k = torch.cat([k_nope, k_pe[None].expand(H, -1, -1)], -1)
    s = q @ k.transpose(1, 2) * softmax_scale(cfg)             # [H, T, T]
    ok = pos[:, None] >= pos[None, :]
    att = torch.softmax(torch.where(ok, s, -torch.inf), -1) @ v
    return att.transpose(0, 1).reshape(T, -1) @ lp["wo"]


@torch.no_grad()
def forward(cfg, params: dict, tokens: torch.Tensor,
            routes=None) -> torch.Tensor:
    """Logits [T, V] f32 of every position of tokens [T]; ``routes``
    receives each MoE layer's selected experts [T, k], in layer order."""
    eps = cfg.rms_norm_eps
    h = params["embed"].float()[tokens.long()]
    for idx in range(cfg.num_layers):
        lp = layer(cfg, params, idx)
        h = h + attention(cfg, lp, rms_norm(h, lp["ln_in"], eps))
        x = rms_norm(h, lp["ln_post"], eps)
        h = h + (swiglu(x, lp["gate"], lp["up"], lp["down"])
                 if idx < cfg.first_k_dense_replace
                 else moe(cfg, lp, x, routes))
    h = rms_norm(h, params["final_norm"].float(), eps)
    return h @ params["lm_head"].float()
