"""Plain float32 reference of the AFMoE decoder (``config.AfmoeConfig``).

The whole forward pass of one unpadded token sequence from the
parameters of ``models/afmoe.py`` (read, cast to float32, never changed):
plain torch operations, no kernel of the port, no cache, no batching, no
chunking. It follows the equations of transformers' ``modeling_afmoe.py``
(Arcee's Trinity):

  h = embed[ids] * sqrt(hidden_size)                      (mup_enabled)
  per layer, sandwich norms:
    h = h + norm_post_attn(attn(norm_in(h)))
    h = h + norm_post_mlp(mlp(norm_pre_mlp(h)))
  attn(x): q, k, v = x Wq, x Wk, x Wv; RMSNorm of each q and k head
    (q_norm, k_norm over head_dim); rotate-half RoPE on sliding layers
    only; causal GQA softmax attention, a sliding layer's query p seeing
    keys j with 0 <= p - j < sliding_window; o_proj(attn * sigmoid(x W_gate))
  mlp(x): SwiGLU down(silu(x gate) * x up) on the first num_dense_layers
    layers; else the MoE: s = sigmoid(x W_router), experts = top_k(s +
    expert_bias) (the bias selects, it does not weigh), w = s_sel /
    (sum s_sel + 1e-20) * route_scale (route_norm), out = shared(x) +
    sum_e w_e expert_e(x), every routed row computed (no capacity, no drop)
  logits = norm(h) lm_head

Departures from the published model: none in the equations. The port's
weights are random (from a seed), every norm weight at 1; the expert bias
is drawn rather than trained, so that it moves the selection. Float32
throughout; TF32 is switched off here so that a card computes float32
products in float32.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * w


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotate-half RoPE of x [..., T, D] at positions pos [T]."""
    D = x.shape[-1]
    inv = 1.0 / (theta ** (torch.arange(0, D, 2, dtype=torch.float32,
                                        device=x.device) / D))
    ang = pos.float()[:, None] * inv
    c, s = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :D // 2], x[..., D // 2:]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], -1)


def layer(cfg, params: dict, idx: int) -> dict:
    """Layer idx's arrays in float32."""
    Ld = cfg.num_dense_layers
    grp, j = ((params["dense"], idx) if idx < Ld
              else (params["moe"], idx - Ld))
    return {k: v[j].float() for k, v in grp.items()}


def route(cfg, lp: dict, x: torch.Tensor):
    """(weights [T, k], experts [T, k]) of rows x [T, E]."""
    s = torch.sigmoid(x @ lp["router"])
    sel = torch.topk(s + lp["expert_bias"], cfg.num_experts_per_tok,
                     dim=-1).indices
    w = s.gather(1, sel)
    if cfg.route_norm:
        w = w / (w.sum(-1, keepdim=True) + 1e-20)
    return w * cfg.route_scale, sel


def moe(cfg, lp: dict, x: torch.Tensor, routes=None) -> torch.Tensor:
    """The MoE MLP of rows x [T, E]: the shared expert plus each routed
    expert over the rows that selected it, weighted."""
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


def swiglu(x, gate, up, down):
    return (F.silu(x @ gate) * (x @ up)) @ down


def attention(cfg, lp: dict, x: torch.Tensor, window: int) -> torch.Tensor:
    """Self-attention of rows x [T, E] (normed), positions 0..T-1."""
    T = x.shape[0]
    H, Hkv, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    eps = cfg.rms_norm_eps
    q = rms_norm((x @ lp["wq"]).reshape(T, H, D), lp["q_norm"], eps)
    k = rms_norm((x @ lp["wk"]).reshape(T, Hkv, D), lp["k_norm"], eps)
    v = (x @ lp["wv"]).reshape(T, Hkv, D)
    q, k, v = q.transpose(0, 1), k.transpose(0, 1), v.transpose(0, 1)
    pos = torch.arange(T, device=x.device)
    if window:
        q, k = rope(q, pos, cfg.rope_theta), rope(k, pos, cfg.rope_theta)
    g = H // Hkv
    k, v = k.repeat_interleave(g, 0), v.repeat_interleave(g, 0)
    s = q @ k.transpose(1, 2) / math.sqrt(D)                 # [H, T, T]
    diff = pos[:, None] - pos[None, :]
    ok = diff >= 0
    if window:
        ok = ok & (diff < window)
    att = torch.softmax(torch.where(ok, s, -torch.inf), -1) @ v
    o = att.transpose(0, 1).reshape(T, H * D)
    return (o * torch.sigmoid(x @ lp["wg"])) @ lp["wo"]


@torch.no_grad()
def forward(cfg, params: dict, tokens: torch.Tensor,
            routes=None) -> torch.Tensor:
    """Logits [T, V] f32 of every position of tokens [T]; ``routes``
    receives each MoE layer's selected experts [T, k], in layer order."""
    eps = cfg.rms_norm_eps
    h = params["embed"].float()[tokens.long()]
    if cfg.mup_enabled:
        h = h * math.sqrt(cfg.hidden_size)
    for idx in range(cfg.num_layers):
        lp = layer(cfg, params, idx)
        x = rms_norm(h, lp["ln_in"], eps)
        h = h + rms_norm(attention(cfg, lp, x, cfg.window_of(idx)),
                         lp["ln_post_attn"], eps)
        x = rms_norm(h, lp["ln_pre_mlp"], eps)
        m = (swiglu(x, lp["gate"], lp["up"], lp["down"])
             if idx < cfg.num_dense_layers else moe(cfg, lp, x, routes))
        h = h + rms_norm(m, lp["ln_post_mlp"], eps)
    h = rms_norm(h, params["final_norm"].float(), eps)
    return h @ params["lm_head"].float()
