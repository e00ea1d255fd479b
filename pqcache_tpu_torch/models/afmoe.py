"""Arcee's AFMoE decoder (Trinity; ``config.AfmoeConfig``) in PyTorch.

The same entry points as ``models/llama.py`` (``prefill``,
``prefill_chunked``, ``decode_step_batched``), the same policies and the
same ``BatchedDecoder``; the layer equations (``models/afmoe_ref.py`` is
their plain float32 reference):

  h = embed[ids] * sqrt(E)                              (muP, mup_enabled)
  h = h + norm_post_attn(attn(norm_in(h)))
  h = h + norm_post_mlp(mlp(norm_pre_mlp(h)))
  attn(x): q, k, v = x Wq, x Wk, x Wv; per-head RMSNorm of q and k;
           RoPE on sliding layers only (full layers are NoPE); a sliding
           layer attends the keys j with 0 <= p - j < window;
           out = (attn_out * sigmoid(x W_gate)) Wo
  mlp(x):  SwiGLU on the first num_dense_layers layers, else the MoE:
           s = sigmoid(x W_router) in f32, the experts top_k(s + bias)
           (the bias selects only), weights s_sel / sum(s_sel) * scale,
           out = shared(x) + sum_e w_e expert_e(x), no capacity limit.

Parameters are grouped by the layer's MLP kind, each group stacked over
its layers: ``params["dense"]`` (the SwiGLU layers) and ``params["moe"]``
(the expert layers; ``experts_gate/up`` [L_m, X, E, I_e],
``experts_down`` [L_m, X, I_e, E], ``router`` [L_m, E, X],
``expert_bias`` [L_m, X] f32, the shared expert ``shared_*``); both carry
the attention's ``wq, wk, wv, wg, wo``, ``q_norm/k_norm`` [D] and the
four norms ``ln_in, ln_post_attn, ln_pre_mlp, ln_post_mlp``. Weight
products go through ``llama._products`` / ``_mm`` in the weights' dtype;
norms, the router and the expert combine run in f32.

The policy keeps retrieval state for the full layers and a ring per
window layer (``policies/window.py``); the model hands it every layer's
attention. The expert products (``experts``), at prefill and decode
alike: the routed rows sorted by expert on the device and one grouped
product per weight, each expert multiplying only its own rows, so a
decode step reads only the weights of the experts its rows selected,
waits for nothing and can be captured into a CUDA graph; a prefill reads
the experts' row counts once a layer, for its counter.

Spans (``runtime/stages.py``): every prefill entry point is a ``prefill``
span; inside it each sliding layer's K2 call is a ``prefill_window`` span
and each MoE layer's MLP a ``prefill_moe`` span (ids ``layer``), and the
counter ``moe.expert_load_max.layer<i>`` holds layer i's busiest expert's
routed rows over the mean. In a decode step the scopes ``moe_route``
(router, sigmoid, biased top-k, normalisation), ``moe_experts`` (the
shared and routed products and the combine) and ``window_attn`` (a
sliding layer's attention and ring write) mark the MoE and window work.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

from pqcache_tpu_torch import resolve_device
from pqcache_tpu_torch.config import AfmoeConfig
from pqcache_tpu_torch.models.llama import (_apply_rope_batched, _logits,
                                            _mm, _products, apply_rope,
                                            embed_lookup, lm_head_logits,
                                            rms_norm, rope_cos_sin)
from pqcache_tpu_torch.ops.dispatch import prefill_chunk_attention
from pqcache_tpu_torch.runtime.stages import count, scope, span, stage

_ATTN = ("wq", "wk", "wv", "wg", "wo")
_NORMS = ("ln_in", "ln_post_attn", "ln_pre_mlp", "ln_post_mlp")


def init_params(cfg: AfmoeConfig, generator: torch.Generator,
                dtype=torch.bfloat16, device=None, std: float = 0.02) -> dict:
    """Random parameters (normal, std ``std``; norms at 1; the expert bias
    normal with std ``std`` in f32, so that it moves the selection) in the
    layout above, drawn layer by layer from ``generator`` (on ``device``,
    cuda unless given)."""
    device = resolve_device(device)
    E, H, Hkv, D = (cfg.hidden_size, cfg.num_heads, cfg.num_kv_heads,
                    cfg.head_dim)
    X, Ie = cfg.num_experts, cfg.moe_intermediate_size
    Ld = cfg.num_dense_layers
    Lm = cfg.num_layers - Ld

    def draw(*shape, dt=dtype):
        return (torch.randn(shape, generator=generator, device=device)
                * std).to(dt)

    def group(L, mats):
        g = {k: torch.stack([draw(*shape) for _ in range(L)])
             for k, shape in mats.items()}
        for k in _NORMS:
            g[k] = torch.ones((L, E), dtype=dtype, device=device)
        for k in ("q_norm", "k_norm"):
            g[k] = torch.ones((L, D), dtype=dtype, device=device)
        return g

    attn = dict(wq=(E, H * D), wk=(E, Hkv * D), wv=(E, Hkv * D),
                wg=(E, H * D), wo=(H * D, E))
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
    params["moe"]["expert_bias"] = torch.stack(
        [draw(X, dt=torch.float32) for _ in range(Lm)])
    params["lm_head"] = (params["embed"].T.contiguous()
                         if cfg.tie_word_embeddings
                         else draw(E, cfg.vocab_size))
    return params


def layer_params(cfg: AfmoeConfig, params: dict, idx: int) -> dict:
    """Layer idx's arrays, from its kind's group."""
    Ld = cfg.num_dense_layers
    grp, j = ((params["dense"], idx) if idx < Ld
              else (params["moe"], idx - Ld))
    return {k: v[j] for k, v in grp.items()}


def _embed(cfg: AfmoeConfig, params: dict, tokens: torch.Tensor):
    h = embed_lookup(params, tokens)
    return h * cfg.embed_scale if cfg.embed_scale != 1.0 else h


def _heads(cfg: AfmoeConfig, y: torch.Tensor, n: int, norm=None):
    """Products y [T, n * D] -> [n, T, D], per-head RMSNorm'd by ``norm``
    [D] where given."""
    T = y.shape[0]
    y = y.reshape(T, n, cfg.head_dim)
    if norm is not None:
        y = rms_norm(y, norm, cfg.rms_norm_eps)
    return y.transpose(0, 1)


def _kv_full(cfg: AfmoeConfig, lp: dict, hidden: torch.Tensor, cos, sin,
             chunk: int, rope: bool):
    """One layer's keys (k-normed, rope'd on a sliding layer) and values
    [H_kv, P, D] over all rows, ``chunk`` rows at a time."""
    P = hidden.shape[0]
    Hkv, D = cfg.num_kv_heads, cfg.head_dim
    k = torch.empty((Hkv, P, D), dtype=hidden.dtype, device=hidden.device)
    v = torch.empty_like(k)
    for c0 in range(0, P, chunk):
        c1 = c0 + chunk
        x = rms_norm(hidden[c0:c1], lp["ln_in"], cfg.rms_norm_eps)
        yk, yv = _products(x, lp, ("wk", "wv"))
        kc = _heads(cfg, yk, Hkv, lp["k_norm"])
        k[:, c0:c1] = apply_rope(kc, cos[c0:c1], sin[c0:c1]) if rope else kc
        v[:, c0:c1] = _heads(cfg, yv, Hkv)
    return k, v


def swiglu(x: torch.Tensor, lp: dict, names: tuple) -> torch.Tensor:
    """down(silu(x gate) * x up) with the weights lp[names[0..2]]."""
    gate, up = _products(x, lp, names[:2])
    return _mm(F.silu(gate) * up, lp, names[2])


def route(cfg: AfmoeConfig, lp: dict, x: torch.Tensor):
    """Rows x [T, E] -> (combine weights [T, k] f32, experts [T, k]): f32
    sigmoid scores, the top k of scores + expert_bias, their scores
    normalised (route_norm) and times route_scale."""
    s = torch.sigmoid(x.float() @ lp["router"].float())
    sel = torch.topk(s + lp["expert_bias"], cfg.num_experts_per_tok,
                     dim=-1).indices
    w = s.gather(1, sel)
    if cfg.route_norm:
        w = w / (w.sum(-1, keepdim=True) + 1e-20)
    return w * cfg.route_scale, sel


def experts(lp: dict, x: torch.Tensor, w: torch.Tensor,
            sel: torch.Tensor):
    """The routed experts' sum [T, E] f32 of rows x [T, E], at prefill and
    at decode alike: the (row, expert) pairs sorted by expert on the
    device, one grouped product per weight over each expert's own rows
    (``torch._grouped_mm``, the group offsets on the device), each row's k
    outputs put back in order and added in f32 with its weights. Reads no
    count on the host, so a decode step can be captured into a CUDA graph,
    and touches only the experts that some row selected. Returns (sum, the
    rows each expert took [X] int32, on the device)."""
    T, k = sel.shape
    X = lp["experts_gate"].shape[0]
    flat = sel.reshape(-1)
    order = torch.argsort(flat, stable=True)
    counts = torch.zeros(X, dtype=torch.int32, device=x.device).scatter_add_(
        0, flat, torch.ones_like(flat, dtype=torch.int32))
    offs = torch.cumsum(counts, 0, dtype=torch.int32)
    xs = x[order // k]                                      # [T k, E]
    h = (F.silu(torch._grouped_mm(xs, lp["experts_gate"], offs=offs))
         * torch._grouped_mm(xs, lp["experts_up"], offs=offs))
    y = torch._grouped_mm(h, lp["experts_down"], offs=offs)
    y = torch.empty_like(y).index_copy_(0, order, y)        # (row, slot)
    return torch.einsum("tk,tke->te", w, y.view(T, k, -1).float()), counts


def moe(cfg: AfmoeConfig, lp: dict, x: torch.Tensor, routes=None):
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


def _finish(cfg: AfmoeConfig, lp: dict, idx: int, hidden: torch.Tensor,
            att: torch.Tensor, yg: torch.Tensor, *, prefill: bool,
            routes=None):
    """The gate, the output product, both sandwich norms and the MLP of
    rows hidden [T, E] with attention rows att [T, H*D]; a prefill's MoE
    in a ``prefill_moe`` span. Returns (the new rows, the MoE's per-expert
    counts or None)."""
    eps = cfg.rms_norm_eps
    o = _mm(att * torch.sigmoid(yg), lp, "wo")
    hidden = hidden + rms_norm(o, lp["ln_post_attn"], eps)
    x = rms_norm(hidden, lp["ln_pre_mlp"], eps)
    counts = None
    if idx < cfg.num_dense_layers:
        m = swiglu(x, lp, ("gate", "up", "down"))
    elif prefill:
        with span("prefill_moe", layer=idx):
            m, counts = moe(cfg, lp, x)
    else:
        m, _ = moe(cfg, lp, x, routes=routes)
    return hidden + rms_norm(m, lp["ln_post_mlp"], eps), counts


def _attn_mlp_chunk(cfg: AfmoeConfig, lp: dict, idx: int, h_c, cos_c, sin_c,
                    k, v, pad_len, c0: int, use_kernel: bool):
    """A prefill slab's rows h_c [ch, E] (key index c0 on) through layer
    idx against its keys k/v [H_kv, Tk, D]: K2 at q_offset c0, with the
    window bound on a sliding layer (a ``prefill_window`` span)."""
    ch = h_c.shape[0]
    W = cfg.window_of(idx)
    x = rms_norm(h_c, lp["ln_in"], cfg.rms_norm_eps)
    yq, yg = _products(x, lp, ("wq", "wg"))
    q = _heads(cfg, yq, cfg.num_heads, lp["q_norm"])
    if W:
        q = apply_rope(q, cos_c, sin_c)
        with span("prefill_window", layer=idx):
            att = prefill_chunk_attention(q, k, v, pad_len, q_offset=c0,
                                          use_kernel=use_kernel, window=W)
    else:
        att = prefill_chunk_attention(q, k, v, pad_len, q_offset=c0,
                                      use_kernel=use_kernel)
    return _finish(cfg, lp, idx, h_c, att.transpose(0, 1).reshape(ch, -1),
                   yg, prefill=True)


@torch.no_grad()
def prefill_chunked(cfg: AfmoeConfig, params: dict, policy, state,
                    tokens: torch.Tensor, pad_len: int, true_len: int, *,
                    chunk: int, comm=None):
    """A LEFT-padded prompt tokens [P] in slabs of ``chunk`` rows
    (``llama.prefill_chunked``'s passes): per layer (A) its keys and values
    over all rows, (B) each slab's attention against the keys before it
    (K2 at q_offset, the window bound on sliding layers) and its MLP, (C)
    the policy's ``prefill_tail`` (a full layer's retrieval state, a
    window layer's ring). Returns the last token's logits [V] f32."""
    if comm is not None:
        raise ValueError("afmoe has no tensor-parallel path")
    P = tokens.shape[0]
    if P % chunk:
        raise ValueError(f"prefill length {P} not a multiple of chunk "
                         f"{chunk}")
    use_kernel = getattr(policy, "use_kernel", True)
    with span("prefill", tokens=P):
        hidden = _embed(cfg, params, tokens)
        positions = torch.clamp(
            torch.arange(P, device=tokens.device) - pad_len, min=0)
        cos, sin = rope_cos_sin(cfg, positions)
        for idx in range(cfg.num_layers):
            lp = layer_params(cfg, params, idx)
            k, v = _kv_full(cfg, lp, hidden, cos, sin, chunk,
                            rope=cfg.window_of(idx) > 0)
            loads = None
            for c0 in range(0, P, chunk):
                c1 = c0 + chunk
                hidden[c0:c1], counts = _attn_mlp_chunk(
                    cfg, lp, idx, hidden[c0:c1], cos[c0:c1], sin[c0:c1], k,
                    v, pad_len, c0, use_kernel)
                if counts is not None:
                    loads = counts if loads is None else loads + counts
            if loads is not None:
                loads = loads.tolist()
                count(f"moe.expert_load_max.layer{idx}",
                      max(loads) * len(loads) / max(sum(loads), 1))
            policy.prefill_tail(state, idx, k, v, pad_len, true_len)
        return _logits(cfg, params, hidden[P - 1:P])


@torch.no_grad()
def prefill(cfg: AfmoeConfig, params: dict, policy, state,
            tokens: torch.Tensor, pad_len: int, true_len: int, comm=None):
    """``prefill_chunked`` in one slab of the whole prompt."""
    return prefill_chunked(cfg, params, policy, state, tokens, pad_len,
                           true_len, chunk=tokens.shape[0], comm=comm)


@torch.no_grad()
def decode_step_batched(cfg: AfmoeConfig, params: dict, policy, state,
                        tokens: torch.Tensor, pos: torch.Tensor, comm=None,
                        routes=None):
    """One greedy-decode step for B slots: tokens, pos [B] int tensors on
    the device. Returns logits [B, V] f32. Every count stays on the device,
    so the step can be captured into a CUDA graph. ``routes``: a list that
    receives each MoE layer's selected experts [B, k] (eager steps)."""
    if comm is not None:
        raise ValueError("afmoe has no tensor-parallel path")
    B = tokens.shape[0]
    H, Hkv, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    eps = cfg.rms_norm_eps
    with stage("embed_rope"):
        hidden = _embed(cfg, params, tokens)                 # [B, E]
        cos, sin = rope_cos_sin(cfg, pos)                    # [B, D/2]
        shared = policy.shared_pre_batched(state)
    ks, vs = [], []
    for idx in range(cfg.num_layers):
        lp = layer_params(cfg, params, idx)
        W = cfg.window_of(idx)
        with stage("qkv"):
            x = rms_norm(hidden, lp["ln_in"], eps)
            yq, yk, yv, yg = _products(x, lp, ("wq", "wk", "wv", "wg"))
            q = rms_norm(yq.reshape(B, H, D), lp["q_norm"], eps)
            k = rms_norm(yk.reshape(B, Hkv, D), lp["k_norm"], eps)
            if W:
                q = _apply_rope_batched(q, cos, sin)
                k = _apply_rope_batched(k, cos, sin)
            v = yv.reshape(B, Hkv, D)
        with scope("window_attn") if W else contextlib.nullcontext():
            attn, payload = policy.decode_attn_batched(state, idx, q, k, v,
                                                       shared)
        if payload is not None:
            ks.append(payload[0])
            vs.append(payload[1])
        with stage("out_mlp"):
            hidden, _ = _finish(cfg, lp, idx, hidden,
                                attn.reshape(B, H * D), yg, prefill=False,
                                routes=routes)
    with stage("commit"):
        policy.commit_appends_batched(
            state, (torch.stack(ks), torch.stack(vs)), shared)
        policy.shared_post_batched(state, shared)
    with stage("lm_head"):
        last = rms_norm(hidden, params["final_norm"], eps)
        return lm_head_logits(params, last)
