"""Llama-family decoder (Llama-2 / Llama-3.1 / Mistral) in PyTorch.

Counterpart of ``pqcache_tpu/models/llama.py``: the single-sequence path
(one-pass, chunked, chunk-major slab and prefix prefill; greedy or sampled
decode) and the batch-as-heads decode (B slots folded into the policy's
kv-head axis, per-slot positions).
Parameters keep the JAX layout — a dict with weights stacked over layers
(``layers/wq`` [L, E, H*D] ...) applied as ``x @ w`` — so
``bridge.params_from_numpy`` moves a JAX tree across unchanged. The layer
scan becomes a Python loop; the attention policy (``policies/``) plugs in at
the attention site and updates its state in place. Matmuls run in the
weights' dtype; normalization and softmax in f32.

Every weight product goes through ``_mm``, ``embed_lookup`` and
``lm_head_logits``, which take float weights or the weight-only int8 layout
of ``core/quant.quantize_weight_tree`` (int8 matrices beside '<name>_s'
scales): decode rows through the W8 kernel (``ops/w8.py``), prefill rows
through a dequantized copy and ``torch.matmul``.

Each prefill entry point (``prefill``, ``prefill_chunked``,
``prefill_with_prefix``, ``prefill_chunk_step``, ``prefill_finish_tail``)
runs in a ``prefill`` span (``runtime/stages.py``) with its rows as
``tokens``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from pqcache_tpu_torch import resolve_device
from pqcache_tpu_torch.config import ModelConfig
from pqcache_tpu_torch.ops import w8
from pqcache_tpu_torch.ops.dispatch import (dense_prefill_attention,
                                            prefill_chunk_attention)
from pqcache_tpu_torch.runtime.stages import span, stage


def init_params(cfg: ModelConfig, generator: torch.Generator,
                dtype=torch.bfloat16, device=None, layer_slice=None) -> dict:
    """Random parameters (normal, std 0.02; norms at 1) with the JAX
    package's layout, drawn from ``generator`` (which must live on
    ``device``, cuda unless given). Drawn layer by layer so the float32 draw
    never holds more than one layer's matrix. ``layer_slice(name, w)``,
    when given, replaces each layer's matrix w of leaf ``name`` as it is
    drawn (``parallel/sharding.init_params_shard`` keeps one rank's slice:
    the same values, without ever holding the whole model)."""
    device = resolve_device(device)
    E, H, Hkv, D, I, L, V = (cfg.hidden_size, cfg.num_heads, cfg.num_kv_heads,
                             cfg.head_dim, cfg.intermediate_size,
                             cfg.num_layers, cfg.vocab_size)

    def draw(shape):
        return (torch.randn(shape, generator=generator, device=device)
                * 0.02).to(dtype)

    def stacked(name, *shape):
        return torch.stack([
            draw(shape) if layer_slice is None
            else layer_slice(name, draw(shape)) for _ in range(L)])

    ones = lambda *s: torch.ones(s, dtype=dtype, device=device)  # noqa: E731
    params = {
        "embed": draw((V, E)),
        "final_norm": ones(E),
        "layers": {
            "ln1": ones(L, E), "ln2": ones(L, E),
            "wq": stacked("wq", E, H * D),
            "wk": stacked("wk", E, Hkv * D),
            "wv": stacked("wv", E, Hkv * D),
            "wo": stacked("wo", H * D, E),
            "gate": stacked("gate", E, I), "up": stacked("up", E, I),
            "down": stacked("down", I, E),
        },
    }
    params["lm_head"] = (params["embed"].T.contiguous()
                         if cfg.tie_word_embeddings else draw((E, V)))
    return params


def _mm(x: torch.Tensor, lp: dict, name: str) -> torch.Tensor:
    """x @ lp[name]. An int8 weight (quantize_weight_tree) is multiplied as
    (x @ W8) * s with its per-column scale lp[name + "_s"]: on the card, up
    to w8.MAX_ROWS rows (decode) by the W8 kernel, which reads the int8
    weights once; more rows (prefill, bound by operations) by a dequantized
    bf16 copy and torch.matmul (w8.w8_dequant_matmul, counted apart)."""
    w = lp[name]
    if w.dtype != torch.int8:
        return x @ w
    if x.is_cuda and x.numel() // x.shape[-1] > w8.MAX_ROWS:
        return w8.w8_dequant_matmul(x, w, lp[name + "_s"])
    return w8.w8_matmul(x, w, lp[name + "_s"])


def _products(x: torch.Tensor, lp: dict, names: tuple) -> list:
    """[_mm(x, lp, n) for n in names]; products that share x. With int8
    weights and at most w8.MAX_ROWS rows (decode) they are ONE launch of the
    W8 kernel (w8.w8_matmul_group: q/k/v, gate/up), the same function as
    one _mm each."""
    if all(lp[n].dtype == torch.int8 for n in names) \
            and x.numel() // x.shape[-1] <= w8.MAX_ROWS:
        return w8.w8_matmul_group(x, [(lp[n], lp[n + "_s"]) for n in names])
    return [_mm(x, lp, n) for n in names]


def embed_lookup(params: dict, tokens: torch.Tensor) -> torch.Tensor:
    """Embedding rows of ``tokens``; an int8 table carries per-row scales
    ('embed_s' [V, 1]), applied in the scale's dtype."""
    e = params["embed"]
    h = e[tokens]
    if e.dtype == torch.int8:
        s = params["embed_s"][tokens]
        h = h.to(s.dtype) * s
    return h


def lm_head_logits(params: dict, last: torch.Tensor) -> torch.Tensor:
    """last [., E] @ lm_head -> f32 logits [., V]; an int8 head is scaled
    after the product, in f32."""
    w = params["lm_head"]
    if w.dtype == torch.int8:
        return w8.w8_matmul(last, w, params["lm_head_s"], lm_head=True)
    return (last @ w).float()


def lm_head_params(params: dict) -> dict:
    """The final norm and the LM head, with the int8 head's scale row when
    there is one."""
    return {k: params[k] for k in ("final_norm", "lm_head", "lm_head_s")
            if k in params}


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """f32 statistics, cast back to x.dtype BEFORE the weight multiply (the
    JAX package's cast order)."""
    xf = x.float()
    var = (xf * xf).mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * w


def rope_inv_freq(cfg: ModelConfig, device=None) -> torch.Tensor:
    """Base inverse frequencies, with Llama-3.1 rope scaling when configured
    (HF modeling_rope_utils _compute_llama3_parameters); on cuda unless
    ``device`` is given."""
    device = resolve_device(device)
    D = cfg.head_dim
    inv = 1.0 / (cfg.rope_theta ** (
        torch.arange(0, D, 2, dtype=torch.float32, device=device) / D))
    if cfg.rope_scaling_factor is not None:
        factor = cfg.rope_scaling_factor
        lo = cfg.rope_original_max_position / cfg.rope_low_freq_factor
        hi = cfg.rope_original_max_position / cfg.rope_high_freq_factor
        wavelen = 2.0 * math.pi / inv
        smooth = (cfg.rope_original_max_position / wavelen
                  - cfg.rope_low_freq_factor) / (
                      cfg.rope_high_freq_factor - cfg.rope_low_freq_factor)
        smooth = smooth.clamp(0.0, 1.0)
        scaled = (1.0 - smooth) * inv / factor + smooth * inv
        inv = torch.where(wavelen > lo, inv / factor,
                          torch.where(wavelen < hi, inv, scaled))
    return inv


def rope_cos_sin(cfg: ModelConfig, positions: torch.Tensor):
    """positions [T] int -> (cos, sin) [T, D/2] f32."""
    ang = positions.float()[:, None] * rope_inv_freq(cfg,
                                                     positions.device)[None]
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos, sin) -> torch.Tensor:
    """HF rotate-half convention. x [Hx, T, D]; cos/sin [T, D/2]."""
    D = x.shape[-1]
    x1, x2 = x[..., :D // 2].float(), x[..., D // 2:].float()
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     -1).to(x.dtype)


def mlp(lp: dict, x: torch.Tensor, chunk: int = 16384) -> torch.Tensor:
    """SwiGLU MLP, token-chunked to bound the [T, I] activations (chunk 0 or
    a T that chunk does not divide runs unchunked, as in the JAX package)."""
    def one(xc):
        gate, up = _products(xc, lp, ("gate", "up"))
        return _mm(F.silu(gate) * up, lp, "down")

    T = x.shape[0]
    if chunk <= 0 or T <= chunk or T % chunk:
        return one(x)
    return torch.cat([one(x[i:i + chunk]) for i in range(0, T, chunk)])


def _finish_layer(cfg: ModelConfig, lp: dict, hidden: torch.Tensor,
                  att: torch.Tensor, comm=None) -> torch.Tensor:
    """Post-attention half of one decoder layer — the single copy of the
    residual / norm / MLP tail that prefill and decode both call.
    att: [T, H*D] flattened head outputs. With ``comm`` (tensor
    parallelism, ``parallel/collectives.Comm``) lp holds this rank's
    column / row slices, and the two row-parallel products (attention
    output, MLP down) are all-reduced in the activation dtype: the
    Megatron pattern of the JAX package's psums."""
    attn_out = _mm(att, lp, "wo")
    if comm is not None:
        attn_out = comm.all_reduce(attn_out)
    hidden = hidden + attn_out
    mlp_out = mlp(lp, rms_norm(hidden, lp["ln2"], cfg.rms_norm_eps),
                  chunk=cfg.mlp_chunk)
    if comm is not None:
        mlp_out = comm.all_reduce(mlp_out)
    return hidden + mlp_out


def _rope_q(cfg: ModelConfig, yq: torch.Tensor, cos, sin):
    """Rope'd queries [H, T, D] of the q products yq [T, H*D]."""
    T = yq.shape[0]
    return apply_rope(yq.reshape(T, cfg.num_heads, cfg.head_dim).transpose(
        0, 1), cos, sin)


def _rope_kv(cfg: ModelConfig, yk: torch.Tensor, yv: torch.Tensor, cos, sin):
    """Rope'd keys and values [H_kv, T, D] of the products yk, yv."""
    T = yk.shape[0]
    Hkv, D = cfg.num_kv_heads, cfg.head_dim
    k = apply_rope(yk.reshape(T, Hkv, D).transpose(0, 1), cos, sin)
    v = yv.reshape(T, Hkv, D).transpose(0, 1).contiguous()
    return k, v


def _q_proj(cfg: ModelConfig, lp: dict, h_norm: torch.Tensor, cos, sin):
    """Rope'd queries [H, T, D] of the normed rows h_norm [T, E]."""
    return _rope_q(cfg, _mm(h_norm, lp, "wq"), cos, sin)


def _kv_proj(cfg: ModelConfig, lp: dict, h_norm: torch.Tensor, cos, sin):
    """Rope'd keys and values [H_kv, T, D] of the normed rows h_norm."""
    return _rope_kv(cfg, _mm(h_norm, lp, "wk"), _mm(h_norm, lp, "wv"), cos,
                    sin)


def _layer_fwd(cfg: ModelConfig, lp: dict, hidden, attn_fn, cos, sin,
               comm=None):
    """One decoder layer; attn_fn(q, k, v) -> (attn [H, T, D], extra)."""
    T = hidden.shape[0]
    H, D = cfg.num_heads, cfg.head_dim
    h_norm = rms_norm(hidden, lp["ln1"], cfg.rms_norm_eps)
    yq, yk, yv = _products(h_norm, lp, ("wq", "wk", "wv"))
    k, v = _rope_kv(cfg, yk, yv, cos, sin)
    q = _rope_q(cfg, yq, cos, sin)
    attn, extra = attn_fn(q, k, v)
    hidden = _finish_layer(cfg, lp, hidden,
                           attn.transpose(0, 1).reshape(T, H * D), comm)
    return hidden, extra


def _layer_params(params: dict, idx: int) -> dict:
    """Layer idx of every stacked array, the int8 weights' scales too."""
    return {k: v[idx] for k, v in params["layers"].items()}


def _logits(cfg: ModelConfig, params: dict, last: torch.Tensor):
    """f32 logits [V] of one row last [1, E]."""
    last = rms_norm(last, params["final_norm"], cfg.rms_norm_eps)
    return lm_head_logits(params, last)[0]


@torch.no_grad()
def prefill(cfg: ModelConfig, params: dict, policy, state,
            tokens: torch.Tensor, pad_len: int, true_len: int, comm=None):
    """Process a LEFT-padded prompt: tokens [P] (positions [0, pad_len) are
    padding). Fills ``state`` and returns the last token's logits [V] f32.
    ``comm``: the tensor-parallel group (``_finish_layer``), None on one
    device; every function below that runs layers takes it alike."""
    P = tokens.shape[0]
    with span("prefill", tokens=P):
        hidden = embed_lookup(params, tokens)
        positions = torch.clamp(
            torch.arange(P, device=tokens.device) - pad_len, min=0)
        cos, sin = rope_cos_sin(cfg, positions)
        for idx in range(cfg.num_layers):
            def attn_fn(q, k, v, idx=idx):
                return policy.prefill_attn(state, idx, q, k, v, pad_len,
                                           true_len), None
            hidden, _ = _layer_fwd(cfg, _layer_params(params, idx), hidden,
                                   attn_fn, cos, sin, comm)
        return _logits(cfg, params, hidden[P - 1:P])

def kv_full_chunked(cfg: ModelConfig, lp: dict, hidden: torch.Tensor,
                    cos, sin, chunk: int):
    """Pass A of chunked prefill: one layer's rope'd K/V [H_kv, P, D] over
    all P rows, computed ``chunk`` rows at a time so the normed rows stay
    bounded at [chunk, E]."""
    P = hidden.shape[0]
    Hkv, D = cfg.num_kv_heads, cfg.head_dim
    k = torch.empty((Hkv, P, D), dtype=hidden.dtype, device=hidden.device)
    v = torch.empty_like(k)
    for c0 in range(0, P, chunk):
        c1 = c0 + chunk
        h_norm = rms_norm(hidden[c0:c1], lp["ln1"], cfg.rms_norm_eps)
        k[:, c0:c1], v[:, c0:c1] = _kv_proj(cfg, lp, h_norm, cos[c0:c1],
                                            sin[c0:c1])
    return k, v


def attn_mlp_chunk(cfg: ModelConfig, lp: dict, h_c: torch.Tensor, cos_c,
                   sin_c, k: torch.Tensor, v: torch.Tensor, pad_len, c0: int,
                   *, use_kernel: bool = True, comm=None) -> torch.Tensor:
    """Pass B of chunked prefill: the attention of one chunk of rows h_c
    [ch, E], whose first row is key index c0, against the keys k/v
    [H_kv, Tk, D] (K2 at q_offset = c0; keys past the chunk are masked by
    causality), then the MLP. Returns the chunk's new rows [ch, E]."""
    ch = h_c.shape[0]
    h_norm = rms_norm(h_c, lp["ln1"], cfg.rms_norm_eps)
    q = _q_proj(cfg, lp, h_norm, cos_c, sin_c)
    att = prefill_chunk_attention(q, k, v, pad_len, q_offset=c0,
                                  use_kernel=use_kernel)
    return _finish_layer(cfg, lp, h_c, att.transpose(0, 1).reshape(ch, -1),
                         comm)


@torch.no_grad()
def prefill_chunked(cfg: ModelConfig, params: dict, policy, state,
                    tokens: torch.Tensor, pad_len: int, true_len: int, *,
                    chunk: int, comm=None):
    """``prefill`` with its transients bounded at ``chunk`` rows (the JAX
    package's ``prefill_chunked``): per layer (A) the full-length K/V from
    row chunks, (B) each chunk's queries against the keys before it through
    K2 at q_offset, then its MLP, and (C) the policy's ``prefill_tail`` on
    the full K/V. Needs P % chunk == 0 and a policy with ``prefill_tail``.

    Each chunk's output overwrites its own rows of ``hidden`` in place:
    chunk c + 1 reads only rows [c0 + chunk, ...), which no earlier chunk
    wrote, and pass A has already taken this layer's K/V from the old rows,
    so they are dead once their chunk is done. Returns the last token's
    logits [V] f32."""
    P = tokens.shape[0]
    if P % chunk:
        raise ValueError(f"prefill length {P} not a multiple of chunk "
                         f"{chunk}")
    use_kernel = getattr(policy, "use_kernel", True)
    with span("prefill", tokens=P):
        hidden = embed_lookup(params, tokens)
        positions = torch.clamp(
            torch.arange(P, device=tokens.device) - pad_len, min=0)
        cos, sin = rope_cos_sin(cfg, positions)
        for idx in range(cfg.num_layers):
            lp = _layer_params(params, idx)
            k, v = kv_full_chunked(cfg, lp, hidden, cos, sin, chunk)
            for c0 in range(0, P, chunk):
                c1 = c0 + chunk
                hidden[c0:c1] = attn_mlp_chunk(
                    cfg, lp, hidden[c0:c1], cos[c0:c1], sin[c0:c1], k, v,
                    pad_len, c0, use_kernel=use_kernel, comm=comm)
            policy.prefill_tail(state, idx, k, v, pad_len, true_len)
        return _logits(cfg, params, hidden[P - 1:P])


@torch.no_grad()
def prefill_chunk_step(cfg: ModelConfig, params: dict, kbuf: torch.Tensor,
                       vbuf: torch.Tensor, hidden_c: torch.Tensor, pad_len,
                       c0: int, *, use_kernel: bool = True,
                       comm=None) -> torch.Tensor:
    """Chunk-major prefill slab (the JAX package's ``prefill_chunk_step``):
    the prompt rows [c0, c0 + ch) through every layer, each layer's rope'd
    K/V written into the admission buffers kbuf/vbuf [L, H_kv, P, D] in
    place, then the slab's attention against the buffer's keys through K2
    at q_offset = c0 (``attn_mlp_chunk``). The only dependency between
    slabs is each layer's K/V prefix, so a serving engine decodes between
    slabs. hidden_c [ch, E]: the slab's embedded tokens (``embed_lookup``,
    which dequantizes an int8 table); c0 a host int. Returns the slab's
    last-layer rows [ch, E].

    The whole buffer goes to the attention: rows past the slab are masked
    by causality, so its inputs are ``prefill_chunked``'s, and the two give
    the same bits."""
    ch = hidden_c.shape[0]
    with span("prefill", tokens=ch):
        positions = torch.clamp(
            c0 + torch.arange(ch, device=hidden_c.device) - pad_len, min=0)
        cos, sin = rope_cos_sin(cfg, positions)
        hidden = hidden_c
        for idx in range(cfg.num_layers):
            lp = _layer_params(params, idx)
            h_norm = rms_norm(hidden, lp["ln1"], cfg.rms_norm_eps)
            kbuf[idx, :, c0:c0 + ch], vbuf[idx, :, c0:c0 + ch] = _kv_proj(
                cfg, lp, h_norm, cos, sin)
            hidden = attn_mlp_chunk(cfg, lp, hidden, cos, sin, kbuf[idx],
                                    vbuf[idx], pad_len, c0,
                                    use_kernel=use_kernel, comm=comm)
        return hidden


@torch.no_grad()
def prefill_finish_tail(cfg: ModelConfig, params: dict, policy, state,
                        kbuf: torch.Tensor, vbuf: torch.Tensor,
                        h_last: torch.Tensor, pad_len: int, true_len: int):
    """Finish a chunk-major prefill: the policy's ``prefill_tail`` per layer
    over the assembled K/V, then the logits [V] f32 of the last slab's last
    row (a left-padded prompt ends there). With ``prefill_chunk_step`` this
    computes what ``prefill_chunked`` computes, sliced so that a scheduler
    can interleave."""
    with span("prefill", tokens=kbuf.shape[2]):
        for idx in range(cfg.num_layers):
            policy.prefill_tail(state, idx, kbuf[idx], vbuf[idx], pad_len,
                                true_len)
        return _logits(cfg, params, h_last[-1:])


@torch.no_grad()
def prefill_capture_kv(cfg: ModelConfig, params: dict, tokens: torch.Tensor,
                       *, use_kernel: bool = True):
    """Prefix-cache snapshot: the rope'd K/V [L, H_kv, T_pre, D] of an
    unpadded prefix prompt tokens [T_pre], by dense causal attention (K2).
    No policy: the snapshot is raw K/V, and the policy's codebooks and state
    are trained later over [prefix | suffix] in ``prefill_with_prefix``."""
    P = tokens.shape[0]
    hidden = embed_lookup(params, tokens)
    cos, sin = rope_cos_sin(cfg, torch.arange(P, device=tokens.device))
    ks, vs = [], []
    for idx in range(cfg.num_layers):
        def attn_fn(q, k, v):
            ks.append(k)
            vs.append(v)
            return dense_prefill_attention(q, k, v, 0,
                                           use_kernel=use_kernel)[0], None
        hidden, _ = _layer_fwd(cfg, _layer_params(params, idx), hidden,
                               attn_fn, cos, sin)
    return torch.stack(ks), torch.stack(vs)


@torch.no_grad()
def prefill_with_prefix(cfg: ModelConfig, params: dict, policy, state,
                        pre_k: torch.Tensor, pre_v: torch.Tensor,
                        tokens: torch.Tensor, true_suf: int):
    """Prefill continuing from a prefix snapshot (``prefill_capture_kv``):
    pre_k/pre_v [L, H_kv, T_pre, D]; tokens [P_suf] is the suffix, RIGHT-
    padded (rows >= true_suf are padding, whose keys no real row sees).
    Per layer the suffix is one chunk at q_offset = T_pre against
    [prefix | suffix] (``attn_mlp_chunk``), then the policy's
    ``prefill_tail`` over the joined K/V with pad_len 0 and true_len =
    T_pre + true_suf: the inputs of a one-shot prefill of the joined
    prompt. Returns the logits [V] f32 of the last real row."""
    P_suf = tokens.shape[0]
    T_pre = pre_k.shape[2]
    use_kernel = getattr(policy, "use_kernel", True)
    with span("prefill", tokens=P_suf):
        hidden = embed_lookup(params, tokens)
        cos, sin = rope_cos_sin(
            cfg, T_pre + torch.arange(P_suf, device=tokens.device))
        for idx in range(cfg.num_layers):
            lp = _layer_params(params, idx)
            h_norm = rms_norm(hidden, lp["ln1"], cfg.rms_norm_eps)
            k_suf, v_suf = _kv_proj(cfg, lp, h_norm, cos, sin)
            k = torch.cat([pre_k[idx], k_suf], 1)
            v = torch.cat([pre_v[idx], v_suf], 1)
            hidden = attn_mlp_chunk(cfg, lp, hidden, cos, sin, k, v, 0,
                                    T_pre, use_kernel=use_kernel)
            policy.prefill_tail(state, idx, k, v, 0, T_pre + int(true_suf))
        return _logits(cfg, params, hidden[int(true_suf) - 1:int(true_suf)])


@torch.no_grad()
def decode_step(cfg: ModelConfig, params: dict, policy, state,
                token: torch.Tensor, pos: int, comm=None):
    """One decode step. token: 0-d or [1] int tensor on the device; pos:
    the token's absolute position. Returns logits [V] f32. A policy with
    ``deferred_appends`` gets all layers' new tokens committed to ``state``
    after the layer loop; the others wrote theirs inside decode_attn."""
    hidden = embed_lookup(params, token.reshape(1))          # [1, E]
    cos, sin = rope_cos_sin(
        cfg, torch.arange(pos, pos + 1, device=hidden.device))
    shared = policy.shared_pre(state)
    payloads = []
    for idx in range(cfg.num_layers):
        def attn_fn(q, k, v, idx=idx):
            return policy.decode_attn(state, idx, q, k, v, shared)
        hidden, payload = _layer_fwd(cfg, _layer_params(params, idx), hidden,
                                     attn_fn, cos, sin, comm)
        payloads.append(payload)
    if getattr(policy, "deferred_appends", False):
        policy.commit_appends(state, (torch.stack([p[0] for p in payloads]),
                                      torch.stack([p[1] for p in payloads])),
                              shared)
    policy.shared_post(state, shared)
    return _logits(cfg, params, hidden)


@torch.no_grad()
def decode_loop(cfg: ModelConfig, params: dict, policy, state,
                token: torch.Tensor, pos: int, n_steps: int, *,
                sample=None, noise=None, comm=None) -> torch.Tensor:
    """Decode of n_steps tokens; tokens[i] is the model's output after
    consuming the previous one (token for i = 0). Greedy, or with
    ``sample`` (``core/sampling.make_sampler``) one draw per step from
    ``noise`` (a ``core/sampling.GumbelNoise``, or any source with its
    ``fill_``). The tokens stay on the device until the caller reads them:
    no step waits for the host."""
    out = []
    tok = token.reshape(())
    for i in range(n_steps):
        logits = decode_step(cfg, params, policy, state, tok, pos + i, comm)
        if sample is None:
            tok = torch.argmax(logits)
        else:
            tok = sample(logits, noise.fill_(torch.empty_like(logits)))
        out.append(tok)
    return torch.stack(out)


# ---------------------------------------------------------------------------
# Batch-as-heads decode (llama.py:584-687): B sequence slots, the policy's
# state folded over the kv-head axis, the MLP / embedding / LM head as
# ordinary [B, E] matmuls.

def _apply_rope_batched(x: torch.Tensor, cos, sin) -> torch.Tensor:
    """x [B, Hx, D]; cos/sin [B, D/2] (per-slot positions)."""
    return apply_rope(x, cos[:, None, :], sin[:, None, :])


@torch.no_grad()
def decode_step_batched(cfg: ModelConfig, params: dict, policy, state,
                        tokens: torch.Tensor, pos: torch.Tensor, comm=None):
    """One greedy-decode step for B slots: tokens, pos [B] int tensors on
    the device. Returns logits [B, V] f32. Every count stays on the device,
    so the step can be captured into a CUDA graph."""
    B = tokens.shape[0]
    H, Hkv, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    with stage("embed_rope"):
        hidden = embed_lookup(params, tokens)                # [B, E]
        cos, sin = rope_cos_sin(cfg, pos)                    # [B, D/2]
        shared = policy.shared_pre_batched(state)
    ks, vs = [], []
    for idx in range(cfg.num_layers):
        lp = _layer_params(params, idx)
        with stage("qkv"):
            h_norm = rms_norm(hidden, lp["ln1"], cfg.rms_norm_eps)
            yq, yk, yv = _products(h_norm, lp, ("wq", "wk", "wv"))
            q = _apply_rope_batched(yq.reshape(B, H, D), cos, sin)
            k = _apply_rope_batched(yk.reshape(B, Hkv, D), cos, sin)
            v = yv.reshape(B, Hkv, D)
        attn, (k_new, v_new) = policy.decode_attn_batched(state, idx, q, k, v,
                                                          shared)
        with stage("out_mlp"):
            hidden = _finish_layer(cfg, lp, hidden, attn.reshape(B, H * D),
                                   comm)
        ks.append(k_new)
        vs.append(v_new)
    with stage("commit"):
        policy.commit_appends_batched(
            state, (torch.stack(ks), torch.stack(vs)), shared)
        policy.shared_post_batched(state, shared)
    with stage("lm_head"):
        last = rms_norm(hidden, params["final_norm"], cfg.rms_norm_eps)
        return lm_head_logits(params, last)


@torch.no_grad()
def decode_loop_batched(cfg: ModelConfig, params: dict, policy, state,
                        tokens: torch.Tensor, pos: torch.Tensor,
                        n_steps: int, *, sample=None, noise=None,
                        comm=None) -> torch.Tensor:
    """Decode of n_steps tokens for B slots, eagerly: tokens, pos [B].
    Greedy, or with ``sample`` and ``noise`` as in ``decode_loop``: one draw
    of [B, V] noise per step samples every slot, as the JAX package's one
    key per step does. Returns tokens [n_steps, B] int32 on the device. A
    policy with a
    write-combining ring takes at most ring_k steps, and its ring is
    flushed into the per-slot tails at the end, as the JAX package's one
    program per chunk does. The eager mode of
    ``runtime/decode_graph.BatchedDecoder``, which replays the same step
    from a CUDA graph."""
    from pqcache_tpu_torch.runtime.decode_graph import BatchedDecoder
    return BatchedDecoder(cfg, params, policy, state, chunk=n_steps,
                          graph=False, device=tokens.device, sample=sample,
                          noise=noise, comm=comm).decode(tokens, pos, n_steps)
