"""Plain PyTorch reference of DeepSeek-V2's decoder (multi-head latent
attention and experts) served by PQCache over its latent cache.

Imports nothing of the port: the benchmark's own copy of the equations of
``pqcache_tpu_torch/models/deepseek_v2_ref.py`` (which the CPU tests hold
this copy to), computed from the benchmark's weights and prompt in the
configuration's stated precision (``precision.py``: every weight product
from bf16 operands with f32 accumulation, each activation handed on in
bf16, the latent cache in bf16):

  * per layer h += attn(norm_in(h)), h += mlp(norm_post(h));
  * attention: q = x W_q, per head [q_nope (128) | q_pe (64)];
    [c | k_pe] = x W_kv_a, c = RMSNorm(c); RoPE with YaRN's inverse
    frequencies on q_pe and k_pe, adjacent pairs rotated; the cached latent
    row [c | k_pe] (576, bf16); logits times qk_head_dim^-0.5 times
    mscale(factor, mscale_all_dim)^2. The prefill attends in the expanded
    form (k_nope = c W_uk, v = c W_uv per head, PyTorch's own attention
    with v padded to 192 by zeros, which adds nothing); a decode step
    attends in the absorbed form, its algebra: head h's query
    [q_nope W_uk,h | q_pe] in f32 against the latent rows, its output
    (p . c) W_uv,h;
  * MLP: SwiGLU on the leading dense layer; else f32 softmax router
    scores, the greedy top k, weighted by their scores (not renormalised)
    times routed_scaling_factor, the shared experts plus each selected
    expert's bf16 output times its weight, summed in f32;
  * PQCache's prompt state over the latent rows (``pqcache.py``'s
    k-means, codes, histograms, with one kv head of 576 whose values are
    its first 512 columns) and each step's block selection by the
    absorbed queries, on the program's codebooks and codes.

``MlaReference.decode`` runs the steps teacher-forced on given tokens,
returns each judged array's gaps below the step's best logit, and records
the experts each MoE layer selected; given the program's experts of those
steps it computes them instead, each weighted by its own scores, as
``afmoe.py``'s reference does.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.common import budget
from benchmark.reference.afmoe import AfmoeReference
from benchmark.reference.pqcache import Reference, rms_norm
from benchmark.reference.precision import Precision, linear


def _mscale(factor: float, m: float) -> float:
    return 0.1 * m * math.log(factor) + 1.0 if factor > 1 else 1.0


def yarn_inv_freq(m: dict) -> torch.Tensor:
    """YaRN's inverse frequencies of the rope columns (DeepSeek's
    DeepseekV2YarnRotaryEmbedding), or the plain ones without rope
    scaling."""
    dim, base = m["qk_rope_head_dim"], float(m["rope_theta"])
    extra = 1.0 / base ** (torch.arange(0, dim, 2).float() / dim)
    rs = m.get("rope_scaling") or {}
    if not rs:
        return extra
    f = float(rs["factor"])

    def corr(rot):
        return (dim * math.log(rs["original_max_position_embeddings"]
                               / (rot * 2 * math.pi)) / (2 * math.log(base)))
    low = max(math.floor(corr(rs.get("beta_fast", 32))), 0)
    high = min(math.ceil(corr(rs.get("beta_slow", 1))), dim - 1)
    if low == high:
        high += 0.001
    ramp = ((torch.arange(dim // 2).float() - low) / (high - low)).clamp(0, 1)
    return extra / f * ramp + extra * (1.0 - ramp)


def rope_pairs(x: torch.Tensor, pos: torch.Tensor, m: dict) -> torch.Tensor:
    """x [..., T, d] rotated by adjacent pairs at positions pos [T], times
    YaRN's cos / sin scale."""
    ang = pos.float()[:, None] * yarn_inv_freq(m).to(x.device)
    rs = m.get("rope_scaling") or {}
    scale = 1.0
    if rs and rs.get("mscale_all_dim"):
        scale = (_mscale(rs["factor"], rs.get("mscale", 1.0))
                 / _mscale(rs["factor"], rs["mscale_all_dim"]))
    c, s = torch.cos(ang) * scale, torch.sin(ang) * scale
    xp = x.float().reshape(*x.shape[:-1], -1, 2)
    a, b = xp[..., 0], xp[..., 1]
    return torch.stack([a * c - b * s, a * s + b * c], -1).flatten(-2)


def softmax_scale(m: dict) -> float:
    s = (m["qk_nope_head_dim"] + m["qk_rope_head_dim"]) ** -0.5
    rs = m.get("rope_scaling") or {}
    if rs and rs.get("mscale_all_dim"):
        s *= _mscale(rs["factor"], rs["mscale_all_dim"]) ** 2
    return s


class MlaReference(Reference):
    """The reference of one DeepSeek-V2 cell (``wl``: the workload with its
    "model") over weights in the port's layout
    (``benchmark/weights_deepseek_v2.py``). ``state`` holds each layer's
    PQCache state over its latent rows, as ``Reference.state`` does."""

    def __init__(self, wl: dict, weights: dict, device,
                 mode: str = "stated"):
        m = wl["model"]
        self.m, self.wl = m, wl
        self.dev = torch.device(device)
        self.prec = Precision(m["precision"]["weights"],
                              m["precision"]["kv_tail"], mode)
        self.E, self.H = m["hidden_size"], m["num_attention_heads"]
        self.R, self.Dr = m["kv_lora_rank"], m["qk_rope_head_dim"]
        self.Dn, self.Dv_h = m["qk_nope_head_dim"], m["v_head_dim"]
        # the latent cache: one kv head of R + Dr, its values the first R
        self.Hkv, self.D, self.Dv = 1, self.R + self.Dr, self.R
        self.g = self.H
        self.L, self.eps = m["num_hidden_layers"], m["rms_norm_eps"]
        self.Ld = m["first_k_dense_replace"]
        self.topk = m["num_experts_per_tok"]
        self.route_scale = float(m["routed_scaling_factor"])
        self.norm_topk = bool(m.get("norm_topk_prob", False))
        self.sm_scale = softmax_scale(m)
        pq = m["pq"]
        self.S, self.C = pq["n_subvec"], 2 ** pq["n_subbits"]
        self.iters, self.kseed = pq["kmeans_iters"], pq["kmeans_seed"]
        self.block = pq["select_block"]
        self.probe_iters = None
        self.chunk = wl["chunk"]
        b = budget(m, wl["prompt_tokens"])
        self.sink, self.local, self.k_blocks = (b["sink"], b["local"],
                                                b["blocks"])
        w = self.prec.weight
        H, R = self.H, self.R
        self.layers = []
        for i in range(self.L):
            grp, j = ((weights["dense"], i) if i < self.Ld
                      else (weights["moe"], i - self.Ld))
            lp = {k: w(grp[k][j]) for k in ("wq", "w_kv_a", "wo")}
            # kv_b_proj's halves as [in, out] products over all heads
            lp["uk"] = w(grp["w_uk"][j].permute(2, 0, 1).reshape(R, -1))
            lp["uv"] = w(grp["w_uv"][j].permute(1, 0, 2).reshape(R, -1))
            for k in ("uk", "uv"):     # the values those products multiply
                q, s = lp[k]
                lp[k + "_f"] = (q.float() if s is None
                                else q.float() * s).reshape(R, H, -1)
            lp.update({k: grp[k][j] for k in ("ln_in", "ln_post",
                                              "kv_norm")})
            if i < self.Ld:
                lp.update({k: w(grp[k][j]) for k in ("gate", "up", "down")})
            else:
                lp.update({k: w(grp[k][j]) for k in ("shared_gate",
                                                     "shared_up",
                                                     "shared_down")})
                lp["router"] = grp["router"][j].float()
                lp["experts"] = [
                    tuple(w(grp[k][j][e]) for k in (
                        "experts_gate", "experts_up", "experts_down"))
                    for e in range(grp["experts_gate"].shape[1])]
            self.layers.append(lp)
        self.embed = self.prec.embed_rows(weights["embed"])
        self.final_norm = weights["final_norm"]
        self.head = self.prec.weight(weights["lm_head"])

    # -- one layer's pieces ------------------------------------------------

    def _attn_in(self, i: int, x: torch.Tensor, pos: torch.Tensor):
        """Of rows x [T, E] at positions pos [T]: the latent rows [T, 576]
        (bf16 values) and the queries (q_nope [T, H, 128], q_pe
        [T, H, 64])."""
        lp, a, p = self.layers[i], self.prec.act, self.prec
        h = rms_norm(x, lp["ln_in"], self.eps, a)
        y = linear(p, h, lp["w_kv_a"])
        c = rms_norm(y[..., :self.R], lp["kv_norm"], self.eps, a)
        lat = torch.cat([c, a(rope_pairs(y[..., self.R:], pos, self.m))], -1)
        q = linear(p, h, lp["wq"]).reshape(*x.shape[:-1], self.H,
                                           self.Dn + self.Dr)
        q_pe = a(rope_pairs(q[..., self.Dn:].transpose(-3, -2), pos,
                            self.m)).transpose(-3, -2)
        return lat, q[..., :self.Dn], q_pe

    _swiglu = AfmoeReference._swiglu

    def route(self, i: int, h: torch.Tensor, given=None):
        """(weights [T, k] f32, the experts [T, k] this reference selects)
        of normed rows h [T, E]; the weights of the experts ``given``
        [T, k] where given."""
        s = torch.softmax(h @ self.layers[i]["router"], -1)
        w, sel = torch.topk(s, self.topk, dim=-1)
        if given is not None:
            w = s.gather(1, given.to(s.device))
        if self.norm_topk:
            w = w / (w.sum(-1, keepdim=True) + 1e-20)
        return w * self.route_scale, sel

    def _out_mlp(self, i: int, x: torch.Tensor, att: torch.Tensor,
                 routes=None, given=None) -> torch.Tensor:
        """The output product, the residuals and the MLP of rows x [T, E]
        with the heads' outputs att [T, H * 128]; a MoE layer's own
        selection appended to ``routes``, the experts ``given`` [T, k]
        computed where given."""
        lp, a, p = self.layers[i], self.prec.act, self.prec
        x = a(x + linear(p, a(att), lp["wo"]))
        h = rms_norm(x, lp["ln_post"], self.eps, a)
        if i < self.Ld:
            return a(x + self._swiglu(h, lp["gate"], lp["up"], lp["down"]))
        w, sel = self.route(i, h, given)
        if routes is not None:
            routes.append(sel)
        if given is not None:
            sel = given.to(sel.device)
        m = self._swiglu(h, lp["shared_gate"], lp["shared_up"],
                         lp["shared_down"])
        sel_h = sel.cpu().numpy()
        for e in np.unique(sel_h):
            rows, slot = (torch.from_numpy(t).to(self.dev)
                          for t in np.nonzero(sel_h == e))
            y = self._swiglu(h[rows], *lp["experts"][e])
            m = m.index_add(0, rows, y * w[rows, slot, None])
        return a(x + a(m))

    # -- prefill -------------------------------------------------------------

    @torch.no_grad()
    def prefill(self, ids: np.ndarray, centroids=None, codes=None) -> None:
        """The prompt ids [P] through every layer, each layer's PQCache
        state over its latent rows (``Reference._layer_state``;
        ``centroids`` / ``codes`` [L, ...] the program's, as in
        ``Reference.prefill``)."""
        P = int(ids.shape[0])
        self.P, self.n_cand0 = P, P - self.sink - self.local
        if self.n_cand0 <= 0:
            raise ValueError("the prompt leaves no retrieval candidates")
        tok = torch.as_tensor(ids, device=self.dev).long()
        pos = torch.arange(P, device=self.dev)
        a, p = self.prec.act, self.prec
        x = a(self.embed[tok])
        kv_dt = (torch.float32 if self.prec.mode == "f32"
                 else torch.bfloat16)
        H, Dn, Dq = self.H, self.Dn, self.Dn + self.Dr
        self.state = []
        rows = 16384
        for i in range(self.L):
            lp = self.layers[i]
            lat, q_nope, q_pe = self._attn_in(i, x, pos)
            c = lat[:, :self.R]
            k = torch.empty((H, P, Dq), dtype=kv_dt, device=self.dev)
            v = torch.zeros((H, P, Dq), dtype=kv_dt, device=self.dev)
            for r0 in range(0, P, rows):
                r1 = min(r0 + rows, P)
                kn = linear(p, c[r0:r1], lp["uk"]).reshape(r1 - r0, H, Dn)
                k[:, r0:r1, :Dn] = kn.transpose(0, 1).to(kv_dt)
                k[:, r0:r1, Dn:] = lat[None, r0:r1, self.R:].to(kv_dt)
                v[:, r0:r1, :self.Dv_h] = linear(p, c[r0:r1], lp["uv"]
                                                 ).reshape(r1 - r0, H, -1
                                                           ).transpose(0, 1
                                                                       ).to(kv_dt)
            q = torch.cat([q_nope, q_pe], -1).transpose(0, 1).to(kv_dt)
            del q_nope, q_pe
            att = F.scaled_dot_product_attention(
                q[None], k[None], v[None], is_causal=True,
                scale=self.sm_scale)[0, :, :, :self.Dv_h]
            del q, k, v
            att = att.transpose(0, 1).reshape(P, -1).float()
            self.state.append(self._layer_state(
                lat[None], lat[None, :, :self.R],
                None if centroids is None else centroids[i],
                None if codes is None else codes[i]))
            del lat, c
            for r0 in range(0, P, rows):
                x[r0:r0 + rows] = self._out_mlp(i, x[r0:r0 + rows],
                                                att[r0:r0 + rows])
            del att

    # -- decode --------------------------------------------------------------

    @torch.no_grad()
    def decode(self, inputs: np.ndarray, judged, keep=None,
               routes=None, given=None) -> list:
        """Teacher-forced steps of B sequences that share the prefilled
        prompt, as ``Reference.decode``: inputs [B, T], judged arrays
        [B, T]. Returns (the gaps [B, T] of each judged array, the argmax
        [B, T] of each step). ``keep`` receives each step's logits [B, V];
        ``routes`` each step's list of the experts [B, k] each MoE layer
        selects; ``given``, in that form, the experts to compute instead
        (the program's)."""
        inputs = torch.as_tensor(np.asarray(inputs), device=self.dev).long()
        judged = [torch.as_tensor(np.asarray(x), device=self.dev).long()
                  for x in judged]
        B, T = inputs.shape
        gaps = [torch.empty((B, T), device=self.dev) for _ in judged]
        best = torch.empty((B, T), dtype=torch.long, device=self.dev)
        a = self.prec.act
        s = self.sm_scale * math.sqrt(self.D)
        # every layer's decoded latent rows [B, 1, T, 576]
        dk = [torch.zeros((B, 1, T, self.D), device=self.dev)
              for _ in range(self.L)]
        for j in range(T):
            p = torch.full((1,), self.P + j, device=self.dev)
            x = a(self.embed[inputs[:, j]])                  # [B, E]
            flushed = (j // self.chunk) * self.chunk
            step_routes = []
            moe_given = None if given is None else iter(given[j])
            for i in range(self.L):
                lp, st = self.layers[i], self.state[i]
                lat, q_nope, q_pe = self._attn_in(i, x[:, None], p)
                lat, q_nope, q_pe = lat[:, 0], q_nope[:, 0], q_pe[:, 0]
                dk[i][:, 0, j] = lat
                if flushed and j == flushed:
                    dk[i][:, :, j - self.chunk:j] = self._store(
                        dk[i][:, :, j - self.chunk:j], None)
                # the absorbed query: [q_nope W_uk,h | q_pe], in f32,
                # scaled so that _attend's 1/sqrt(576) gives MLA's scale
                q_lat = torch.einsum("bhd,rhd->bhr", q_nope, lp["uk_f"])
                q = torch.cat([q_lat, q_pe], -1) * s
                att = self._attend(
                    st, q, lat[:, None, None], lat[:, None, None, :self.R],
                    dk[i][:, :, :j], dk[i][:, :, :j, :self.R], j)
                o = torch.einsum("bhr,rhd->bhd", att.reshape(B, self.H, -1),
                                 lp["uv_f"]).reshape(B, -1)
                x = self._out_mlp(
                    i, x, o, step_routes,
                    None if moe_given is None or i < self.Ld
                    else next(moe_given))
                self._join(st, j)
            if routes is not None:
                routes.append(step_routes)
            logits = self._logits(x)
            if keep is not None:
                keep.append(logits)
            top = logits.max(-1)
            best[:, j] = top.indices
            for arr, gp in zip(judged, gaps):
                gp[:, j] = top.values - logits.gather(1, arr[:, j:j + 1])[:, 0]
        for st in self.state:
            st["J"].copy_(st["J0"])
        return [gp.cpu().numpy() for gp in gaps], best.cpu().numpy()
