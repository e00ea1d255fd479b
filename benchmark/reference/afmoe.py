"""Plain PyTorch reference of an AFMoE decoder (Arcee's Trinity) served by
PQCache on its full-attention layers.

Imports nothing of the port: the benchmark's own copy of the equations of
``pqcache_tpu_torch/models/afmoe_ref.py`` (which the CPU tests hold this
copy to), computed from the benchmark's weights and prompt in the
configuration's stated precision (``precision.py``: every weight product
from bf16 operands with f32 accumulation, each activation handed on in
bf16, the KV cache in bf16):

  * embedding times sqrt(hidden_size); per layer the sandwich norms
    h += norm_post_attn(attn(norm_in(h))), h += norm_post_mlp(mlp(...));
  * attention: per-head RMSNorm of q and k, RoPE on sliding layers only
    (full layers are NoPE), the output gate attn * sigmoid(x W_gate) before
    o_proj; a sliding layer attends its last ``sliding_window`` keys;
  * MLP: SwiGLU on the leading dense layers; else the router's f32
    sigmoid scores, the top k of scores + expert bias, the selected scores
    normalised and times route_scale, the shared expert plus each selected
    expert's bf16 output times its weight, summed in f32;
  * the full layers keep PQCache's prompt state and select blocks by the
    program's codebooks at each decode step, as ``pqcache.py`` does (its
    k-means, codes, histograms and attention are reused here); the sliding
    layers attend their window with no selection.

``AfmoeReference.decode`` runs the steps teacher-forced on given tokens,
returns each judged array's gaps below the step's best logit, and records
the experts each MoE layer selected at each step. Given the program's
experts of those steps it computes them instead of its own selection,
each weighted by its own scores: a near tie of the router's scores falls
either way under rounding, as a near tie of the codebooks' distances
does, and the reference follows the program's experts as it follows the
program's codes. How often the selections part is judged on its own
(``route_mismatch``).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.common import budget, head_dim
from benchmark.reference.pqcache import (Reference, distortion, kmeans,
                                         rms_norm, rope)
from benchmark.reference.precision import Precision, linear

_ATTN = ("wq", "wk", "wv", "wg", "wo")


class AfmoeReference(Reference):
    """The reference of one AFMoE cell (``wl``: the workload with its
    "model") over weights in the port's layout
    (``benchmark/weights_afmoe.py``). ``state`` holds the full layers'
    PQCache states, in layer order, as ``Reference.state`` does."""

    def __init__(self, wl: dict, weights: dict, device,
                 mode: str = "stated"):
        m = wl["model"]
        self.m, self.wl = m, wl
        self.dev = torch.device(device)
        self.prec = Precision(m["precision"]["weights"],
                              m["precision"]["kv_tail"], mode)
        self.E, self.H = m["hidden_size"], m["num_attention_heads"]
        self.Hkv, self.D = m["num_key_value_heads"], head_dim(m)
        self.g = self.H // self.Hkv
        self.L, self.eps = m["num_hidden_layers"], m["rms_norm_eps"]
        self.theta = m["rope_theta"]
        self.window = [m["sliding_window"] if t == "sliding_attention"
                       else 0 for t in m["layer_types"]]
        self.Ld = m["num_dense_layers"]
        self.topk, self.scale = (m["num_experts_per_tok"],
                                 float(m["route_scale"]))
        self.route_norm = bool(m["route_norm"])
        self.embed_scale = (math.sqrt(self.E) if m.get("mup_enabled", True)
                            else 1.0)
        pq = m["pq"]
        self.S, self.C = pq["n_subvec"], 2 ** pq["n_subbits"]
        self.iters, self.kseed = pq["kmeans_iters"], pq["kmeans_seed"]
        self.block = pq["select_block"]
        self.probe_iters = None
        self.reseed = False
        self.chunk = wl["chunk"]
        b = budget(m, wl["prompt_tokens"])
        self.sink, self.local, self.k_blocks = (b["sink"], b["local"],
                                                b["blocks"])
        w = self.prec.weight
        self.layers = []
        for i in range(self.L):
            grp, j = ((weights["dense"], i) if i < self.Ld
                      else (weights["moe"], i - self.Ld))
            lp = {k: w(grp[k][j]) for k in _ATTN}
            lp.update({k: grp[k][j] for k in ("ln_in", "ln_post_attn",
                                              "ln_pre_mlp", "ln_post_mlp",
                                              "q_norm", "k_norm")})
            if i < self.Ld:
                lp.update({k: w(grp[k][j]) for k in ("gate", "up", "down")})
            else:
                lp.update({k: w(grp[k][j]) for k in ("shared_gate",
                                                     "shared_up",
                                                     "shared_down")})
                lp["router"] = grp["router"][j].float()
                lp["bias"] = grp["expert_bias"][j].float()
                lp["experts"] = [
                    tuple(w(grp[k][j][e]) for k in (
                        "experts_gate", "experts_up", "experts_down"))
                    for e in range(grp["experts_gate"].shape[1])]
            self.layers.append(lp)
        self.full = [i for i in range(self.L) if not self.window[i]]
        self.embed = self.prec.embed_rows(weights["embed"])
        self.final_norm = weights["final_norm"]
        self.head = self.prec.weight(weights["lm_head"])

    def _layer_state(self, k: torch.Tensor, v: torch.Tensor,
                     cent=None, given=None) -> dict:
        """``Reference._layer_state``; with ``reseed`` set, its "fit" also
        holds "reseed": the fit of the reference's own k-means of the same
        keys drawn from the next seed, the spread that k-means itself
        leaves between two sound codebooks."""
        st = super()._layer_state(k, v, cent, given)
        if self.reseed:
            N, d = k.shape[1] - self.sink, self.D // self.S
            groups = k[:, self.sink:].reshape(self.Hkv, N, self.S, d)
            groups = groups.transpose(1, 2).reshape(self.Hkv * self.S, N, d)
            st["fit"]["reseed"] = distortion(groups, *kmeans(
                groups, self.C, self.iters, self.kseed + 1))
        return st

    # -- one layer's pieces ------------------------------------------------

    def _qkvg(self, i: int, x: torch.Tensor, pos: torch.Tensor):
        """q [..., H, T, D], k and v [..., Hkv, T, D] (normed, rope'd on a
        sliding layer) and the gate's product [..., T, H * D] of rows
        x [..., T, E] at positions pos."""
        lp, a, p = self.layers[i], self.prec.act, self.prec
        h = rms_norm(x, lp["ln_in"], self.eps, a)

        def heads(y, n, norm=None):
            y = y.reshape(*y.shape[:-1], n, self.D)
            if norm is not None:
                y = rms_norm(y, norm, self.eps, a)
            return y.transpose(-3, -2)
        q = heads(linear(p, h, lp["wq"]), self.H, lp["q_norm"])
        k = heads(linear(p, h, lp["wk"]), self.Hkv, lp["k_norm"])
        v = heads(linear(p, h, lp["wv"]), self.Hkv)
        if self.window[i]:
            q, k = a(rope(q, pos, self.theta)), a(rope(k, pos, self.theta))
        return q, k, v, linear(p, h, lp["wg"])

    def _swiglu(self, x: torch.Tensor, gate, up, down) -> torch.Tensor:
        a = self.prec.act
        return linear(self.prec, a(a(F.silu(linear(self.prec, x, gate)))
                                   * linear(self.prec, x, up)), down)

    def route(self, i: int, h: torch.Tensor, given=None):
        """(weights [T, k] f32, the experts [T, k] this reference selects)
        of normed rows h [T, E]; the weights of the experts ``given``
        [T, k] where given."""
        lp = self.layers[i]
        s = torch.sigmoid(h @ lp["router"])
        sel = torch.topk(s + lp["bias"], self.topk, dim=-1).indices
        w = s.gather(1, sel if given is None else given)
        if self.route_norm:
            w = w / (w.sum(-1, keepdim=True) + 1e-20)
        return w * self.scale, sel

    def _out_mlp(self, i: int, x: torch.Tensor, att: torch.Tensor,
                 g: torch.Tensor, routes=None, given=None) -> torch.Tensor:
        """The gate, the output product, the sandwich norms and the MLP of
        rows x [T, E] with attention rows att [T, H * D] and the gate's
        product g; a MoE layer's own selection appended to ``routes``, the
        experts ``given`` [T, k] computed where given."""
        lp, a, p = self.layers[i], self.prec.act, self.prec
        o = a(a(att) * a(torch.sigmoid(g)))
        x = a(x + rms_norm(linear(p, o, lp["wo"]), lp["ln_post_attn"],
                           self.eps, a))
        h = rms_norm(x, lp["ln_pre_mlp"], self.eps, a)
        if i < self.Ld:
            m = self._swiglu(h, lp["gate"], lp["up"], lp["down"])
        else:
            w, sel = self.route(i, h, given)
            if routes is not None:
                routes.append(sel)
            if given is not None:
                sel = given.to(sel.device)
            m = self._swiglu(h, lp["shared_gate"], lp["shared_up"],
                             lp["shared_down"])
            # the (row, slot) pairs of each selected expert, found on the
            # host in one read of the selection
            sel_h = sel.cpu().numpy()
            for e in np.unique(sel_h):
                rows, slot = (torch.from_numpy(t).to(self.dev)
                              for t in np.nonzero(sel_h == e))
                y = self._swiglu(h[rows], *lp["experts"][e])
                m = m.index_add(0, rows, y * w[rows, slot, None])
            m = a(m)
        return a(x + rms_norm(m, lp["ln_post_mlp"], self.eps, a))

    # -- prefill -------------------------------------------------------------

    @torch.no_grad()
    def prefill(self, ids: np.ndarray, centroids=None, codes=None) -> None:
        """The prompt ids [P] through every layer: each full layer's PQCache
        state (``Reference._layer_state``: sink, tail, codebooks, codes,
        histograms; ``centroids`` / ``codes`` [L_full, ...] the program's,
        as in ``Reference.prefill``), each sliding layer's last window of
        keys and values."""
        P = int(ids.shape[0])
        self.P, self.n_cand0 = P, P - self.sink - self.local
        if self.n_cand0 <= 0:
            raise ValueError("the prompt leaves no retrieval candidates")
        tok = torch.as_tensor(ids, device=self.dev).long()
        pos = torch.arange(P, device=self.dev)
        a = self.prec.act
        x = a(self.embed[tok] * self.embed_scale)
        kv_dt = (torch.float32 if self.prec.mode == "f32"
                 else torch.bfloat16)
        self.state, self.win = [], {}
        rows = 16384
        for i in range(self.L):
            q, k, v, g = self._qkvg(i, x, pos)
            qb, kb, vb = q.to(kv_dt), k.to(kv_dt), v.to(kv_dt)
            del q, k, v
            W = self.window[i]
            if W:
                att = torch.empty((self.H, P, self.D), dtype=kv_dt,
                                  device=self.dev)
                for r0 in range(0, P, 2048):
                    r1 = min(r0 + 2048, P)
                    k0 = max(r0 - W + 1, 0)
                    d = (pos[r0:r1, None] - pos[None, k0:r1])
                    band = (d >= 0) & (d < W)
                    att[:, r0:r1] = F.scaled_dot_product_attention(
                        qb[None, :, r0:r1],
                        kb[:, k0:r1].repeat_interleave(self.g, 0)[None],
                        vb[:, k0:r1].repeat_interleave(self.g, 0)[None],
                        attn_mask=band)[0]
                self.win[i] = (kb[:, max(P - W, 0):].float(),
                               vb[:, max(P - W, 0):].float())
            else:
                att = F.scaled_dot_product_attention(
                    qb[None], kb.repeat_interleave(self.g, 0)[None],
                    vb.repeat_interleave(self.g, 0)[None],
                    is_causal=True)[0]
                n = len(self.state)
                self.state.append(self._layer_state(
                    kb.float(), vb.float(),
                    None if centroids is None else centroids[n],
                    None if codes is None else codes[n]))
            del qb, kb, vb
            att = att.transpose(0, 1).reshape(P, -1).float()
            for r0 in range(0, P, rows):
                x[r0:r0 + rows] = self._out_mlp(i, x[r0:r0 + rows],
                                                att[r0:r0 + rows],
                                                g[r0:r0 + rows])
            del att, g

    # -- decode --------------------------------------------------------------

    def _attend_window(self, i: int, q, wk, wv) -> torch.Tensor:
        """Attention of q [B, H, D] over a sliding layer's window keys and
        values [B, Hkv, W, D] (the new token's last)."""
        B = q.shape[0]
        qg = q.reshape(B, self.Hkv, self.g, self.D)
        s = torch.einsum("bhgd,bhwd->bhgw", qg, wk) / math.sqrt(self.D)
        return torch.einsum("bhgw,bhwd->bhgd", torch.softmax(s, -1),
                            wv).reshape(B, -1)

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
        # every layer's decoded K/V: [B, Hkv, T, D]
        dk = [torch.zeros((B, self.Hkv, T, self.D), device=self.dev)
              for _ in range(self.L)]
        dv = [torch.zeros_like(t) for t in dk]
        for j in range(T):
            p = torch.full((1,), self.P + j, device=self.dev)
            x = a(self.embed[inputs[:, j]] * self.embed_scale)[:, None]
            flushed = (j // self.chunk) * self.chunk
            step_routes = []
            moe_given = None if given is None else iter(given[j])
            for i in range(self.L):
                q, k, v, g = self._qkvg(i, x, p)
                k, v = a(k[:, :, 0]), a(v[:, :, 0])
                dk[i][:, :, j], dv[i][:, :, j] = k, v
                W = self.window[i]
                if W:
                    wk, wv = self.win[i]
                    keep_n = W - 1 - j        # prompt rows still in window
                    keys = [dk[i][:, :, max(j + 1 - W, 0):j + 1]]
                    vals = [dv[i][:, :, max(j + 1 - W, 0):j + 1]]
                    if keep_n > 0:
                        keys.insert(0, wk[:, -keep_n:].expand(B, -1, -1, -1))
                        vals.insert(0, wv[:, -keep_n:].expand(B, -1, -1, -1))
                    att = self._attend_window(i, q[:, :, 0],
                                              torch.cat(keys, 2),
                                              torch.cat(vals, 2))
                else:
                    st = self.state[self.full.index(i)]
                    if flushed and j == flushed:
                        for d, s_ in ((dk, "k_scale"), (dv, "v_scale")):
                            d[i][:, :, j - self.chunk:j] = self._store(
                                d[i][:, :, j - self.chunk:j], st[s_])
                    att = self._attend(st, q[:, :, 0], k[:, :, None],
                                       v[:, :, None], dk[i][:, :, :j],
                                       dv[i][:, :, :j], j)
                x = self._out_mlp(
                    i, x[:, 0], att, g[:, 0], step_routes,
                    None if moe_given is None or i < self.Ld
                    else next(moe_given))[:, None]
                if not W:
                    self._join(st, j)
            if routes is not None:
                routes.append(step_routes)
            logits = self._logits(x[:, 0])
            if keep is not None:
                keep.append(logits)
            top = logits.max(-1)
            best[:, j] = top.indices
            for arr, gp in zip(judged, gaps):
                gp[:, j] = top.values - logits.gather(1, arr[:, j:j + 1])[:, 0]
        for st in self.state:
            st["J"].copy_(st["J0"])
        return [gp.cpu().numpy() for gp in gaps], best.cpu().numpy()


def route_mismatch(a: list, b: list) -> float:
    """The share of (step, MoE layer, sequence) whose selected expert sets
    differ between two routings: lists over steps of lists over MoE layers
    of experts [B, k]."""
    n = bad = 0
    for sa, sb in zip(a, b):
        for x, y in zip(sa, sb):
            xs = torch.sort(x.to(y.device), -1).values
            ys = torch.sort(y, -1).values
            bad += int((xs != ys).any(-1).sum())
            n += x.shape[0]
    return bad / max(n, 1)
