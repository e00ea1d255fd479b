"""Plain PyTorch reference of a Mistral-family decoder served by PQCache.

Imports nothing of the port. It computes, from the benchmark's own weights
and prompt, what the configuration states:

  * the prefill: RMSNorm, RoPE (rotate-half), GQA causal attention, SwiGLU,
    in f32 with every weight product taken from bf16 operands (or the
    configuration's int8 weights) with f32 accumulation
    (``precision.linear``); the KV cache in bf16;
  * PQCache's prompt state per layer: the first ``sink`` tokens kept
    verbatim; the rest (the tail) split into ``n_subvec`` subvectors per kv
    head, clustered by Lloyd k-means (``kmeans_iters`` iterations, k-means++
    seeding over a pool of 4096 drawn from a torch.Generator seeded with
    ``kmeans_seed``, an empty cluster moved to the farthest point), each
    token coded by its nearest centroid; an int8 tail quantized per channel
    (absmax / 127 over the prompt's tail);
  * each decode step: for every query head the ADC table q . centroid, the
    softmax mass of each candidate block of ``select_block`` tokens from its
    tokens' codes (exp((LUT - max) / sqrt(D)) of both subvectors,
    multiplied), normalized per head and summed over the GQA group, the top
    ceil(topk / block) blocks (ties to the lower index); attention over the
    sink, the selected blocks' candidates, the last ``local`` tokens and
    the new one. Candidates are the tail tokens older than the local window.
    A decoded token's K/V stays bf16 until the end of its chunk of
    ``chunk`` steps, then is stored in the tail's format.

``Reference.decode`` runs the steps teacher-forced on given tokens and
returns, for each array of judged tokens, the gap by which each judged
token's logit lies below the step's best logit.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.common import budget, head_dim
from benchmark.reference.precision import Precision, linear, mm_f32

KMEANS_POOL = 4096
_W = ("wq", "wk", "wv", "wo", "gate", "up", "down")


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float,
             act=lambda t: t) -> torch.Tensor:
    """f32 statistics; the normed rows handed on (``act``) before the
    weight multiplies them."""
    return act(act(x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps))
               * w.float())


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotate-half RoPE of x [..., T, D] at positions pos [T] (or
    broadcastable [..., T])."""
    D = x.shape[-1]
    inv = 1.0 / (theta ** (torch.arange(0, D, 2, dtype=torch.float32,
                                        device=x.device) / D))
    ang = pos.float()[..., None] * inv
    c, s = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :D // 2], x[..., D // 2:]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], -1)


def _stable_topk(x: torch.Tensor, k: int) -> torch.Tensor:
    return torch.sort(x, dim=-1, descending=True, stable=True)[1][..., :k]


def kmeans(x: torch.Tensor, C: int, iters: int, seed: int,
           chunk: int = 4096):
    """Lloyd k-means of G groups of points x [G, N, d] f32. Returns
    (centroids [G, C, d], codes [G, N])."""
    G, N, d = x.shape
    dev = x.device
    gen = torch.Generator(device=dev).manual_seed(seed)
    # the pool is drawn over N rounded up to the assignment's chunk, and
    # folded onto the N points
    n_draw = -(-N // min(chunk, N)) * min(chunk, N)
    pool = min(n_draw, KMEANS_POOL)
    perm = torch.randperm(n_draw, generator=gen, device=dev)
    xp = x[:, perm[:pool] % N]                               # [G, pool, d]
    d2 = ((xp - xp[:, :1]) ** 2).sum(-1)
    cents = [xp[:, 0]]
    rows = torch.arange(G, device=dev)
    for _ in range(C - 1):
        u = torch.rand((G, pool), generator=gen, device=dev)
        gumbel = -torch.log(-torch.log(u.clamp(min=1e-12)))
        logit = torch.where(d2 > 0, torch.log(d2.clamp(min=1e-30)),
                            -torch.inf)
        c = xp[rows, (logit + gumbel).argmax(-1)]
        d2 = torch.minimum(d2, ((xp - c[:, None]) ** 2).sum(-1))
        cents.append(c)
    cent = torch.stack(cents, 1)

    def assign(cent):
        c2 = (cent ** 2).sum(-1)
        codes, sums, counts, dist = [], 0.0, 0.0, []
        for n0 in range(0, N, chunk):
            xb = x[:, n0:n0 + chunk]
            dm, cb = (c2[:, None] - 2.0 * torch.einsum(
                "gnd,gcd->gnc", xb, cent)).min(-1)
            onehot = (cb[..., None] == torch.arange(C, device=dev)).float()
            sums = sums + torch.einsum("gnc,gnd->gcd", onehot, xb)
            counts = counts + onehot.sum(1)
            codes.append(cb)
            dist.append(dm + (xb * xb).sum(-1))
        return torch.cat(codes, 1), sums, counts, torch.cat(dist, 1)

    for _ in range(iters):
        _, sums, counts, dist = assign(cent)
        new = sums / torch.clamp(counts, min=1.0)[..., None]
        empty = counts <= 0
        far = _stable_topk(dist, C)
        rank = torch.clamp(torch.cumsum(empty.long(), -1) - 1, 0, C - 1)
        reloc = x[rows[:, None], far.gather(-1, rank)]
        cent = torch.where(empty[..., None], reloc, new)
    return cent, assign(cent)[0]


def nearest(x: torch.Tensor, cent: torch.Tensor,
            chunk: int = 4096) -> torch.Tensor:
    """The nearest centroid [G, N] of points x [G, N, d] among cent
    [G, C, d]."""
    c2 = (cent ** 2).sum(-1)
    return torch.cat([(c2[:, None] - 2.0 * torch.einsum(
        "gnd,gcd->gnc", x[:, n0:n0 + chunk], cent)).argmin(-1)
        for n0 in range(0, x.shape[1], chunk)], 1)


def distortion(x: torch.Tensor, cent: torch.Tensor, codes: torch.Tensor,
               chunk: int = 16384) -> float:
    """The mean squared distance of points x [G, N, d] to their coded
    centroids cent[g, codes[g, n]] (cent [G, C, d], codes [G, N])."""
    G, N, d = x.shape
    tot = 0.0
    for n0 in range(0, N, chunk):
        c = codes[:, n0:n0 + chunk].long()
        y = cent.gather(1, c[..., None].expand(-1, -1, d))
        tot += float(((x[:, n0:n0 + chunk] - y) ** 2).sum())
    return tot / (G * N)


class Reference:
    """The reference of one cell (``wl``: the workload with its "model"),
    over weights in the port's layout (``benchmark/weights.py``)."""

    def __init__(self, wl: dict, weights: dict, device, mode: str = "stated"):
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
        pq = m["pq"]
        self.S, self.C = pq["n_subvec"], 2 ** pq["n_subbits"]
        self.iters, self.kseed = pq["kmeans_iters"], pq["kmeans_seed"]
        self.block = pq["select_block"]
        # k-means iterations of a further codebook whose fit prefill reads
        # ("probe"): the calibration's reading of a k-means cut short
        self.probe_iters = None
        self.chunk = wl["chunk"]
        b = budget(m, wl["prompt_tokens"])
        self.sink, self.local, self.k_blocks = (b["sink"], b["local"],
                                                b["blocks"])
        lay = weights["layers"]
        self.layers = [{k: self.prec.weight(lay[k][i]) for k in _W}
                       for i in range(self.L)]
        self.norms = [(lay["ln1"][i], lay["ln2"][i]) for i in range(self.L)]
        self.embed = self.prec.embed_rows(weights["embed"])
        self.final_norm = weights["final_norm"]
        self.head = self.prec.weight(weights["lm_head"])

    # -- one layer's pieces ------------------------------------------------

    def _qkv(self, i: int, x: torch.Tensor, pos: torch.Tensor):
        """q [..., H, T, D], k and v [..., Hkv, T, D] (rope'd) of rows
        x [..., T, E] at positions pos."""
        lp, a = self.layers[i], self.prec.act
        h = rms_norm(x, self.norms[i][0], self.eps, a)
        T = x.shape[-2]

        def heads(y, n):
            return y.reshape(*y.shape[:-2], T, n, self.D).transpose(-3, -2)
        q = a(rope(heads(linear(self.prec, h, lp["wq"]), self.H), pos,
                   self.theta))
        k = a(rope(heads(linear(self.prec, h, lp["wk"]), self.Hkv), pos,
                   self.theta))
        v = heads(linear(self.prec, h, lp["wv"]), self.Hkv)
        return q, k, v

    def _out_mlp(self, i: int, x: torch.Tensor, att: torch.Tensor):
        """The residual, the attention output product and the MLP of rows
        x [..., T, E], att [..., T, H * D]."""
        lp, a = self.layers[i], self.prec.act
        x = a(x + linear(self.prec, a(att), lp["wo"]))
        h = rms_norm(x, self.norms[i][1], self.eps, a)
        gate, up = linear(self.prec, h, lp["gate"]), linear(self.prec, h,
                                                            lp["up"])
        return a(x + linear(self.prec, a(a(F.silu(gate)) * up), lp["down"]))

    def _store(self, x: torch.Tensor, scale) -> torch.Tensor:
        """K or V rows as the tail holds them, f32."""
        qmax = self.prec.tail_bits()
        if not qmax:
            return x if self.prec.mode == "f32" else x.to(
                torch.bfloat16).float()
        return torch.clamp(torch.round(x.float() / scale), -qmax,
                           qmax) * scale

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        """f32 logits of the last rows x [n, E]; a bf16 head's product is
        handed on in bf16, an int8 head's scaled in f32."""
        h = rms_norm(x, self.final_norm, self.eps, self.prec.act)
        q, s = self.head
        if s is None or self.prec.mode == "fp8":
            return linear(self.prec, h, self.head)
        return self.prec.act(mm_f32(h, q)) * s

    # -- prefill -------------------------------------------------------------

    @torch.no_grad()
    def prefill(self, ids: np.ndarray, centroids=None, codes=None) -> None:
        """The prompt ids [P] (no padding) through every layer: each
        layer's sink, tail store, codebooks, codes and candidate-block code
        histogram. ``centroids`` [L, Hkv, S, C, d]: codebooks to code the
        keys with instead of training them (the program's, which no other
        computation can give: k-means++ picks its seeds by an argmax over
        noisy distances, so keys that differ by a rounding seed another,
        equally good, codebook). ``codes`` [L, Hkv, S, >= N]: the tail's
        codes to select by (the program's); the reference's own coding of
        its keys is kept beside them as "own_codes". Each layer's "fit"
        holds the mean squared distance of the tail keys to their coded
        centroids under the codebook and codes in use ("used") and under
        the reference's own k-means of its keys ("own"), so that the
        codebooks that were followed are judged all the same."""
        P = int(ids.shape[0])
        self.P, self.n_cand0 = P, P - self.sink - self.local
        if self.n_cand0 <= 0:
            raise ValueError("the prompt leaves no retrieval candidates")
        tok = torch.as_tensor(ids, device=self.dev).long()
        pos = torch.arange(P, device=self.dev)
        x = self.prec.act(self.embed[tok])
        self.state = []
        rows = 16384
        for i in range(self.L):
            q, k, v = self._qkv(i, x, pos)
            kv_dt = (torch.float32 if self.prec.mode == "f32"
                     else torch.bfloat16)
            kb, vb = k.to(kv_dt), v.to(kv_dt)
            del k, v
            # causal attention of bf16 q / K / V (the cache's format),
            # accumulated in f32 by PyTorch's own attention
            o = F.scaled_dot_product_attention(
                q.to(kv_dt)[None],
                kb.repeat_interleave(self.g, 0)[None],
                vb.repeat_interleave(self.g, 0)[None], is_causal=True)[0]
            del q
            att = o.transpose(0, 1).reshape(P, -1).float()
            del o
            self.state.append(self._layer_state(
                kb.float(), vb.float(),
                None if centroids is None else centroids[i],
                None if codes is None else codes[i]))
            del kb, vb
            for r0 in range(0, P, rows):
                x[r0:r0 + rows] = self._out_mlp(i, x[r0:r0 + rows],
                                                att[r0:r0 + rows])
            del att

    def _layer_state(self, k: torch.Tensor, v: torch.Tensor,
                     cent=None, given=None) -> dict:
        """One layer's PQCache state from its bf16 K/V [Hkv, P, D]."""
        sk, S, C, D = self.sink, self.S, self.C, self.D
        kt, vt = k[:, sk:], v[:, sk:]
        N = kt.shape[1]
        d = D // S
        groups = kt.reshape(self.Hkv, N, S, d).transpose(1, 2).reshape(
            self.Hkv * S, N, d)
        # the reference's own k-means of its keys: the codebook whose fit
        # (mean squared distance of each key to its coded centroid) the one
        # in use is held to
        mine = kmeans(groups, C, self.iters, self.kseed)
        if cent is None:
            cent, codes = mine
        else:
            cent = torch.as_tensor(cent, device=self.dev).float().reshape(
                self.Hkv * S, C, d)
            codes = nearest(groups, cent)
        own = codes = codes.reshape(self.Hkv, S, N)
        if given is not None:
            codes = torch.as_tensor(given, device=self.dev)[..., :N].long()
        fit = dict(used=distortion(groups, cent, codes.reshape(-1, N)),
                   own=distortion(groups, *mine))
        if self.probe_iters is not None:
            fit["probe"] = distortion(groups, *kmeans(
                groups, C, self.probe_iters, self.kseed))
        qmax = self.prec.tail_bits()
        ks = vs = None
        if qmax:
            ks = torch.clamp(kt.abs().amax(1, keepdim=True) / qmax, min=1e-8)
            vs = torch.clamp(vt.abs().amax(1, keepdim=True) / qmax, min=1e-8)
        # histogram of the candidates' code pairs per block: [Hkv, C*C, NB]
        NB = -(-N // self.block)
        pair = codes[:, 0] * C + codes[:, 1]                 # [Hkv, N]
        t = torch.arange(self.n_cand0, device=self.dev)
        J = torch.zeros((self.Hkv, C * C, NB), device=self.dev)
        J.index_put_((torch.arange(self.Hkv, device=self.dev)[:, None],
                      pair[:, :self.n_cand0], (t // self.block)[None]),
                     torch.ones((), device=self.dev), accumulate=True)
        J = torch.clamp(J, max=255.0)
        return dict(k_sink=k[:, :sk], v_sink=v[:, :sk], own_codes=own,
                    fit=fit,
                    k_tail=self._store(kt, ks), v_tail=self._store(vt, vs),
                    k_scale=ks, v_scale=vs,
                    cent=cent.reshape(self.Hkv, S, C, d), pair=pair,
                    J=J, J0=J.clone())

    # -- decode --------------------------------------------------------------

    def _select(self, st: dict, q: torch.Tensor, n_cand: int):
        """Selected block ids [B, Hkv, kb] of queries q [B, H, D]."""
        B = q.shape[0]
        S, C, d = self.S, self.C, self.D // self.S
        qs = q.reshape(B, self.Hkv, self.g, S, d)
        lut = torch.einsum("bhgsd,hscd->bhgsc", qs, st["cent"])
        e = torch.exp((lut - lut.amax(-1, keepdim=True)) / math.sqrt(self.D))
        pair = (e[..., 0, :, None] * e[..., 1, None, :]).reshape(
            B, self.Hkv, self.g, C * C)
        mass = torch.einsum("bhgp,hpn->bhgn", pair, st["J"])
        mass = mass / torch.clamp(mass.sum(-1, keepdim=True), min=1e-30)
        blk = mass.sum(2)                                    # [B, Hkv, NB]
        NB = blk.shape[-1]
        ok = torch.arange(NB, device=self.dev) * self.block < n_cand
        return _stable_topk(torch.where(ok, blk, -torch.inf), self.k_blocks)

    def _attend(self, st: dict, q, k_new, v_new, dec_k, dec_v, j: int):
        """Attention of q [B, H, D] at turn step j over the sink, the
        selected candidates, the local window and the new token."""
        B = q.shape[0]
        sk, bs, P = self.sink, self.block, self.P
        n_cand = self.n_cand0 + j
        blk = self._select(st, q, n_cand)                    # [B, Hkv, kb]
        rows = (blk[..., None] * bs + torch.arange(bs, device=self.dev)
                ).reshape(B, self.Hkv, -1)                   # tail rows
        valid = rows < n_cand
        rows = rows.clamp(max=st["k_tail"].shape[1] - 1)
        hk = torch.arange(self.Hkv, device=self.dev)[None, :, None]
        k_sel, v_sel = st["k_tail"][hk, rows], st["v_tail"][hk, rows]
        # the window: tail rows [n_cand, P - sk), then the decoded tokens
        w0 = n_cand
        kw = st["k_tail"][:, w0:].expand(B, -1, -1, -1)
        vw = st["v_tail"][:, w0:].expand(B, -1, -1, -1)
        keys = [st["k_sink"].expand(B, -1, -1, -1), k_sel, kw, dec_k,
                k_new]
        vals = [st["v_sink"].expand(B, -1, -1, -1), v_sel, vw, dec_v,
                v_new]
        mask = torch.cat([
            torch.ones((B, self.Hkv, sk), dtype=torch.bool, device=self.dev),
            valid,
            torch.ones((B, self.Hkv, kw.shape[2] + dec_k.shape[2] + 1),
                       dtype=torch.bool, device=self.dev)], -1)
        K, V = torch.cat(keys, 2), torch.cat(vals, 2)        # [B, Hkv, W, D]
        qg = q.reshape(B, self.Hkv, self.g, self.D)
        s = torch.einsum("bhgd,bhwd->bhgw", qg, K) / math.sqrt(self.D)
        s = torch.where(mask[:, :, None], s, -torch.inf)
        p = torch.softmax(s, -1)
        return torch.einsum("bhgw,bhwd->bhgd", p, V).reshape(B, -1)

    @torch.no_grad()
    def decode(self, inputs: np.ndarray, judged, keep=None) -> list:
        """Teacher-forced steps of B sequences that share the prefilled
        prompt: inputs [B, T] (the token fed at each step, at positions
        P ...), judged: arrays [B, T] of tokens judged at each step. Returns
        (the gaps [B, T] of each judged array: the step's best logit minus
        the judged token's; the argmax [B, T] of each step). ``keep``: a
        list that receives each step's logits [B, V]."""
        inputs = torch.as_tensor(np.asarray(inputs), device=self.dev).long()
        judged = [torch.as_tensor(np.asarray(a), device=self.dev).long()
                  for a in judged]
        B, T = inputs.shape
        gaps = [torch.empty((B, T), device=self.dev) for _ in judged]
        best = torch.empty((B, T), dtype=torch.long, device=self.dev)
        # decoded tokens' K/V per layer: bf16 values, and the stored ones
        dk = [torch.zeros((B, self.Hkv, T, self.D), device=self.dev)
              for _ in range(self.L)]
        dv = [torch.zeros_like(t) for t in dk]
        for j in range(T):
            p = torch.full((1,), self.P + j, device=self.dev)
            x = self.prec.act(self.embed[inputs[:, j]])[:, None]  # [B, 1, E]
            flushed = (j // self.chunk) * self.chunk
            for i, st in enumerate(self.state):
                q, k, v = self._qkv(i, x, p)
                # the step's own K/V and the ring's stay bf16
                k, v = self.prec.act(k[:, :, 0]), self.prec.act(v[:, :, 0])
                dk[i][:, :, j], dv[i][:, :, j] = k, v
                if flushed and j == flushed:
                    dk[i][:, :, j - self.chunk:j] = self._store(
                        dk[i][:, :, j - self.chunk:j], st["k_scale"])
                    dv[i][:, :, j - self.chunk:j] = self._store(
                        dv[i][:, :, j - self.chunk:j], st["v_scale"])
                att = self._attend(st, q[:, :, 0], k[:, :, None],
                                   v[:, :, None], dk[i][:, :, :j],
                                   dv[i][:, :, :j], j)
                x = self._out_mlp(i, x, att[:, None])
                self._join(st, j)
            logits = self._logits(x[:, 0])
            if keep is not None:
                keep.append(logits)
            top = logits.max(-1)
            best[:, j] = top.indices
            for a, g in zip(judged, gaps):
                g[:, j] = top.values - logits.gather(1, a[:, j:j + 1])[:, 0]
        for st in self.state:
            st["J"].copy_(st["J0"])
        return [g.cpu().numpy() for g in gaps], best.cpu().numpy()

    def _join(self, st: dict, j: int) -> None:
        """After step j the token at tail row n_cand joins the layer's
        candidate histogram (saturating at 255, as a uint8 count)."""
        t = self.n_cand0 + j
        idx = (torch.arange(self.Hkv, device=self.dev), st["pair"][:, t],
               torch.full((self.Hkv,), t // self.block, device=self.dev))
        st["J"][idx] = torch.clamp(st["J"][idx] + 1.0, max=255.0)
