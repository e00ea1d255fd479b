"""Product-quantization math on the single-sequence main path.

Counterpart of the functions of ``pqcache_tpu/core/pq.py`` that the
``pq_search`` decode paths call: batched Lloyd k-means with empty-cluster
relocation, nearest-centroid encoding, the euclidean ADC lookup table and
its gather-sum scores, the uint8 joint code histogram and its block scorer,
the GQA-reduced per-token and per-block top-k, and the exact top-k recall
oracle.

Every selection goes through ``_topk_stable``, which breaks ties toward the
lower index as ``jax.lax.top_k`` does (and ``approx_max_k`` off the TPU);
``torch.topk`` orders ties arbitrarily, and per-token ADC scores tie all the
time (a kv head has at most C^S distinct scores).

Conventions: G = kv heads x subvectors (independent PQ subspaces), N points,
d = subvector dim, C = 2 ** n_subbits centroids.

k-means++ seeding draws from an explicit ``torch.Generator``: it cannot
replay ``jax.random``, so parity with the JAX package is held by passing the
same initial centroids (``kmeans(init_centroids=...)``).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def _topk_stable(x: torch.Tensor, k: int):
    """Largest-k along the last dim with ties broken toward the lower index
    (the order ``jax.lax.top_k`` documents)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


# ---------------------------------------------------------------------------
# Batched Lloyd k-means

class KMeansResult(NamedTuple):
    centroids: torch.Tensor   # [G, C, d] float32
    codes: torch.Tensor       # [G, N] int64 — final assignment of every point


def _assign_chunked(x, w, centroids, chunk: int):
    """Nearest-centroid assignment plus per-cluster sums/counts, over N in
    chunks to bound the [G, chunk, C] distance tensor. x [G, N, d] f32,
    w [G, N] f32 (0/1), centroids [G, C, d].

    Returns (codes [G, N], sums [G, C, d], counts [G, C], point_dist [G, N]
    — each point's squared distance to its centroid)."""
    G, N, d = x.shape
    C = centroids.shape[1]
    cent_sq = (centroids ** 2).sum(-1)                       # [G, C]
    sums = torch.zeros((G, C, d), device=x.device)
    counts = torch.zeros((G, C), device=x.device)
    codes, pdist = [], []
    for n0 in range(0, N, chunk):
        xb, wb = x[:, n0:n0 + chunk], w[:, n0:n0 + chunk]
        # ||x - c||^2 = ||x||^2 - 2 x.c + ||c||^2; ||x||^2 is constant in argmin
        dist = cent_sq[:, None, :] - 2.0 * torch.einsum(
            "gnd,gcd->gnc", xb, centroids)
        dmin, codes_b = dist.min(-1)
        # one-hot matmul: deterministic, unlike atomic scatter-adds on the
        # card (and F.one_hot would check its input with a device sync)
        onehot = ((codes_b[..., None] == torch.arange(C, device=x.device))
                  .float() * wb[..., None])
        sums += torch.einsum("gnc,gnd->gcd", onehot, xb)
        counts += onehot.sum(1)
        codes.append(codes_b)
        pdist.append(dmin + (xb * xb).sum(-1))
    return torch.cat(codes, 1), sums, counts, torch.cat(pdist, 1)


def _kmeanspp_init(x, valid_len: int, n_clusters: int,
                   generator: torch.Generator, pool: int = 4096):
    """k-means++ (D^2 sampling) seeding over a bounded candidate pool, per
    group independent (the JAX package's algorithm, drawn from a
    torch.Generator). x [G, N, d] f32 -> centroids [G, C, d]."""
    G, N, d = x.shape
    P = min(N, pool)
    perm = torch.randperm(N, generator=generator, device=x.device)
    pool_idx = perm[:P] % max(int(valid_len), 1)
    xp = x[:, pool_idx]                                      # [G, P, d]
    first = xp[:, :1]                                        # [G, 1, d]
    min_d2 = ((xp - first) ** 2).sum(-1)                     # [G, P]
    out = [first[:, 0]]
    for _ in range(n_clusters - 1):
        u = torch.rand((G, P), generator=generator, device=x.device)
        gumbel = -torch.log(-torch.log(u.clamp(min=1e-12)))
        logit = torch.where(min_d2 > 0,
                            torch.log(min_d2.clamp(min=1e-30)), -torch.inf)
        pick = (logit + gumbel).argmax(-1)                   # [G]
        c = xp[torch.arange(G, device=x.device), pick]       # [G, d]
        min_d2 = torch.minimum(min_d2, ((xp - c[:, None]) ** 2).sum(-1))
        out.append(c)
    return torch.stack(out, 1)


def kmeans(x: torch.Tensor, n_clusters: int, iters: int, *,
           seed: int = 4321, valid_len=None, chunk: int = 4096,
           init_centroids: Optional[torch.Tensor] = None,
           generator: Optional[torch.Generator] = None) -> KMeansResult:
    """Batched Lloyd k-means over G independent groups.

    x [G, N, d]; points at index >= valid_len are excluded from training.
    Seeds by k-means++ from ``generator`` (a new one seeded with ``seed`` on
    x's device when None), or starts from ``init_centroids`` [G, C, d].
    Runs exactly ``iters`` Lloyd iterations; the e-th empty cluster (by
    cluster index) is relocated to the e-th farthest valid point (sklearn's
    strategy)."""
    G, N, d = x.shape
    x = x.float()
    valid_len = N if valid_len is None else int(valid_len)
    chunk = min(chunk, N)
    Npad = _round_up(N, chunk)
    if Npad != N:
        x = torch.nn.functional.pad(x, (0, 0, 0, Npad - N))
    w = (torch.arange(Npad, device=x.device) < valid_len).float()
    w = w[None].expand(G, Npad)

    if init_centroids is not None:
        centroids = init_centroids.to(device=x.device, dtype=torch.float32)
    else:
        if generator is None:
            generator = torch.Generator(device=x.device).manual_seed(seed)
        centroids = _kmeanspp_init(x, valid_len, n_clusters, generator)

    gidx = torch.arange(G, device=x.device)[:, None]
    for _ in range(iters):
        _, sums, counts, pdist = _assign_chunked(x, w, centroids, chunk)
        new = sums / torch.clamp(counts, min=1.0)[..., None]
        empty = counts <= 0.0                                # [G, C]
        _, far_idx = _topk_stable(torch.where(w > 0, pdist, -1.0),
                                  n_clusters)                # [G, C]
        rank = torch.clamp(torch.cumsum(empty.long(), -1) - 1, 0,
                           n_clusters - 1)
        reloc = x[gidx, far_idx.gather(-1, rank)]            # [G, C, d]
        centroids = torch.where(empty[..., None], reloc, new)
    codes, _, _, _ = _assign_chunked(x, w, centroids, chunk)
    return KMeansResult(centroids=centroids, codes=codes[:, :N])


def pq_encode(x: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    """Nearest-centroid encoding. x [G, M, d], centroids [G, C, d] ->
    codes [G, M] int64."""
    x = x.float()
    dist = (centroids ** 2).sum(-1)[:, None, :] - 2.0 * torch.einsum(
        "gmd,gcd->gmc", x, centroids)
    return dist.argmin(-1)


def adc_lut_euc(q: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    """Inner-product lookup table for the "euc" metric. q [H, S, d] per
    q-head subvectors; centroids [H_kv, S, C, d], shared over the GQA group.
    Returns LUT [H, S, C] f32, LUT[h,s,c] = q[h,s] . centroids[kv(h),s,c]."""
    H, S, d = q.shape
    H_kv = centroids.shape[0]
    qg = q.float().reshape(H_kv, H // H_kv, S, d)
    return torch.einsum("hgsd,hscd->hgsc", qg, centroids.float()).reshape(
        H, S, -1)


def adc_gather_scores(lut: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """Gather and sum the LUT by PQ codes. lut [H, S, C]; codes [H_kv, S, T]
    (shared by each GQA group). Returns scores [H, T] f32 with
    scores[h, t] = sum_s lut[h, s, codes[kv(h), s, t]]."""
    H, S, C = lut.shape
    H_kv, _, T = codes.shape
    g = H // H_kv
    idx = codes.long()[:, None].expand(H_kv, g, S, T)
    return torch.gather(lut.float().reshape(H_kv, g, S, C), -1,
                        idx).sum(2).reshape(H, T)


# ---------------------------------------------------------------------------
# Joint-code-histogram block scorer (S = 2): a block's softmax mass is the
# inner product of exp(LUT_0) x exp(LUT_1) with the block's joint code
# histogram, so one [g, C^2] x [C^2, NB] product scores every block.

def jhist_dtype(block: int) -> torch.dtype:
    """uint8 counts that saturate at 255 (a count reaches 256 only when a
    whole 256-block shares one code pair). Only defined for block <= 256."""
    if block > 256:
        raise ValueError(
            f"joint-histogram scorer requires select_block <= 256 (uint8 "
            f"counts saturate); got block={block}")
    return torch.uint8


def build_joint_hist(codes: torch.Tensor, n_valid: int, *, n_centroids: int,
                     block: int) -> torch.Tensor:
    """codes [H_kv, 2, T] (T % block == 0); tokens at index >= n_valid are
    excluded. Returns J [H_kv, T // block, C^2] uint8, counts saturated at
    255."""
    H_kv, S, T = codes.shape
    if S != 2:
        raise ValueError("joint histogram requires exactly 2 subvectors")
    C = n_centroids
    NB = T // block
    pair = codes[:, 0].long() * C + codes[:, 1].long()       # [H_kv, T]
    seg = (torch.arange(T, device=codes.device) // block)[None] * (C * C) + pair
    ones = (torch.arange(T, device=codes.device) < int(n_valid)).float()
    J = torch.zeros((H_kv, NB * C * C), device=codes.device)
    J.scatter_add_(1, seg, ones[None].expand(H_kv, T))
    return torch.clamp(J, max=255).reshape(H_kv, NB, C * C).to(
        jhist_dtype(block))


def jhist_increment(J: torch.Tensor, idx) -> None:
    """+1 at the advanced index ``idx`` (one cell per row, rows never
    collide), in place, saturating at 255: a wrap at 255 + 1 would zero the
    block's dominant pair."""
    cur = J[idx].int()
    J[idx] = torch.clamp(cur + 1, max=255).to(J.dtype)


def jhist_add_tokens(J: torch.Tensor, codes_tok: torch.Tensor, pos: int, *,
                     n_centroids: int, block: int) -> None:
    """Count newly-joined candidate tokens into the histogram, in place.

    J [..., H_kv, NB, C^2]; codes_tok [..., H_kv, 2] — the joining token's
    codes per (leading dims, kv head); pos: its tail position (the same for
    every leading dim)."""
    C = n_centroids
    pair = codes_tok[..., 0].long() * C + codes_tok[..., 1].long()
    lead = torch.meshgrid(*[torch.arange(n, device=J.device)
                            for n in pair.shape], indexing="ij")
    blk = torch.full_like(pair, int(pos) // block)
    jhist_increment(J, tuple(lead) + (blk, pair))


def jhist_exp_lut(lut: torch.Tensor, head_dim: int) -> torch.Tensor:
    """The scorer's exponentiated LUT factors: e[h, s, c] =
    exp((lut - max_c lut) / sqrt(head_dim))."""
    m = lut.amax(-1, keepdim=True)
    return torch.exp((lut.float() - m) / (head_dim ** 0.5))


def joint_block_mass(lut: torch.Tensor, J: torch.Tensor, *, head_dim: int,
                     normalize: bool = True) -> torch.Tensor:
    """Per-q-head block attention mass from the joint histogram.

    lut [H, 2, C] f32; J [H_kv, NB, C^2]. Returns [H, NB] f32, rows summing
    to 1 over non-empty blocks (normalize=True)."""
    H, S, C = lut.shape
    H_kv = J.shape[0]
    e = jhist_exp_lut(lut, head_dim)                         # [H, 2, C]
    pair = (e[:, 0, :, None] * e[:, 1, None, :]).reshape(H_kv, H // H_kv,
                                                         C * C)
    mass = torch.bmm(pair, J.float().transpose(1, 2)).reshape(H, -1)
    if not normalize:
        return mass
    return mass / torch.clamp(mass.sum(-1, keepdim=True), min=1e-30)


# ---------------------------------------------------------------------------
# GQA-reduced selection from per-token ADC scores (euclidean metric)

def _later_ip():
    raise NotImplementedError(
        "metric='ip' is not ported yet (later slice: non-default pq_search "
        "branches)")


def _valid_masks(n_valid, H_kv: int, group: int, T: int, device):
    """Candidate-validity masks from a scalar n_valid (int or 0-d tensor)
    or a per-kv-head [H_kv] vector. Returns (valid_kv [H_kv or 1, T],
    valid_q [H or 1, T])."""
    pos = torch.arange(T, device=device)
    if isinstance(n_valid, torch.Tensor) and n_valid.dim() == 1:
        valid_kv = pos[None, :] < n_valid.to(device)[:, None]
        # each kv head's row `group` times (no count read on the host)
        return valid_kv, valid_kv[:, None].expand(-1, group, -1).reshape(
            -1, T)
    v = (pos < n_valid)[None, :]
    return v, v


def _group_mass(scores, n_valid, group: int, head_dim: int):
    """Masked softmax(scores / sqrt(head_dim)) per q head, summed over each
    GQA group: (g [H_kv, T], valid_kv)."""
    H, T = scores.shape
    H_kv = H // group
    valid_kv, valid_q = _valid_masks(n_valid, H_kv, group, T, scores.device)
    masked = torch.where(valid_q, scores / (head_dim ** 0.5), -torch.inf)
    probs = torch.where(valid_q, torch.softmax(masked, -1), 0.0)
    return probs.reshape(H_kv, group, T).sum(1), valid_kv


def group_scores(scores: torch.Tensor, n_valid, *, group: int, head_dim: int,
                 metric: str = "euc") -> torch.Tensor:
    """GQA-reduced per-kv-head candidate importances: the softmax attention
    mass summed over each group. scores [H, T]; n_valid scalar or [H_kv].
    Returns [H_kv, T] with invalid candidates at -inf."""
    if metric != "euc":
        _later_ip()
    g, valid_kv = _group_mass(scores, n_valid, group, head_dim)
    return torch.where(valid_kv, g, -torch.inf)


def mips_topk(scores: torch.Tensor, n_valid, k: int, *, group: int,
              head_dim: int, metric: str = "euc", approx: bool = False):
    """GQA-reduced per-token top-k: softmax(scores / sqrt(head_dim)) per q
    head, summed over each group, largest k (ties to the lower index).
    scores [H, T] raw ADC scores; positions >= n_valid (scalar or [H_kv])
    are padding. Returns (topk_idx [H_kv, k] int64, group mass [H_kv, T]).
    ``approx`` gives the exact result, as JAX's approx_max_k off the TPU."""
    if metric != "euc":
        _later_ip()
    g, valid_kv = _group_mass(scores, n_valid, group, head_dim)
    return _topk_stable(torch.where(valid_kv, g, -torch.inf), k)[1], g


def mips_topk_blocks(scores: torch.Tensor, n_valid, k_tokens: int, *,
                     group: int, head_dim: int, block: int,
                     metric: str = "euc", approx: bool = False):
    """Block-granular selection: rank blocks of ``block`` candidates by
    their total GQA-reduced attention mass and take ceil(k_tokens / block)
    of those starting below n_valid. Returns (block_idx [H_kv, k_blocks]
    int64, group mass [H_kv, T])."""
    if metric != "euc":
        _later_ip()
    H, T = scores.shape
    if T % block:
        raise ValueError(f"T={T} must be a multiple of block={block}")
    g, _ = _group_mass(scores, n_valid, group, head_dim)
    blk = g.reshape(H // group, T // block, block).sum(-1)
    return topk_from_block_mass(blk, n_valid, k_tokens, group=1,
                                block=block), g


def topk_from_block_mass(blk_mass: torch.Tensor, n_valid, k_tokens: int, *,
                         group: int, block: int,
                         approx: bool = False) -> torch.Tensor:
    """Block selection from per-q-head block mass: group-sum [H -> H_kv],
    mask blocks past n_valid, exact top-ceil(k_tokens / block).

    blk_mass [H, NB]; n_valid int or [H_kv]. Returns [H_kv, k_blocks] int64.
    ``approx`` is accepted and gives the exact result: the TPU used
    approx_max_k, which is exact off the TPU."""
    H, NB = blk_mass.shape
    k_blocks = max((k_tokens + block - 1) // block, 1)
    g = blk_mass.reshape(H // group, group, NB).sum(1)
    n = n_valid[:, None] if isinstance(n_valid, torch.Tensor) and \
        n_valid.dim() == 1 else n_valid
    blk_valid = torch.arange(NB, device=blk_mass.device)[None] * block < n
    sel = torch.where(blk_valid, g, -torch.inf)
    return _topk_stable(sel, k_blocks)[1]


# ---------------------------------------------------------------------------
# Exact-vs-PQ recall oracle

def exact_topk(q: torch.Tensor, keys: torch.Tensor, n_valid, k: int, *,
               group: int) -> torch.Tensor:
    """Exact per-q-head attention-logit top-k over candidates.
    q [H, d]; keys [H_kv, T, d] -> idx [H, k]."""
    T = keys.shape[1]
    logits = torch.einsum("hd,htd->ht", q.float(),
                          keys.float().repeat_interleave(group, 0))
    valid = torch.arange(T, device=q.device)[None, :] < n_valid
    return _topk_stable(torch.where(valid, logits, -torch.inf), k)[1]


def topk_recall(pq_idx: torch.Tensor, exact_idx: torch.Tensor, *,
                group: int) -> float:
    """Fraction of the exact top-k recovered by the PQ top-k. pq_idx
    [H_kv, k'] is shared by its GQA group; exact_idx [H, k]."""
    pq_rep = pq_idx.repeat_interleave(group, 0)
    hits = (exact_idx[:, :, None] == pq_rep[:, None, :]).any(-1).sum()
    return float(hits) / exact_idx.numel()
