"""Product-quantization math on the single-sequence main path.

Counterpart of the functions of ``pqcache_tpu/core/pq.py`` that the
``pq_search`` decode paths call: the MIPS-to-L2 lift of the "ip" metric,
batched Lloyd k-means with empty-cluster relocation, nearest-centroid
encoding, the euclidean and ip ADC lookup tables and their gather-sum
scores, the uint8 joint code histogram and its block scorer, the
GQA-reduced per-token and per-block top-k of both metrics, and the exact
top-k recall oracle. The layer decisions that the ``pq_search`` policy and
the host-offload tier share live here too: the subvector split
(``to_groups``), the LUT and the encode by metric (``adc_lut``,
``encode``), a layer's codebook training (``train_layer``) and where the
joint-histogram scorer applies (``jhist_applies``).

Every selection goes through ``_topk_stable``, which breaks ties toward the
lower index as ``jax.lax.top_k`` does (and ``approx_max_k`` off the TPU);
``torch.topk`` orders ties arbitrarily, and per-token ADC scores tie all the
time (a kv head has at most C^S distinct scores).

Conventions: G = kv heads x subvectors (independent PQ subspaces), N points,
d = subvector dim, C = 2 ** n_subbits centroids.

The "ip" metric clusters keys lifted by one column sqrt(phi - |x|^2), phi
the largest |x|^2 of each group, and gives queries a zero column: the
lifted L2 distance ranks candidates by inner product, smaller is better.

k-means++ seeding draws from an explicit ``torch.Generator``: it cannot
replay ``jax.random``, so parity with the JAX package is held by passing the
same initial centroids (``kmeans(init_centroids=...)``), or, where the
points are made inside an engine in another process, by handing that
process the JAX package's draws for the same shapes (``use_seed_draws``).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from pqcache_tpu_torch.core import quant
from pqcache_tpu_torch.ops.jhist import jhist_block_mass, jhist_block_mass_ref
from pqcache_tpu_torch.runtime.stages import scoped


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def _topk_stable(x: torch.Tensor, k: int):
    """Largest-k along the last dim with ties broken toward the lower index
    (the order ``jax.lax.top_k`` documents)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


# ---------------------------------------------------------------------------
# MIPS -> L2 lift (the "ip" metric)

def ip2l2_lift(xb: torch.Tensor, valid_len=None):
    """Lift points for inner-product search through L2 k-means.
    xb [G, N, d] -> ([G, N, d+1] f32, phi [G, 1, 1]); points at index >=
    valid_len do not count toward the per-group largest norm phi."""
    xb = xb.float()
    norms = (xb * xb).sum(-1, keepdim=True)                  # [G, N, 1]
    if valid_len is not None:
        valid = (torch.arange(xb.shape[-2], device=xb.device)
                 < int(valid_len))[None, :, None]
        norms_v = torch.where(valid, norms, 0.0)
    else:
        norms_v = norms
    phi = norms_v.amax(-2, keepdim=True)
    return torch.cat([xb, torch.sqrt(torch.clamp(phi - norms, min=0.0))],
                     -1), phi


def ip2l2_lift_with_phi(x: torch.Tensor, phi: torch.Tensor) -> torch.Tensor:
    """Lift new points with a fixed phi. x [G, M, d], phi [G, 1, 1]."""
    x = x.float()
    norms = (x * x).sum(-1, keepdim=True)
    return torch.cat([x, torch.sqrt(torch.clamp(phi - norms, min=0.0))], -1)


def lift_query(q: torch.Tensor) -> torch.Tensor:
    """A zero column appended to queries: [..., d] -> [..., d+1]."""
    return torch.cat([q, torch.zeros_like(q[..., :1])], -1)


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


# k-means++ draws given as tables instead of a torch.Generator's: None, or
# {(N, n_clusters, total groups): (permutation [N], uniforms [n_clusters - 1,
# total groups, min(N, pool)])}
_SEED_DRAWS: Optional[dict] = None


def use_seed_draws(table: Optional[dict]) -> None:
    """Seed every later k-means++ of this process from ``table`` (None: from
    the generator again). Keyed by (N, n_clusters, total groups), each entry
    holds the pool permutation and the per-step uniforms of every group; the
    JAX package's ``jax.random`` draws for the same shapes give its seeds on
    the same points. A shape missing from the table raises."""
    global _SEED_DRAWS
    _SEED_DRAWS = table


def _seed_draws(N: int, n_clusters: int, G_all: int, P: int, generator,
                device):
    """k-means++'s pool permutation [N] and an iterator of its per-step
    uniforms [G_all, P]: from ``generator`` (in that order, lazily), or
    from the table of ``use_seed_draws``."""
    if _SEED_DRAWS is None:
        perm = torch.randperm(N, generator=generator, device=device)
        return perm, (torch.rand((G_all, P), generator=generator,
                                 device=device)
                      for _ in range(n_clusters - 1))
    key = (N, n_clusters, G_all)
    if key not in _SEED_DRAWS:
        raise KeyError(f"no k-means++ draws for (N, C, groups) {key}")
    perm, u = _SEED_DRAWS[key]
    return (torch.as_tensor(perm, device=device).long(),
            iter(torch.as_tensor(u, device=device).float()))


def _kmeanspp_init(x, valid_len: int, n_clusters: int,
                   generator: torch.Generator, pool: int = 4096,
                   group_offset: int = 0, total_groups=None):
    """k-means++ (D^2 sampling) seeding over a bounded candidate pool, per
    group independent (the JAX package's algorithm, drawn from a
    torch.Generator). x [G, N, d] f32 -> centroids [G, C, d].

    A head shard holds groups [group_offset, group_offset + G) of
    ``total_groups``: each step draws the noise of every group and keeps
    its own rows, so the shard seeds what the unsharded run seeds for those
    groups."""
    G, N, d = x.shape
    G_all = G if total_groups is None else int(total_groups)
    rows = slice(int(group_offset), int(group_offset) + G)
    P = min(N, pool)
    perm, draws = _seed_draws(N, n_clusters, G_all, P, generator, x.device)
    pool_idx = perm[:P] % max(int(valid_len), 1)
    xp = x[:, pool_idx]                                      # [G, P, d]
    first = xp[:, :1]                                        # [G, 1, d]
    min_d2 = ((xp - first) ** 2).sum(-1)                     # [G, P]
    out = [first[:, 0]]
    for _ in range(n_clusters - 1):
        u = next(draws)[rows]
        gumbel = -torch.log(-torch.log(u.clamp(min=1e-12)))
        logit = torch.where(min_d2 > 0,
                            torch.log(min_d2.clamp(min=1e-30)), -torch.inf)
        pick = (logit + gumbel).argmax(-1)                   # [G]
        c = xp[torch.arange(G, device=x.device), pick]       # [G, d]
        min_d2 = torch.minimum(min_d2, ((xp - c[:, None]) ** 2).sum(-1))
        out.append(c)
    return torch.stack(out, 1)


def _kmeanspp_init_sharded(x, w, n_clusters: int, generator: torch.Generator,
                           comm, pool: int = 512):
    """k-means++ D^2 seeding over sequence-sharded points (the JAX
    package's ``_kmeanspp_init_sharded``): each shard draws a pool of its
    own positions, the pools are all-gathered (pool x d floats per group),
    and the D^2 Gumbel sampling runs replicated. The first centroid is a
    uniform pick among VALID pool entries: a left-padded prompt's first
    shard is mostly padding. ``generator`` must be seeded alike on every
    shard; the pool permutation is drawn per shard from it after a skip
    of ``comm.rank`` permutations."""
    G, N, d = x.shape
    P = min(N, pool)
    for _ in range(comm.rank):
        torch.randperm(N, generator=generator, device=x.device)
    pool_idx = torch.randperm(N, generator=generator, device=x.device)[:P]
    for _ in range(comm.size - 1 - comm.rank):
        torch.randperm(N, generator=generator, device=x.device)
    xp = comm.all_gather(x[:, pool_idx].contiguous(), dim=1)  # [G, sp*P, d]
    wp = comm.all_gather(w[:, pool_idx].contiguous(), dim=1)  # [G, sp*P]

    def gumbel():
        u = torch.rand((1, xp.shape[1]), generator=generator,
                       device=x.device)
        return -torch.log(-torch.log(u.clamp(min=1e-12)))

    pick0 = (torch.where(wp > 0, 0.0, -torch.inf) + gumbel()).argmax(-1)
    gi = torch.arange(G, device=x.device)
    first = xp[gi, pick0]                                    # [G, d]
    min_d2 = ((xp - first[:, None]) ** 2).sum(-1)
    out = [first]
    for _ in range(n_clusters - 1):
        logit = torch.where((min_d2 > 0) & (wp > 0),
                            torch.log(min_d2.clamp(min=1e-30)), -torch.inf)
        c = xp[gi, (logit + gumbel()).argmax(-1)]
        min_d2 = torch.minimum(min_d2, ((xp - c[:, None]) ** 2).sum(-1))
        out.append(c)
    return torch.stack(out, 1)


@scoped("pq_kmeans")
def kmeans(x: torch.Tensor, n_clusters: int, iters: int, *,
           seed: int = 4321, valid_len=None, chunk: int = 4096,
           init_centroids: Optional[torch.Tensor] = None,
           generator: Optional[torch.Generator] = None,
           valid_mask: Optional[torch.Tensor] = None,
           group_offset: int = 0, total_groups: Optional[int] = None,
           comm=None) -> KMeansResult:
    """Batched Lloyd k-means over G independent groups.

    x [G, N, d]; points at index >= valid_len are excluded from training,
    or, with ``valid_mask`` [G or 1, N], the points where it is false.
    Seeds by k-means++ from ``generator`` (a new one seeded with ``seed`` on
    x's device when None), or starts from ``init_centroids`` [G, C, d].
    Runs exactly ``iters`` Lloyd iterations; the e-th empty cluster (by
    cluster index) is relocated to the e-th farthest valid point (sklearn's
    strategy).

    A head shard of a larger clustering passes its first group's global
    index ``group_offset`` and ``total_groups``, and seeds what the
    unsharded run seeds for its groups. ``comm`` (``parallel.collectives.
    Comm``) runs distributed Lloyd over SEQUENCE-sharded points: x is this
    shard's points, each iteration's cluster sums and counts are
    all-reduced, so every shard holds the same centroids; an empty cluster
    moves to the globally farthest point (the shard holding the largest
    distance wins; exact ties average, which is a no-op on identical rows;
    with no valid nomination anywhere the mean update stands), and the
    seeding pools candidates from every shard."""
    G, N, d = x.shape
    x = x.float()
    valid_len = N if valid_len is None else int(valid_len)
    chunk = min(chunk, N)
    Npad = _round_up(N, chunk)
    if Npad != N:
        x = torch.nn.functional.pad(x, (0, 0, 0, Npad - N))
    if valid_mask is not None:
        w = torch.nn.functional.pad(valid_mask.float(), (0, Npad - N))
    else:
        w = (torch.arange(Npad, device=x.device) < valid_len).float()[None]
    w = w.expand(G, Npad)

    if init_centroids is not None:
        centroids = init_centroids.to(device=x.device, dtype=torch.float32)
    else:
        if generator is None:
            generator = torch.Generator(device=x.device).manual_seed(seed)
        if comm is not None:
            centroids = _kmeanspp_init_sharded(x, w, n_clusters, generator,
                                               comm)
        else:
            centroids = _kmeanspp_init(x, valid_len, n_clusters, generator,
                                       group_offset=group_offset,
                                       total_groups=total_groups)

    gidx = torch.arange(G, device=x.device)[:, None]
    for _ in range(iters):
        _, sums, counts, pdist = _assign_chunked(x, w, centroids, chunk)
        if comm is not None:
            sums, counts = comm.all_reduce(sums), comm.all_reduce(counts)
        new = sums / torch.clamp(counts, min=1.0)[..., None]
        empty = counts <= 0.0                                # [G, C]
        far_val, far_idx = _topk_stable(torch.where(w > 0, pdist, -1.0),
                                        n_clusters)          # [G, C]
        rank = torch.clamp(torch.cumsum(empty.long(), -1) - 1, 0,
                           n_clusters - 1)
        reloc = x[gidx, far_idx.gather(-1, rank)]            # [G, C, d]
        if comm is not None:
            val = far_val.gather(-1, rank)
            vmax = comm.all_reduce(val.clone(), op="max")
            win = ((val >= vmax) & (vmax >= 0.0)).float()
            n_win = comm.all_reduce(win.clone())
            reloc = (comm.all_reduce(reloc * win[..., None])
                     / torch.clamp(n_win, min=1.0)[..., None])
            empty = empty & (n_win > 0.0)
        centroids = torch.where(empty[..., None], reloc, new)
    codes, _, _, _ = _assign_chunked(x, w, centroids, chunk)
    return KMeansResult(centroids=centroids, codes=codes[:, :N])


@scoped("pq_append")
def pq_encode(x: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    """Nearest-centroid encoding. x [G, M, d], centroids [G, C, d] ->
    codes [G, M] int64."""
    x = x.float()
    dist = (centroids ** 2).sum(-1)[:, None, :] - 2.0 * torch.einsum(
        "gmd,gcd->gmc", x, centroids)
    return dist.argmin(-1)


def to_groups(x: torch.Tensor, S: int) -> torch.Tensor:
    """[H, T, D] -> [H*S, T, D/S]: each head's S subvectors as groups (H
    may be a folded B·H_kv or L·H_kv)."""
    H, T, D = x.shape
    return (x.reshape(H, T, S, D // S).transpose(1, 2)
            .reshape(H * S, T, D // S))


def encode(groups: torch.Tensor, centroids: torch.Tensor, phi, metric: str
           ) -> torch.Tensor:
    """PQ codes [G, T] (int64) of subvector groups [G, T, d] under their
    codebooks [G, C, d(+1)]; "ip" lifts the groups with phi [G, 1, 1]
    first."""
    if metric == "ip":
        groups = ip2l2_lift_with_phi(groups, phi)
    return pq_encode(groups, centroids)


class LayerCodebooks(NamedTuple):
    """``train_layer``'s result: what a layer's state takes."""
    k_sink: torch.Tensor      # [H_kv, sink, D]
    v_sink: torch.Tensor
    k_tail: torch.Tensor      # [H_kv, P - sink, D], real tokens first
    v_tail: torch.Tensor
    n_valid: int              # real tokens of the tail
    codes: torch.Tensor       # [H_kv, S, P - sink] int64
    centroids: torch.Tensor   # [H_kv, S, C, d(+1 for "ip")] f32
    phi: Optional[torch.Tensor]       # [H_kv*S, 1, 1] ("ip"), else None
    k_scale: Optional[torch.Tensor]   # [H_kv, 1, D] f32 (int8_scales)
    v_scale: Optional[torch.Tensor]


def train_layer(k: torch.Tensor, v: torch.Tensor, pad_len: int,
                true_len: int, *, sink: int, S: int, C: int, metric: str,
                iters: int, seed: int, shard=(0, 1),
                int8_scales: bool = False) -> LayerCodebooks:
    """A layer's codebooks from its K/V [H_kv, P, D] of a left-padded
    prompt: the padding rolled out (it lands after the real tokens, past
    n_valid), the sink split off, the "ip" lift, k-means seeded from
    ``seed`` over the tail's subvector groups (``shard``: this kv-head
    shard's (rank, size), so that each group seeds by its global index),
    and with ``int8_scales`` the tail's frozen per-channel int8 scales."""
    k_r = torch.roll(k, -int(pad_len), dims=1)
    v_r = torch.roll(v, -int(pad_len), dims=1)
    k_tail, v_tail = k_r[:, sink:], v_r[:, sink:]
    n_valid = int(true_len) - sink
    xb = to_groups(k_tail, S)                               # [G, P-sink, d]
    phi = None
    if metric == "ip":
        xb, phi = ip2l2_lift(xb, n_valid)
    gen = torch.Generator(device=k.device).manual_seed(seed)
    G = xb.shape[0]
    res = kmeans(xb, C, iters=iters, valid_len=n_valid, generator=gen,
                 group_offset=shard[0] * G, total_groups=shard[1] * G)
    scales = (quant.kv_channel_scales(k_tail, v_tail, n_valid)
              if int8_scales else (None, None))
    H = k.shape[0]
    return LayerCodebooks(k_r[:, :sink], v_r[:, :sink], k_tail, v_tail,
                          n_valid, res.codes.reshape(H, S, -1),
                          res.centroids.reshape(H, S, C, -1), phi, *scales)


def adc_lut(q_flat: torch.Tensor, centroids: torch.Tensor, S: int,
            metric: str) -> torch.Tensor:
    """ADC lookup table [H, S, C] of queries q_flat [H, D] (H may be a
    folded B·H) against one layer's centroids [H_kv, S, C, d(+1)]: inner
    products ("euc") or squared distances to the lifted query ("ip")."""
    q_sub = q_flat.reshape(q_flat.shape[0], S, -1)
    if metric == "ip":
        return adc_lut_ip(lift_query(q_sub), centroids)
    return adc_lut_euc(q_sub, centroids)


@scoped("pq_score")
def adc_lut_euc(q: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    """Inner-product lookup table for the "euc" metric. q [H, S, d] per
    q-head subvectors; centroids [H_kv, S, C, d], shared over the GQA group.
    Returns LUT [H, S, C] f32, LUT[h,s,c] = q[h,s] . centroids[kv(h),s,c]."""
    H, S, d = q.shape
    H_kv = centroids.shape[0]
    qg = q.float().reshape(H_kv, H // H_kv, S, d)
    return torch.einsum("hgsd,hscd->hgsc", qg, centroids.float()).reshape(
        H, S, -1)


@scoped("pq_score")
def adc_lut_ip(q_lifted: torch.Tensor, centroids: torch.Tensor
               ) -> torch.Tensor:
    """Squared-L2 lookup table of the "ip" metric. q_lifted [H, S, d+1];
    centroids [H_kv, S, C, d+1], shared over the GQA group. Returns LUT
    [H, S, C] f32, LUT[h,s,c] = |q[h,s] - centroids[kv(h),s,c]|^2."""
    H, S, d = q_lifted.shape
    H_kv = centroids.shape[0]
    qg = q_lifted.float().reshape(H_kv, H // H_kv, S, 1, d)
    diff = qg - centroids.float()[:, None]                   # [H_kv,g,S,C,d]
    return (diff * diff).sum(-1).reshape(H, S, -1)


@scoped("pq_score")
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


def jhist_applies(pq_cfg, block: int) -> bool:
    """Whether the joint-histogram scorer ranks blocks of ``block`` tokens
    under ``pq_cfg`` (a ``config.PQConfig``): scorer "auto", two subvectors
    (the histogram is of code pairs), the euclidean metric (it sums softmax
    mass) and uint8 counts (block at most 256)."""
    return (pq_cfg.scorer == "auto" and pq_cfg.n_subvec_per_head == 2
            and pq_cfg.metric == "euc" and block <= 256)


@scoped("pq_score")
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


@scoped("pq_append")
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


@scoped("pq_score")
def joint_block_mass(lut: torch.Tensor, J: torch.Tensor, *, head_dim: int,
                     normalize: bool = True, pending=None, block: int = 1,
                     kernel: bool = True) -> torch.Tensor:
    """Per-q-head block attention mass from the joint histogram.

    lut [H, 2, C] f32; J [H_kv, NB, C^2] uint8. ``pending``: the deferred
    joins the histogram lags by, (pos, codes, ring_r) at ``block``
    (``ops/jhist.jhist_block_mass``), their exact mass added. ``kernel``:
    the scorer's wrapper (the CUDA kernel on a CUDA tensor), else its plain
    version. Returns [H, NB] f32, rows summing to 1 over non-empty blocks
    (normalize=True)."""
    fn = jhist_block_mass if kernel else jhist_block_mass_ref
    mass = fn(jhist_exp_lut(lut, head_dim), J, pending, block=block)
    if not normalize:
        return mass
    return mass / torch.clamp(mass.sum(-1, keepdim=True), min=1e-30)


# ---------------------------------------------------------------------------
# GQA-reduced selection from per-token ADC scores: "euc" ranks by softmax
# attention mass summed over the group (larger is better), "ip" by lifted
# L2 distance summed over the group (smaller is better)

def _check_metric(metric: str) -> None:
    if metric not in ("euc", "ip"):
        raise ValueError(f"unknown metric {metric}")


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


@scoped("pq_select")
def group_scores(scores: torch.Tensor, n_valid, *, group: int, head_dim: int,
                 metric: str = "euc") -> torch.Tensor:
    """GQA-reduced per-kv-head candidate importances: euc, the softmax
    attention mass summed over each group; ip, the negated summed distance.
    scores [H, T]; n_valid scalar or [H_kv]. Returns [H_kv, T] with invalid
    candidates at -inf."""
    _check_metric(metric)
    if metric == "ip":
        H, T = scores.shape
        valid_kv, _ = _valid_masks(n_valid, H // group, group, T,
                                   scores.device)
        g = -scores.float().reshape(H // group, group, T).sum(1)
    else:
        g, valid_kv = _group_mass(scores, n_valid, group, head_dim)
    return torch.where(valid_kv, g, -torch.inf)


@scoped("pq_select")
def mips_topk(scores: torch.Tensor, n_valid, k: int, *, group: int,
              head_dim: int, metric: str = "euc"):
    """GQA-reduced per-token top-k (ties to the lower index). euc:
    softmax(scores / sqrt(head_dim)) per q head, summed over each group,
    largest k; ip: the distances summed over each group, smallest k.
    scores [H, T] raw ADC scores; positions >= n_valid (scalar or [H_kv])
    are padding. Returns (topk_idx [H_kv, k] int64, group mass or summed
    distance [H_kv, T])."""
    _check_metric(metric)
    if metric == "ip":
        H, T = scores.shape
        valid_kv, _ = _valid_masks(n_valid, H // group, group, T,
                                   scores.device)
        g = scores.float().reshape(H // group, group, T).sum(1)
        return _topk_stable(torch.where(valid_kv, -g, -torch.inf), k)[1], g
    g, valid_kv = _group_mass(scores, n_valid, group, head_dim)
    return _topk_stable(torch.where(valid_kv, g, -torch.inf), k)[1], g


@scoped("pq_select")
def mips_topk_blocks(scores: torch.Tensor, n_valid, k_tokens: int, *,
                     group: int, head_dim: int, block: int,
                     metric: str = "euc"):
    """Block-granular selection: rank blocks of ``block`` candidates by
    their total GQA-reduced attention mass (euc) or by the mean negated
    summed distance over their valid candidates (ip: a sum would favour
    partly valid boundary blocks), and take ceil(k_tokens / block) of those
    starting below n_valid. Returns (block_idx [H_kv, k_blocks] int64,
    group mass or summed distance [H_kv, T])."""
    _check_metric(metric)
    H, T = scores.shape
    if T % block:
        raise ValueError(f"T={T} must be a multiple of block={block}")
    H_kv = H // group
    if metric == "ip":
        valid_kv, _ = _valid_masks(n_valid, H_kv, group, T, scores.device)
        g = scores.float().reshape(H_kv, group, T).sum(1)
        gv = torch.where(valid_kv, -g, 0.0)
        cnt = valid_kv.float().expand(H_kv, T).reshape(
            H_kv, T // block, block).sum(-1)
        blk = (gv.reshape(H_kv, T // block, block).sum(-1)
               / torch.clamp(cnt, min=1.0))
    else:
        g, _ = _group_mass(scores, n_valid, group, head_dim)
        blk = g.reshape(H_kv, T // block, block).sum(-1)
    return topk_from_block_mass(blk, n_valid, k_tokens, group=1,
                                block=block), g


@scoped("pq_select")
def topk_from_block_mass(blk_mass: torch.Tensor, n_valid, k_tokens: int, *,
                         group: int, block: int) -> torch.Tensor:
    """Block selection from per-q-head block mass: group-sum [H -> H_kv],
    mask blocks past n_valid, exact top-ceil(k_tokens / block).

    blk_mass [H, NB]; n_valid int or [H_kv]. Returns [H_kv, k_blocks] int64."""
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
