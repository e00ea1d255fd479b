"""W8: the weight-only int8 matrix product (x @ W8) * s.

In the JAX package ``pqcache_tpu/models/llama.py::_mm`` (:69) and
``lm_head_logits`` (:90) write ``x @ w.astype(bf16)`` and leave it to XLA to
convert the int8 operand inside the dot, so the weights are read once, as
int8. That fusion was XLA's, not a Pallas kernel; here it is the CUDA kernel
``csrc/w8_matmul.cu``, for decode rows (M <= MAX_ROWS). One launch computes
a group of up to MAX_GROUP products that share x (``w8_matmul_group``: the
decode step's q/k/v and gate/up); ``w8_matmul`` is the group of one (wo,
down, the LM head). Its plain version ``w8_matmul_ref`` is the JAX lines
themselves in torch: the product rounded to the activations' dtype, then
scaled in that dtype for a layer, in f32 for the LM head;
``w8_matmul_group_ref`` is that of each product.

``plan_group`` gives a launch's geometry and ``units`` the table of work
each CTA walks (stream-K: equal ranges of (tile, k block) units); the
kernel computes the same cut from the plan's numbers. On a CPU tensor the
wrappers compute the plain version; on a CUDA tensor they launch the kernel
or raise. Rows past MAX_ROWS (prefill) are bound by
operations, not bytes: ``models/llama.py::_mm`` sends them to
``w8_dequant_matmul``, which dequantizes the one matrix to a bf16 copy and
calls ``torch.matmul``, as the JAX package leaves the large product to XLA.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import torch

from pqcache_tpu_torch.ops import _build

MAX_ROWS = 64          # the kernel's rows: decode (the Engine 1, bench.py B)
MAX_GROUP = 3          # products of one launch (q/k/v)
# csrc/w8_matmul.cu: a unit of the walk is a k block of BLOCK_ROWS rows of a
# tile of TILE_COLS columns; the scratch holds two partials per CTA (f32,
# TILE_COLS columns by at most 64 rows) and one arrival count per tile
TILE_COLS = 256
BLOCK_ROWS = 64
MAX_TILES = 8192
# the least share of the SMs a tile-aligned grid may use (plan_group)
ALIGNED_SHARE = 0.84


def w8_matmul_ref(x: torch.Tensor, w: torch.Tensor, s: torch.Tensor, *,
                  lm_head: bool = False) -> torch.Tensor:
    """Plain version: x [..., K] @ w [K, N] int8, scaled by s [1, N]
    ([N] taken too). A layer: (x @ w.to(x.dtype)) * s in x.dtype; the LM
    head: the product widened to f32, times s in f32."""
    y = x @ w.to(x.dtype)
    if lm_head:
        return y.float() * s.float().reshape(-1)
    return y * s.to(x.dtype).reshape(-1)


def w8_matmul_group_ref(x: torch.Tensor, prods, *,
                        lm_head: bool = False) -> list:
    """Plain version of a group: ``w8_matmul_ref`` of each (w, s) in
    ``prods``, in order."""
    return [w8_matmul_ref(x, w, s, lm_head=lm_head) for w, s in prods]


class GroupPlan(NamedTuple):
    """One launch of a group (csrc/w8_matmul.cu): ``mt`` tiles of 8 rows
    cover M; each product p has ``tiles[p]`` column tiles of TILE_COLS
    columns; a tile has ``ipt`` k blocks of BLOCK_ROWS rows; the ``units``
    (tile, k block) pairs, product after product, tile after tile, k block
    after k block, are cut into ``grid`` contiguous ranges, one per CTA."""
    mt: int
    tiles: tuple
    ipt: int
    units: int
    grid: int


@functools.lru_cache(maxsize=None)
def plan_group(M: int, Ns: tuple, K: int, sms: int) -> GroupPlan:
    """The launch of a group of products [K, N] for N in ``Ns`` at M rows on
    a card of ``sms`` SMs: at most one CTA per SM and never more CTAs than
    units. Where a grid of at least ALIGNED_SHARE of the SMs cuts the units
    into equal ranges that each lie in one tile or cover whole tiles, the
    largest such grid: every CTA then ends one segment at a time and a cut
    tile has equal parts (on an H100, Llama-3.1-8B's wo and down take 12 and
    27 us on 128 CTAs against 14 and 33 on 132, PERF.md)."""
    if not 1 <= len(Ns) <= MAX_GROUP:
        raise ValueError(f"w8_matmul_group: 1 to {MAX_GROUP} products, got "
                         f"{len(Ns)}")
    if any(n < 4 or n % 4 for n in Ns):
        raise ValueError(f"w8_matmul: N {Ns} and the weights' address must "
                         f"be multiples of 4 bytes")
    if K < 16 or K % 16:
        raise ValueError(f"w8_matmul: K {K} must be a multiple of 16")
    if not 1 <= M <= MAX_ROWS:
        raise ValueError(f"w8_matmul: {M} rows; the kernel takes 1 to "
                         f"{MAX_ROWS} (prefill rows go to w8_dequant_matmul)")
    mt = next(m for m in (1, 2, 4, 8) if M <= 8 * m)
    tiles = tuple(-(-n // TILE_COLS) for n in Ns)
    if sum(tiles) > MAX_TILES:
        raise ValueError(f"w8_matmul: {sum(tiles)} column tiles, at most "
                         f"{MAX_TILES}")
    ipt = -(-K // BLOCK_ROWS)
    units = sum(tiles) * ipt
    grid = min(sms, units)
    for g in range(grid, max(1, math.ceil(ALIGNED_SHARE * grid)) - 1, -1):
        per = units // g
        if units % g == 0 and (ipt % per == 0 or per % ipt == 0):
            grid = g
            break
    return GroupPlan(mt, tiles, ipt, units, grid)


def _range(plan: GroupPlan, c: int) -> tuple:
    """The units [lo, hi) of CTA c (the kernel's range_lo)."""
    return (c * plan.units // plan.grid, (c + 1) * plan.units // plan.grid)


def units(plan: GroupPlan) -> list:
    """The table the kernel walks: for each CTA, its segments in order, one
    per tile it touches, as (product, tile of the product, first k block,
    end k block, CTAs). CTAs: those that hold the tile's k blocks, in k
    order. One: it writes y; more: each leaves its partial sum, and the last
    of them to arrive adds the partials in this order and writes y."""
    first = [sum(plan.tiles[:p]) for p in range(len(plan.tiles))]
    table = []
    for c in range(plan.grid):
        lo, hi = _range(plan, c)
        segs, i = [], lo
        while i < hi:
            tile, kb = divmod(i, plan.ipt)
            end = min(hi, (tile + 1) * plan.ipt)
            p = max(q for q in range(len(first)) if first[q] <= tile)
            c0 = ((tile * plan.ipt + 1) * plan.grid - 1) // plan.units
            c1 = ((tile + 1) * plan.ipt * plan.grid - 1) // plan.units
            segs.append((p, tile - first[p], kb, end - tile * plan.ipt,
                         tuple(range(c0, c1 + 1))))
            i = end
        table.append(segs)
    return table


@functools.lru_cache(maxsize=None)
def _sms(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


_scratch: dict = {}


def _scratch_of(device) -> tuple:
    """(partials, arrival counts) of the split-K fix-up for the current
    stream of ``device``, allocated at that stream's first call (outside a
    CUDA-graph capture) at the largest plan (one CTA per SM, MAX_TILES
    tiles); each launch leaves the counts at zero. Launches on one stream
    run one after another; two streams each have their own, so their
    launches may overlap. A graph replays with the scratch of the stream it
    was captured on."""
    dev = torch.device(device)
    key = (dev, torch.cuda.current_stream(dev).cuda_stream)
    if key not in _scratch:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("w8_matmul: first call on this stream inside "
                               "a CUDA-graph capture; call it once eagerly "
                               "on the capture stream first")
        sms = _sms(dev)
        _scratch[key] = (
            torch.empty(2 * sms * TILE_COLS * 64,
                        dtype=torch.float32, device=dev),
            torch.zeros(MAX_TILES, dtype=torch.int32, device=dev))
    return _scratch[key]


def _check(x, prods, M: int) -> int:
    """Raise on what the kernel does not take (CUDA tensors only); K."""
    K = x.shape[-1]
    for w, s in prods:
        if x.device.type != "cuda" or w.device != x.device \
                or s.device != x.device:
            raise ValueError(f"w8_matmul: x on {x.device}, w on {w.device}, "
                             f"s on {s.device}; the kernel takes all on one "
                             f"CUDA device")
        if x.dtype != torch.bfloat16 or w.dtype != torch.int8 \
                or s.dtype != torch.bfloat16:
            raise TypeError(f"w8_matmul kernel takes bf16 x and s and int8 "
                            f"w, got {x.dtype}, {w.dtype}, {s.dtype}")
        if w.dim() != 2 or w.shape[0] != K or s.numel() != w.shape[1]:
            raise ValueError(f"w8_matmul: x {tuple(x.shape)}, w "
                             f"{tuple(w.shape)}, s {tuple(s.shape)} do not "
                             f"fit")
        if w.data_ptr() % 4:
            raise ValueError("w8_matmul: N and the weights' address must be "
                             "multiples of 4 bytes")
        if not (w.is_contiguous() and s.is_contiguous()):
            raise ValueError("w8_matmul: w and s must be contiguous (a copy "
                             "of the weights would cost more than the "
                             "product)")
    if not 1 <= M <= MAX_ROWS:
        raise ValueError(f"w8_matmul: {M} rows; the kernel takes 1 to "
                         f"{MAX_ROWS} (prefill rows go to w8_dequant_matmul)")
    return K


def w8_matmul_group(x: torch.Tensor, prods, *,
                    lm_head: bool = False) -> list:
    """[x @ w * s for (w, s) in prods]: 1 to 3 int8 weights [K, N_p] that
    share x [..., K], each scaled by its s [1, N_p] -> [..., N_p], in ONE
    launch of the W8 kernel (q/k/v, gate/up). On the CPU the plain version;
    on the card x holds at most MAX_ROWS rows and x, s are bf16."""
    if x.device.type == "cpu":
        return w8_matmul_group_ref(x, prods, lm_head=lm_head)
    prods = list(prods)
    M = x.numel() // max(x.shape[-1], 1)
    K = _check(x, prods, M)
    x2 = x.reshape(M, K).contiguous()
    if x2.data_ptr() % 16:
        x2 = x2.clone()
    Ns = tuple(w.shape[1] for w, _ in prods)
    plan = plan_group(M, Ns, K, _sms(x.device))
    part, counts = _scratch_of(x.device)
    outs = [torch.empty((M, n), device=x.device,
                        dtype=torch.float32 if lm_head else torch.bfloat16)
            for n in Ns]
    pad = MAX_GROUP - len(prods)
    ptr = lambda ts: [t.data_ptr() for t in ts] + [None] * pad  # noqa: E731
    _build.check(_build.lib("w8_matmul").pq_w8_group(
        x2.data_ptr(), *ptr([w for w, _ in prods]),
        *ptr([s for _, s in prods]),
        *ptr(outs), *(list(Ns) + [0] * pad), len(prods), M, K, plan.grid,
        int(lm_head), part.data_ptr(), counts.data_ptr(),
        _build.stream_ptr(x.device)), "w8_matmul")
    w8_matmul.launches += 1
    return [y.reshape(*x.shape[:-1], n) for y, n in zip(outs, Ns)]


def w8_matmul(x: torch.Tensor, w: torch.Tensor, s: torch.Tensor, *,
              lm_head: bool = False) -> torch.Tensor:
    """x [..., K] @ w [K, N] int8, scaled by s [1, N] per column -> [..., N]:
    bf16 for a layer, f32 with ``lm_head``; the group of one. On the card x
    holds at most MAX_ROWS rows and x, s are bf16. ``w8_matmul.launches``
    counts the kernel's launches from both entry points."""
    if x.device.type == "cpu":
        return w8_matmul_ref(x, w, s, lm_head=lm_head)
    return w8_matmul_group(x, [(w, s)], lm_head=lm_head)[0]


w8_matmul.launches = 0


def w8_dequant_matmul(x: torch.Tensor, w: torch.Tensor, s: torch.Tensor, *,
                      lm_head: bool = False) -> torch.Tensor:
    """The route of prefill rows (more than MAX_ROWS) on the card: the
    matrix dequantized to a bf16 copy, one torch.matmul, then the scale:
    the plain version, counted apart from the kernel's launches. Bound by
    operations at these rows, so the copy's bytes cost little."""
    w8_dequant_matmul.launches += 1
    return w8_matmul_ref(x, w, s, lm_head=lm_head)


w8_dequant_matmul.launches = 0
