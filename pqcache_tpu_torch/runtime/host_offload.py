"""Host-offload tier: a block-granular KV store in pinned host memory, a
device-resident block cache, and the native LFU that decides residency.

Counterpart of ``pqcache_tpu/runtime/host_offload.py`` (``HostKVStore``,
``assemble_blocks``), after the reference's memory hierarchy
(cache_manager.py): per-layer pinned CPU key/value buffers (:89-100), a
block-granular GPU cache (:119-120) with C++ LFU admission (:364-380),
per-block hit/miss classification (:250-271) and staging on a side stream
(:339-362).

On the card the tier is DMA over PCIe from pinned memory. The JAX
package's TPU workarounds are gone: one pinned leaf per (layer, block),
miss stacks padded to power-of-four buckets and the packed selection pull.
What stays is what a caller can observe: the proxy array the LFU writes,
hits before misses in each LFU batch, the ``cache_topk`` admission cap, the
hit/miss counts and the assembled blocks.

Layout. One host tensor per layer, ``[max_blocks, H_kv, bs, 2D]`` with K
and V interleaved per row (one copy fetches both), allocated once per store
with ``pin_memory=True`` on ``cuda``; a store that cannot pin raises, and
so does one whose LFU is not the native library. A CPU store holds plain
host tensors, copies in order and takes the LFU's Python model when the
library cannot build (the tests run so).

Streams (cuda). Device -> host writes (the prefill's candidate rows, each
filled tail block) and host -> device staging of misses run on the store's
copy stream, each after an event of the compute stream, so a block written
to the host is staged only after its write. The compute stream waits on
the staging copy's event, never on a host sync. A copy's device source is
kept alive with ``record_stream``; a staged stack is allocated on the copy
stream and handed to the compute stream the same way. Misses are staged
with one ``copy_`` per run of consecutive block ids straight from the
pinned store (no host-side gather into a staging buffer).

Admission is deferred. ``classify_blocks`` stages the misses and returns
the LIVE cache; the caller assembles its blocks (``assemble_blocks``) and
then calls ``admit(layer)``, which writes the admitted misses into the
cache. The JAX package gets the same effect from a functional update that
keeps the pre-admission array: within one LFU batch a new block may evict
a block that is a hit of the same batch, so the assembly must read the
cache before the admission overwrites that slot.
"""

from __future__ import annotations

import threading
import time
from typing import Optional, Tuple

import numpy as np
import torch

from pqcache_tpu_torch import resolve_device
from pqcache_tpu_torch.native import lfu_cache
from pqcache_tpu_torch.native.lfu_cache import LFUCache

PREFILL_CHUNK_BLOCKS = 64   # blocks interleaved and written per D2H copy
# host index arrays go to the device through a ring of pinned slots
INDEX_RING = 256            # slots
INDEX_SLOT = 8192           # int64 entries a slot holds
EVENT_FOLD = 64             # timing events kept before finished ones fold


def assemble_blocks(cache: torch.Tensor, staged: torch.Tensor,
                    slots: torch.Tensor, miss_pos: torch.Tensor
                    ) -> torch.Tensor:
    """Block assembly on the device: hits from the block cache, misses from
    the staged stack.

    cache [n_slots, H_kv, bs, 2D]; staged [M, H_kv, bs, 2D]; slots and
    miss_pos [Hr, kb] int (slot < 0: use staged[miss_pos]). Hr is H_kv, or
    B·H_kv for batch-as-heads callers: head rows are addressed modulo
    H_kv. Returns [Hr, kb, bs, 2D]."""
    Hr = slots.shape[0]
    H_kv = cache.shape[1]
    heads = (torch.arange(Hr, device=slots.device) % H_kv)[:, None]
    from_cache = cache[slots.clamp(min=0), heads]
    from_stage = staged[miss_pos.clamp(min=0), heads]
    return torch.where((slots >= 0)[..., None, None], from_cache, from_stage)


def _runs(ids: np.ndarray):
    """(position, first id, length) of each run of consecutive ids in the
    sorted array ``ids``."""
    cut = np.flatnonzero(np.diff(ids) != 1) + 1
    starts = np.concatenate([[0], cut])
    ends = np.concatenate([cut, [len(ids)]])
    return [(int(s), int(ids[s]), int(e - s)) for s, e in zip(starts, ends)]


class HostKVStore:
    """Per-layer pinned host KV blocks, a device block cache per layer, a
    native LFU per layer over it.

    capacity: tokens per layer (``max_blocks`` = its blocks); dtype: the
    stored rows' dtype (the engine's, or int8); device: cuda unless given."""

    def __init__(self, layers: int, n_kv_heads: int, capacity: int,
                 head_dim: int, *, block_size: int = 128,
                 hbm_cache_tokens: int = 4096, cache_topk_blocks: int = 32,
                 dtype=torch.bfloat16, device=None):
        self.device = resolve_device(device)
        self.L, self.H_kv, self.N, self.D = (layers, n_kv_heads, capacity,
                                             head_dim)
        self.block = block_size
        self.n_cache_blocks = max(hbm_cache_tokens // block_size, 1)
        self.cache_topk = cache_topk_blocks
        self.max_blocks = (capacity + block_size - 1) // block_size
        self.dtype = dtype
        self.cuda = self.device.type == "cuda"
        row = (n_kv_heads, block_size, 2 * head_dim)

        t0 = time.perf_counter()
        self.host_kv = [torch.empty((self.max_blocks,) + row, dtype=dtype,
                                    pin_memory=self.cuda)
                        for _ in range(layers)]
        if self.cuda and not all(h.is_pinned() for h in self.host_kv):
            raise RuntimeError("HostKVStore: the host store is not pinned; "
                               "a copy from pageable memory would "
                               "synchronize")
        self.alloc_seconds = time.perf_counter() - t0
        self.pinned_bytes = (sum(h.numel() * h.element_size()
                                 for h in self.host_kv) if self.cuda else 0)
        # which block ids hold rows (cleared by invalidate_blocks)
        self.stored = np.zeros((layers, self.max_blocks), bool)
        self.valid = np.zeros((layers,), np.int64)    # complete-block tokens
        # the growing tail block, on the device
        self.tail = [torch.zeros(row, dtype=dtype, device=self.device)
                     for _ in range(layers)]
        self.tail_fill = np.zeros((layers,), np.int64)
        # the device block cache and the LFU's proxy: block id -> cache
        # slot, a host array the native LFU writes in place
        self.cache_kv = [torch.zeros((self.n_cache_blocks,) + row,
                                     dtype=dtype, device=self.device)
                         for _ in range(layers)]
        self.block_slot = np.full((layers, self.max_blocks), -1, np.int32)
        self.lfu = [LFUCache(self.n_cache_blocks) for _ in range(layers)]
        if self.cuda and not all(c.native for c in self.lfu):
            raise RuntimeError(f"HostKVStore: the native LFU did not build "
                               f"({lfu_cache.build_error}); the Python "
                               f"model is for CPU stores only")
        self._locks = [threading.Lock() for _ in range(layers)]
        self._pending: list = [None] * layers      # deferred admissions
        self._no_miss = torch.zeros((1,) + row, dtype=dtype,
                                    device=self.device)
        self.hits = 0
        self.misses = 0
        self.copy_stream = (torch.cuda.Stream(self.device) if self.cuda
                            else None)
        self._d2h_done: list = [None] * layers     # last D2H event a layer
        self._ring = (torch.empty((INDEX_RING, INDEX_SLOT), dtype=torch.int64,
                                  pin_memory=True) if self.cuda else None)
        self._ring_ev: list = [None] * INDEX_RING
        self._ring_i = 0
        # transfers: bytes and copies issued; (start, end) events of each
        # staging or write not yet folded into the device seconds
        self.h2d_bytes = self.h2d_copies = 0
        self.d2h_bytes = self.d2h_copies = 0
        self.h2d_s = self.d2h_s = 0.0
        self._h2d_ev: list = []
        self._d2h_ev: list = []

    # -- transfers -------------------------------------------------------

    def device_index(self, a: np.ndarray) -> torch.Tensor:
        """Host int array -> int64 index tensor on the device. On cuda it is
        copied without a host sync from a slot of a ring of pinned buffers,
        which is written again only once the copy out of it has run (a
        fresh pinned buffer per copy would make the host wait whenever
        the card runs far behind it, as it does under an admission)."""
        t = torch.from_numpy(np.ascontiguousarray(a, np.int64))
        if not self.cuda:
            return t
        n = t.numel()
        if n > INDEX_SLOT:
            return t.pin_memory().to(self.device, non_blocking=True)
        i = self._ring_i
        self._ring_i = (i + 1) % INDEX_RING
        if self._ring_ev[i] is not None:
            self._ring_ev[i].synchronize()
        host = self._ring[i, :n]
        host.copy_(t.reshape(-1))
        out = host.to(self.device, non_blocking=True)
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(self.device))
        self._ring_ev[i] = ev
        return out.reshape(t.shape)

    def _write_host(self, layer: int, b0: int, blocks: torch.Tensor) -> None:
        """blocks [n, H_kv, bs, 2D] (device, store dtype) -> host block ids
        [b0, b0 + n)."""
        n = blocks.shape[0]
        self.stored[layer, b0:b0 + n] = True
        nbytes = blocks.numel() * blocks.element_size()
        self.d2h_bytes += nbytes
        self.d2h_copies += 1
        dst = self.host_kv[layer][b0:b0 + n]
        if not self.cuda:
            dst.copy_(blocks)
            return
        cs = self.copy_stream
        cs.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(cs):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record(cs)
            dst.copy_(blocks, non_blocking=True)
            end.record(cs)
        blocks.record_stream(cs)
        self._d2h_ev.append((start, end))
        self._d2h_done[layer] = end
        if len(self._d2h_ev) > EVENT_FOLD:
            self._fold()

    def _stage(self, layer: int, miss_blocks: np.ndarray) -> torch.Tensor:
        """The miss blocks' rows [M, H_kv, bs, 2D] on the device, copied
        from the pinned store on the copy stream; the compute stream waits
        for the copies' event."""
        host = self.host_kv[layer]
        M = len(miss_blocks)
        nbytes = M * host[0].numel() * host.element_size()
        self.h2d_bytes += nbytes
        if not self.cuda:
            self.h2d_copies += 1
            return host[torch.from_numpy(miss_blocks.astype(np.int64))]
        cs = self.copy_stream
        cur = torch.cuda.current_stream(self.device)
        with torch.cuda.stream(cs):
            staged = torch.empty((M,) + tuple(host.shape[1:]),
                                 dtype=host.dtype, device=self.device)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record(cs)
            for pos, b0, n in _runs(miss_blocks):
                staged[pos:pos + n].copy_(host[b0:b0 + n], non_blocking=True)
                self.h2d_copies += 1
            end.record(cs)
        cur.wait_event(end)
        staged.record_stream(cur)
        self._h2d_ev.append((start, end))
        if len(self._h2d_ev) > EVENT_FOLD:
            self._fold()
        return staged

    def _fold(self) -> None:
        """Add the device time of each finished copy to h2d_s / d2h_s and
        drop its events. The copy stream runs them in order, so the
        finished ones lead each list."""
        for key, evs in (("h2d_s", self._h2d_ev), ("d2h_s", self._d2h_ev)):
            n = 0
            while n < len(evs) and evs[n][1].query():
                n += 1
            setattr(self, key, getattr(self, key) + sum(
                a.elapsed_time(b) for a, b in evs[:n]) / 1e3)
            del evs[:n]

    def transfer_stats(self) -> dict:
        """Bytes, copies and device seconds of the staging (H2D) and the
        writes (D2H) so far, from the copy stream's events (waits for
        them); seconds are None on the CPU."""
        out = dict(h2d_bytes=self.h2d_bytes, h2d_copies=self.h2d_copies,
                   d2h_bytes=self.d2h_bytes, d2h_copies=self.d2h_copies,
                   h2d_s=None, d2h_s=None, pinned_bytes=self.pinned_bytes,
                   alloc_s=self.alloc_seconds)
        if self.cuda:
            self.copy_stream.synchronize()
            self._fold()
            out.update(h2d_s=self.h2d_s, d2h_s=self.d2h_s)
        return out

    def sync_transfers(self, layer: int) -> None:
        """Bound the prefill's writes in flight to about one layer: wait
        until the previous layer's writes are done (layer 0: nothing)."""
        ev = self._d2h_done[layer - 1] if layer > 0 else None
        if ev is not None:
            ev.synchronize()

    # -- writes -----------------------------------------------------------

    def offload_blocks_device(self, layer: int, k: torch.Tensor,
                              v: torch.Tensor, n_tokens: int, off: int, *,
                              id_base: int = 0) -> Optional[torch.Tensor]:
        """Complete-block offload of the device rows [off, off + n_tokens)
        of k/v [H_kv, P, D] to host block ids id_base + i, interleaved K‖V
        one chunk of PREFILL_CHUNK_BLOCKS blocks at a time (no full-length
        interleaved copy). Returns the remainder rows [H_kv, rem, 2D] on the
        device, or None when n_tokens is block-aligned: the caller owns the
        tail (this store's tail, or a batched engine's per-slot tails)."""
        bs = self.block
        n_full = n_tokens // bs
        H, D2 = self.H_kv, 2 * self.D
        for c0 in range(0, n_full, PREFILL_CHUNK_BLOCKS):
            n = min(PREFILL_CHUNK_BLOCKS, n_full - c0)
            r0 = off + c0 * bs
            kv = torch.cat([k[:, r0:r0 + n * bs], v[:, r0:r0 + n * bs]],
                           -1).to(self.dtype)
            self._write_host(layer, id_base + c0, kv.reshape(
                H, n, bs, D2).transpose(0, 1).contiguous())
        rem = n_tokens - n_full * bs
        if not rem:
            return None
        r0 = off + n_full * bs
        return torch.cat([k[:, r0:r0 + rem], v[:, r0:r0 + rem]],
                         -1).to(self.dtype)

    def offload_layer_device(self, layer: int, k: torch.Tensor,
                             v: torch.Tensor, n_tokens: int,
                             off: int = 0) -> None:
        """A layer's prefill rows [off, off + n_tokens) of the device k/v
        [H_kv, P, D] (off = pad + sink for a left-padded prompt): complete
        blocks to the host, the remainder seeds the device tail."""
        start = int(self.valid[layer]) // self.block
        part = self.offload_blocks_device(layer, k, v, n_tokens, off,
                                          id_base=start)
        self.valid[layer] = (start + n_tokens // self.block) * self.block
        if part is not None:
            self.tail[layer] = torch.zeros_like(self.tail[layer])
            self.tail[layer][:, :part.shape[1]] = part
            self.tail_fill[layer] = part.shape[1]

    def offload_layer(self, layer: int, k: np.ndarray, v: np.ndarray,
                      start: int = 0) -> None:
        """NumPy convenience (tests): rows k/v [H_kv, T, D] from token 0, or
        appended at the current end."""
        if not (start == 0
                or start == self.valid[layer] + self.tail_fill[layer]):
            raise ValueError(f"offload at {start}: the layer ends at "
                             f"{self.valid[layer] + self.tail_fill[layer]}")
        kt = torch.from_numpy(np.asarray(k, np.float32)).to(
            device=self.device, dtype=self.dtype)
        vt = torch.from_numpy(np.asarray(v, np.float32)).to(
            device=self.device, dtype=self.dtype)
        if start == 0:
            self.valid[layer] = 0
            self.tail_fill[layer] = 0
            self.stored[layer] = False
        self.offload_layer_device(layer, kt, vt, kt.shape[1])

    def _flush_tail(self, layer: int) -> None:
        b = int(self.valid[layer]) // self.block
        self._write_host(layer, b, self.tail[layer][None])
        self.valid[layer] += self.block
        self.tail_fill[layer] = 0
        self.tail[layer] = torch.zeros_like(self.tail[layer])

    def append_row_device(self, layer: int, row: torch.Tensor) -> None:
        """Sequential append of one token row [H_kv, 2D] (device): lands in
        the device tail; a filled tail goes to the host as one block."""
        fill = int(self.tail_fill[layer])
        self.tail[layer][:, fill] = row.to(self.dtype)
        self.tail_fill[layer] = fill + 1
        if self.tail_fill[layer] == self.block:
            self._flush_tail(layer)

    def adopt_block_device(self, layer: int, kv_block: torch.Tensor,
                           block_id: Optional[int] = None) -> None:
        """A complete block [H_kv, bs, 2D] built on the device becomes host
        block ``block_id`` (the next one, advancing ``valid``, when None;
        batch-as-heads callers pass slot-prefixed ids and track their own
        extents)."""
        if block_id is None:
            if self.tail_fill[layer]:
                raise ValueError("adopt_block_device with a partial tail")
            block_id = int(self.valid[layer]) // self.block
            self.valid[layer] += self.block
        self._write_host(layer, int(block_id),
                         kv_block.to(self.dtype)[None])

    def append_token(self, layer: int, pos: int, k: np.ndarray,
                     v: np.ndarray) -> None:
        """Positioned single-row write of k, v [H_kv, D]. pos at the end
        appends; inside the tail it overwrites there; inside a stored block
        (rare) it rewrites the host row, after the copy stream drains, and
        refreshes the block's cached copy."""
        row = torch.from_numpy(np.concatenate(
            [np.asarray(k, np.float32), np.asarray(v, np.float32)],
            -1)).to(device=self.device, dtype=self.dtype)     # [H_kv, 2D]
        total = int(self.valid[layer] + self.tail_fill[layer])
        if pos == total:
            self.append_row_device(layer, row)
            return
        if pos > total:
            raise ValueError(f"append at {pos} beyond tail {total}")
        valid = int(self.valid[layer])
        if pos >= valid:
            self.tail[layer][:, pos - valid] = row
            return
        b, off = divmod(pos, self.block)
        if self.cuda:
            self.copy_stream.synchronize()
        self.host_kv[layer][b, :, off] = row.cpu()
        with self._locks[layer]:
            self.admit(layer)
            self.lfu[layer].synchronize()
            slot = int(self.block_slot[layer][b])
            if slot >= 0:
                self.cache_kv[layer][slot, :, off] = row

    def invalidate_blocks(self, block_ids) -> None:
        """Drop block ids from every layer: LFU entries erased (their cache
        slots recycle to later admissions), proxy entries -1, rows marked
        absent. A batched engine retires a serving slot so before its id
        range is reused: a newcomer's ids must not hit stale cache rows."""
        ids = np.ascontiguousarray(np.asarray(block_ids, np.int32).ravel())
        for layer in range(self.L):
            with self._locks[layer]:
                self.admit(layer)
                lfu = self.lfu[layer]
                lfu.synchronize()
                lfu.batched_erase(ids, self.block_slot[layer])
                ok = ids[(ids >= 0) & (ids < self.max_blocks)]
                self.stored[layer, ok] = False

    # -- fetch path -------------------------------------------------------

    def admit(self, layer: int) -> None:
        """Write the last classify's admitted misses into the cache: call it
        after the blocks of that classify are assembled."""
        pending, self._pending[layer] = self._pending[layer], None
        if pending is None:
            return
        slots, pos, staged = pending
        self.cache_kv[layer].index_copy_(
            0, self.device_index(slots),
            staged.index_select(0, self.device_index(pos)))

    def classify_blocks(self, layer: int, blk_idx: np.ndarray,
                        ok: Optional[np.ndarray] = None,
                        ) -> Tuple[np.ndarray, np.ndarray, torch.Tensor,
                                   torch.Tensor]:
        """Hit/miss split and miss staging for a per-head block selection.

        blk_idx [H_kv, kb] int block ids (ids past the complete blocks are
        invalid: slot -1, miss_pos -1, and the caller masks them);
        batch-as-heads callers pass global (slot-prefixed) ids [B·H_kv, kb]
        with an explicit ``ok`` mask. Returns (slots, miss_pos [H_kv, kb]
        int32, staged [M, H_kv, bs, 2D], cache): slot >= 0 means the block
        is in ``cache`` at that slot, else staged[miss_pos] holds it. The
        LFU's batch (hits first, then at most cache_topk of the most
        requested blocks) runs on its worker thread while the misses are
        staged; their admission waits for ``admit(layer)``."""
        blk_idx = np.asarray(blk_idx)
        if ok is None:
            ok = blk_idx < int(self.valid[layer]) // self.block
        else:
            ok = np.asarray(ok, bool)
        with self._locks[layer]:
            self.admit(layer)
            proxy = self.block_slot[layer]
            clipped = np.clip(blk_idx, 0, self.max_blocks - 1)
            slots = np.where(ok, proxy[clipped], -1)
            hit = slots >= 0
            self.hits += int(hit.sum())
            self.misses += int((ok & ~hit).sum())
            miss_blocks = np.unique(blk_idx[ok & ~hit])
            # LFU bookkeeping, capped at the cache_topk most requested
            # blocks of this step (the reference's get_qualified_blocks,
            # cache_manager.py:241-248)
            touched = np.unique(blk_idx[ok]).astype(np.int32)
            if touched.size > self.cache_topk:
                counts = np.bincount(blk_idx[ok].ravel(),
                                     minlength=self.max_blocks)
                touched = touched[
                    np.argsort(-counts[touched])[: self.cache_topk]]
            # hits (frequency bumps) before admissions within one batch: an
            # admission may evict a block that comes later in the batch,
            # which would then re-enter at a fresh slot that nothing
            # stages. With hits first every proxy entry after the batch is
            # the old slot, -1, or a fresh slot whose staged rows admit()
            # writes.
            t_hit = proxy[touched] >= 0
            touched = np.ascontiguousarray(
                np.concatenate([touched[t_hit], touched[~t_hit]]), np.int32)
            lfu = self.lfu[layer]
            if touched.size:
                lfu.batched_insert_async(touched, proxy)
            if miss_blocks.size:
                staged = self._stage(layer, miss_blocks)
                lut = np.full((self.max_blocks,), -1, np.int64)
                lut[miss_blocks] = np.arange(miss_blocks.size)
                miss_pos = np.where(ok & ~hit, lut[clipped], -1)
                lfu.synchronize()
                new = proxy[miss_blocks]
                admitted = new >= 0
                if admitted.any():
                    self._pending[layer] = (new[admitted],
                                            np.flatnonzero(admitted), staged)
            else:
                staged = self._no_miss
                miss_pos = np.full_like(slots, -1)
                lfu.synchronize()
        return (slots.astype(np.int32), miss_pos.astype(np.int32), staged,
                self.cache_kv[layer])

    def fetch(self, layer: int, token_idx: np.ndarray
              ) -> Tuple[torch.Tensor, torch.Tensor]:
        """token_idx [H_kv, k] -> (k_top, v_top) [H_kv, k, D] on the device
        (tests): classify the covering blocks, assemble them, pick the rows;
        tokens past the complete blocks come from the device tail."""
        token_idx = np.asarray(token_idx)
        bs = self.block
        slots, miss_pos, staged, cache = self.classify_blocks(
            layer, token_idx // bs)
        blocks = assemble_blocks(cache, staged, self.device_index(slots),
                                 self.device_index(miss_pos))
        self.admit(layer)
        heads = torch.arange(self.H_kv, device=self.device)[:, None]
        j = torch.arange(token_idx.shape[1], device=self.device)[None, :]
        rows = blocks[heads, j, self.device_index(token_idx % bs)]
        valid = int(self.valid[layer])
        off = self.device_index(np.clip(token_idx - valid, 0, bs - 1))
        in_tail = self.device_index(token_idx >= valid).bool()
        rows = torch.where(in_tail[..., None],
                           self.tail[layer][heads, off], rows)
        return rows[..., :self.D], rows[..., self.D:]

    def flush(self) -> None:
        """Apply pending admissions and drain the LFUs' worker threads."""
        for layer, lfu in enumerate(self.lfu):
            self.admit(layer)
            lfu.synchronize()

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0
