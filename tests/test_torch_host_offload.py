"""The port's host-offload store (``runtime/host_offload.py``) against the
JAX package's, and the cases of ``tests/test_host_offload.py``.

The same float32 rows are offloaded into the port's ``HostKVStore`` (on the
CPU: plain host tensors, copies in order) and into
``pqcache_tpu.runtime.host_offload.HostKVStore``; the same selection,
append and invalidation traces then go through both. At every step the
slots, miss positions, hit and miss counts and the assembled blocks must
be equal (the port admits after the assembly, the JAX package into a new
array; both assemble from the cache before the admission). Then the JAX
package's cases, on the native LFU and on its Python model: fetched rows
equal the offloaded ones, repeated fetches hit, the cache stays right
under eviction churn, appends are visible and refresh a resident block,
a partial tail block is never admitted, a hit evicted and readmitted in
one batch serves its own rows, and ``invalidate_blocks`` recycles a range.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pqcache_tpu.runtime.host_offload import HostKVStore as JHostKVStore
from pqcache_tpu.runtime.host_offload import \
    assemble_blocks as jassemble_blocks
from pqcache_tpu_torch.runtime.host_offload import (HostKVStore,
                                                    assemble_blocks)
from test_torch_lfu import python_model

torch.set_num_threads(1)
KW = dict(layers=1, n_kv_heads=2, capacity=512, head_dim=8, block_size=32,
          hbm_cache_tokens=128, cache_topk_blocks=4)
ROUTES = ["native", "python"]


def _store(route="native", **kw):
    s = HostKVStore(**dict(KW, **kw), dtype=torch.float32, device="cpu")
    if route == "python":
        for c in s.lfu:
            python_model(c)
    elif not s.lfu[0].native:
        pytest.skip("native LFU unavailable")
    return s


def _assemble(s, layer, blk, ok=None):
    slots, miss, staged, cache = s.classify_blocks(layer, blk, ok=ok)
    got = assemble_blocks(cache, staged, torch.from_numpy(slots).long(),
                          torch.from_numpy(miss).long())
    s.admit(layer)
    return slots, miss, got


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("cache_tokens", [64, 128])
def test_store_matches_jax_step_by_step(route, cache_tokens):
    kw = dict(KW, layers=2, capacity=640, hbm_cache_tokens=cache_tokens)
    js = JHostKVStore(**kw, dtype=jnp.float32)
    s = _store(route, **kw)
    rng = np.random.default_rng(cache_tokens)
    for layer in range(2):
        k = rng.normal(size=(2, 300, 8)).astype(np.float32)
        v = rng.normal(size=(2, 300, 8)).astype(np.float32)
        js.offload_layer(layer, k, v)
        s.offload_layer(layer, k, v)
    for step in range(30):
        layer = step % 2
        n_blk = int(s.valid[layer]) // 32 + 1       # one id past: invalid
        blk = np.sort(np.stack([rng.choice(n_blk, 4, replace=False)
                                for _ in range(2)]), -1)
        js_out = js.classify_blocks(layer, blk)
        jgot = np.asarray(jassemble_blocks(
            js_out[3], js_out[2], jnp.asarray(js_out[0]),
            jnp.asarray(js_out[1])))
        slots, miss, got = _assemble(s, layer, blk)
        np.testing.assert_array_equal(slots, js_out[0], err_msg=str(step))
        np.testing.assert_array_equal(miss, js_out[1], err_msg=str(step))
        assert (s.hits, s.misses) == (js.hits, js.misses), step
        ok = blk < int(s.valid[layer]) // 32
        np.testing.assert_array_equal(got.numpy()[ok], jgot[ok])
        np.testing.assert_array_equal(s.block_slot, js.block_slot)
        if step % 3 == 0:               # appends cross block boundaries
            for lyr in range(2):
                row = rng.normal(size=(2, 16)).astype(np.float32)
                js.append_row_device(lyr, jnp.asarray(row))
                s.append_row_device(lyr, torch.from_numpy(row))
    ids = np.arange(2, 5)
    js.invalidate_blocks(ids)
    s.invalidate_blocks(ids)
    np.testing.assert_array_equal(s.block_slot, js.block_slot)
    assert not s.stored[:, 2:5].any()
    np.testing.assert_array_equal(s.valid, js.valid)
    np.testing.assert_array_equal(s.tail_fill, js.tail_fill)
    for layer in range(2):
        np.testing.assert_array_equal(s.tail[layer].numpy(),
                                      np.asarray(js.tail[layer]))
        assert set(np.flatnonzero(s.stored[layer])) == set(
            js.kv_blocks[layer])
        for b, leaf in js.kv_blocks[layer].items():
            np.testing.assert_array_equal(s.host_kv[layer][b].numpy(),
                                          np.asarray(leaf))


def test_batch_as_heads_ids_with_ok_mask_match_jax():
    # B·H_kv rows of slot-prefixed ids and an explicit validity mask, as
    # the batched tier classifies
    kw = dict(KW, capacity=1536, hbm_cache_tokens=96)
    js = JHostKVStore(**kw, dtype=jnp.float32)
    s = _store(**kw)
    rng = np.random.default_rng(4)
    k = rng.normal(size=(2, 1536, 8)).astype(np.float32)
    js.offload_layer(0, k, k)
    s.offload_layer(0, k, k)
    for step in range(12):
        blk = rng.integers(0, 16, size=(6, 3))
        ok = rng.random((6, 3)) < 0.8
        gids = np.where(ok, blk + 16 * (np.arange(6) // 2)[:, None], 0)
        j = js.classify_blocks(0, gids, ok=ok)
        jgot = np.asarray(jassemble_blocks(j[3], j[2], jnp.asarray(j[0]),
                                           jnp.asarray(j[1])))
        slots, miss, got = _assemble(s, 0, gids, ok=ok)
        np.testing.assert_array_equal(slots, j[0])
        np.testing.assert_array_equal(miss, j[1])
        np.testing.assert_array_equal(got.numpy()[ok], jgot[ok])
    assert (s.hits, s.misses) == (js.hits, js.misses)


@pytest.mark.parametrize("route", ROUTES)
def test_fetch_returns_host_rows(route):
    s = _store(route)
    rng = np.random.default_rng(0)
    k = rng.normal(size=(2, 512, 8)).astype(np.float32)
    v = rng.normal(size=(2, 512, 8)).astype(np.float32)
    s.offload_layer(0, k, v)
    idx = np.array([[3, 100, 511], [0, 64, 200]])
    k_top, v_top = s.fetch(0, idx)
    for h in range(2):
        np.testing.assert_array_equal(k_top[h].numpy(), k[h, idx[h]])
        np.testing.assert_array_equal(v_top[h].numpy(), v[h, idx[h]])


@pytest.mark.parametrize("route", ROUTES)
def test_repeated_fetch_hits_cache(route):
    s = _store(route)
    k = np.random.default_rng(1).normal(size=(2, 512, 8)).astype(np.float32)
    s.offload_layer(0, k, k.copy())
    idx = np.array([[0, 1, 2, 33, 34]] * 2)
    s.fetch(0, idx)                      # cold: misses, blocks 0, 1 admitted
    h0, m0 = s.hits, s.misses
    k_top, _ = s.fetch(0, idx)
    assert s.hits > h0 and s.misses == m0
    for h in range(2):
        np.testing.assert_array_equal(k_top[h].numpy(), k[h, idx[h]])


@pytest.mark.parametrize("route", ROUTES)
def test_cache_correct_after_eviction_churn(route):
    s = _store(route, hbm_cache_tokens=64)          # a 2-block cache
    k = np.random.default_rng(2).normal(size=(2, 512, 8)).astype(np.float32)
    s.offload_layer(0, k, k.copy())
    for start in (0, 64, 128, 192, 0, 256, 64):
        idx = np.tile(np.arange(start, start + 8)[None], (2, 1))
        k_top, _ = s.fetch(0, idx)
        for h in range(2):
            np.testing.assert_array_equal(k_top[h].numpy(), k[h, idx[h]],
                                          err_msg=f"start={start}")
    assert (s.block_slot[0] >= 0).sum() <= s.n_cache_blocks


def test_append_token_visible():
    s = _store()
    k = np.zeros((2, 512, 8), np.float32)
    s.offload_layer(0, k[:, :100], k[:, :100])
    new = np.full((2, 8), 7.0, np.float32)
    s.append_token(0, 100, new, new * 2)
    k_top, v_top = s.fetch(0, np.array([[100], [100]]))
    np.testing.assert_array_equal(k_top[:, 0].numpy(), new)
    np.testing.assert_array_equal(v_top[:, 0].numpy(), new * 2)
    with pytest.raises(ValueError):
        s.append_token(0, 200, new, new)


def test_append_refreshes_resident_block():
    # a row written into a block the cache holds is served fresh
    s = _store()
    k = np.random.default_rng(7).normal(size=(2, 512, 8)).astype(np.float32)
    s.offload_layer(0, k[:, :96], k[:, :96])         # blocks 0..2 complete
    idx = np.tile(np.arange(64, 72)[None], (2, 1))
    for _ in range(3):
        s.fetch(0, idx)                              # block 2 admitted
    assert s.block_slot[0][2] >= 0
    new = np.full((2, 8), 9.0, np.float32)
    s.append_token(0, 80, new, new * 3)
    k_top, v_top = s.fetch(0, np.array([[80], [80]]))
    np.testing.assert_array_equal(k_top[:, 0].numpy(), new)
    np.testing.assert_array_equal(v_top[:, 0].numpy(), new * 3)


def test_partial_tail_block_not_admitted():
    s = _store()
    k = np.ones((2, 512, 8), np.float32)
    s.offload_layer(0, k[:, :40], k[:, :40])         # block 1 8/32 rows
    idx = np.tile(np.arange(32, 40)[None], (2, 1))
    for _ in range(3):
        k_top, _ = s.fetch(0, idx)
    assert s.block_slot[0][1] < 0
    np.testing.assert_array_equal(k_top.numpy(), 1.0)


@pytest.mark.parametrize("route", ROUTES)
def test_hit_evicted_and_readmitted_in_one_batch_serves_its_rows(route):
    # one hot block and rotating cold ones through a 3-block cache: each
    # step mixes hits and admissions that evict around the hot block; every
    # assembled block must be the host block (hits before misses in the
    # LFU batch, the assembly before the admission)
    s = _store(route, hbm_cache_tokens=96)
    k = np.random.default_rng(7).normal(size=(2, 512, 8)).astype(np.float32)
    s.offload_layer(0, k, k.copy())
    for step in range(24):
        cold = 1 + (step % 4) * 3
        blk = np.asarray([[0, cold, cold + 1], [cold + 1, 0, cold]])
        slots, _, got = _assemble(s, 0, blk)
        for h in range(2):
            for j in range(3):
                np.testing.assert_array_equal(
                    got[h, j].numpy(), s.host_kv[0][int(blk[h, j]), h].numpy(),
                    err_msg=f"step={step} h={h} slot={slots[h, j]}")


@pytest.mark.parametrize("route", ROUTES)
def test_invalidate_blocks_recycles_range(route):
    s = _store(route, hbm_cache_tokens=128)
    rng = np.random.default_rng(5)
    k1 = rng.normal(size=(2, 256, 8)).astype(np.float32)
    s.offload_layer(0, k1, k1.copy())
    idx = np.tile(np.arange(0, 64)[None], (2, 1))
    s.fetch(0, idx)
    s.fetch(0, idx)
    assert (s.block_slot[0][:2] >= 0).all()
    s.invalidate_blocks(np.arange(8))
    assert (s.block_slot[0][:8] == -1).all() and not s.stored[0].any()
    k2 = rng.normal(size=(2, 256, 8)).astype(np.float32)
    s.offload_layer(0, k2, k2.copy())                # same ids, new rows
    k_top, _ = s.fetch(0, idx)
    for h in range(2):
        np.testing.assert_array_equal(k_top[h].numpy(), k2[h, idx[h]])


def test_int8_rows_and_transfer_counts():
    # an int8 store carries int8 rows end to end; the counters add up
    s = HostKVStore(**KW, dtype=torch.int8, device="cpu")
    k = torch.randint(-127, 128, (2, 300, 8), dtype=torch.int8)
    s.offload_layer_device(0, k, k, 300)
    assert s.host_kv[0].dtype == s.cache_kv[0].dtype == torch.int8
    assert s.tail[0].dtype == torch.int8 and s.tail_fill[0] == 300 % 32
    _assemble(s, 0, np.array([[0, 3], [1, 8]]))
    t = s.transfer_stats()
    assert t["d2h_bytes"] == 9 * 2 * 32 * 16
    assert t["h2d_bytes"] == 4 * 2 * 32 * 16
    assert t["pinned_bytes"] == 0 and t["h2d_s"] is None



def test_cpu_store_without_the_library_takes_the_python_model(monkeypatch):
    # only a CPU store may fall back to the Python LFU (a card store raises,
    # tests/test_torch_cuda.py); it then gives JAX's store's slots
    from pqcache_tpu_torch.native import lfu_cache
    monkeypatch.setattr(lfu_cache, "_load", lambda: None)
    s = HostKVStore(**KW, dtype=torch.float32, device="cpu")
    assert not any(c.native for c in s.lfu)
    js = JHostKVStore(**KW, dtype=jnp.float32)
    kv = np.random.default_rng(4).normal(size=(2, 512, 8)).astype(
        np.float32)
    s.offload_layer(0, kv, kv)
    js.offload_layer(0, kv, kv)
    for blk in ([[0, 1], [2, 3]], [[4, 5], [0, 6]], [[7, 8], [1, 9]],
                [[0, 3], [10, 11]]):
        blk = np.asarray(blk)
        js_out = js.classify_blocks(0, blk)
        slots, miss, got = _assemble(s, 0, blk)
        np.testing.assert_array_equal(slots, js_out[0])
        np.testing.assert_array_equal(miss, js_out[1])
        np.testing.assert_array_equal(s.block_slot, js.block_slot)
        np.testing.assert_array_equal(got.numpy(), np.asarray(
            jassemble_blocks(js_out[3], js_out[2], jnp.asarray(js_out[0]),
                             jnp.asarray(js_out[1]))))
    assert s.hits == js.hits > 0
