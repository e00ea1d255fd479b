"""The port's native LFU (``pqcache_tpu_torch/native``) against the JAX
package's, and the policy cases of ``tests/test_lfu.py``.

The same random insert, erase and async-insert traces go through the port's
``LFUCache`` and ``pqcache_tpu.native.lfu_cache.LFUCache``: the proxy
arrays must be identical after every batch, on the native library and on
the pure-Python model (each route of the port against the same route of
the JAX package). Then the JAX package's cases, each on both routes:
slots assigned in order, eviction reusing the victim's slot, frequency
protecting hot blocks, out-of-range ids, async inserts, erase recycling
slots, and the randomized trace of native against the Python model.
"""

import numpy as np
import pytest

from pqcache_tpu.native.lfu_cache import LFUCache as JLFUCache
from pqcache_tpu_torch.native import lfu_cache
from pqcache_tpu_torch.native.lfu_cache import LFUCache

ROUTES = ["native", "python"]


def python_model(c: LFUCache) -> LFUCache:
    """The cache on its pure-Python model, its native handle released."""
    if c._h:
        c._lib.lfu_destroy(c._h)
    c._lib, c._h = None, None
    return c


def _make(route, capacity):
    c = LFUCache(capacity)
    if route == "python":
        return python_model(c)
    if not c.native:
        pytest.skip(f"native LFU unavailable: {lfu_cache.build_error}")
    return c


def _jax_make(route, capacity):
    c = JLFUCache(capacity)
    if route == "python":
        if c._lib is not None and c._h:
            c._lib.lfu_destroy(c._h)
        c._lib, c._h = None, None
    elif not c.native:
        pytest.skip("the JAX package's native LFU is unavailable")
    return c


@pytest.fixture(params=ROUTES)
def make_cache(request):
    return lambda capacity: _make(request.param, capacity)


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_lfu_traces_match_jax(route, seed):
    rng = np.random.default_rng(seed)
    cap, n_blocks = 8 + 4 * seed, 48
    a, b = _make(route, cap), _jax_make(route, cap)
    pa = np.full(n_blocks, -1, np.int32)
    pb = np.full(n_blocks, -1, np.int32)
    for step in range(120):
        ids = rng.integers(-2, n_blocks + 2, size=rng.integers(1, 12)).astype(
            np.int32)
        op = step % 5
        if op == 3:
            a.synchronize()
            b.synchronize()
            a.batched_erase(ids, pa)
            b.batched_erase(ids, pb)
        elif op == 4:
            a.batched_insert_async(ids, pa)
            b.batched_insert_async(ids, pb)
            a.synchronize()
            b.synchronize()
        else:
            a.batched_insert(ids, pa)
            b.batched_insert(ids, pb)
        np.testing.assert_array_equal(pa, pb, err_msg=f"step {step}")
        assert len(a) == len(b)
        assert all(a.contains(int(k)) == b.contains(int(k))
                   for k in range(n_blocks))


def test_slots_assigned_sequentially(make_cache):
    c = make_cache(4)
    proxy = np.full(16, -1, np.int32)
    c.batched_insert(np.array([3, 5, 7], np.int32), proxy)
    assert proxy[3] == 0 and proxy[5] == 1 and proxy[7] == 2
    assert len(c) == 3


def test_eviction_reuses_slot_and_resets_proxy(make_cache):
    c = make_cache(2)
    proxy = np.full(16, -1, np.int32)
    c.batched_insert(np.array([1, 2], np.int32), proxy)
    c.batched_insert(np.array([1], np.int32), proxy)    # 2 is the victim
    c.batched_insert(np.array([9], np.int32), proxy)
    assert proxy[2] == -1 and proxy[9] == 1 and proxy[1] == 0
    assert c.contains(1) and c.contains(9) and not c.contains(2)


def test_frequency_protects_hot_blocks(make_cache):
    c = make_cache(3)
    proxy = np.full(32, -1, np.int32)
    c.batched_insert(np.array([0, 1, 2], np.int32), proxy)
    for _ in range(5):
        c.batched_insert(np.array([0, 1], np.int32), proxy)
    c.batched_insert(np.array([10, 11], np.int32), proxy)
    # 2 goes first (frequency 1), then 10 (frequency 1, older than 11)
    assert proxy[2] == -1 and proxy[10] == -1
    assert proxy[0] >= 0 and proxy[1] >= 0 and proxy[11] >= 0


def test_out_of_range_ids_ignored(make_cache):
    c = make_cache(4)
    proxy = np.full(8, -1, np.int32)
    c.batched_insert(np.array([-1, 100, 3], np.int32), proxy)
    assert len(c) == 1 and proxy[3] == 0


def test_async_insert_then_synchronize(make_cache):
    c = make_cache(8)
    proxy = np.full(64, -1, np.int32)
    for rounds in range(4):
        ids = np.arange(rounds * 8, rounds * 8 + 8, dtype=np.int32) % 16
        c.batched_insert_async(ids, proxy)
        c.synchronize()
    assert len(c) == 8 and (proxy >= 0).sum() == 8


def test_erase_recycles_slots(make_cache):
    c = make_cache(4)
    proxy = np.full(16, -1, np.int32)
    c.batched_insert(np.array([1, 2, 3], np.int32), proxy)
    s2 = proxy[2]
    c.batched_erase(np.array([2, 9], np.int32), proxy)   # 9 absent: no-op
    assert proxy[2] == -1 and not c.contains(2) and len(c) == 2
    c.batched_insert(np.array([7], np.int32), proxy)     # the freed slot
    assert proxy[7] == s2
    c.batched_insert(np.array([1, 3], np.int32), proxy)
    c.batched_insert(np.array([8, 9], np.int32), proxy)
    c.batched_insert(np.array([10], np.int32), proxy)    # evicts frequency 1
    assert proxy[1] >= 0 and proxy[3] >= 0 and proxy[10] >= 0


@pytest.mark.parametrize("erase", [False, True], ids=["insert", "erase"])
def test_native_matches_python_model(erase):
    rng = np.random.default_rng(3 if erase else 0)
    a, b = _make("native", 8), _make("python", 8)
    pa = np.full(32, -1, np.int32)
    pb = np.full(32, -1, np.int32)
    for step in range(60):
        ids = rng.integers(0, 32, size=5 if erase else 6).astype(np.int32)
        if erase and step % 3 == 2:
            a.batched_erase(ids, pa)
            b.batched_erase(ids, pb)
        else:
            a.batched_insert(ids, pa)
            b.batched_insert(ids, pb)
    np.testing.assert_array_equal(pa, pb)
    assert len(a) == len(b)


def test_library_builds_outside_the_sources():
    # built at first use under pqcache_tpu_torch/build/, named by its hash
    c = _make("native", 2)
    assert c.native and lfu_cache._so_path().exists()
    assert lfu_cache._so_path().parent == lfu_cache.BUILD_DIR
    assert lfu_cache.BUILD_DIR.parts[-2:] == ("build", "lfu")
    with pytest.raises(TypeError):
        c.batched_insert(np.array([1], np.int32), np.zeros(4, np.int64))
