"""ctypes binding for the native LFU residency manager (``native/lfu/lfu.cc``).

The port's own copy of ``pqcache_tpu/native/lfu_cache.py``, with the same
contract as the reference's pybind module (lfu/src/python_api.cc:7-25):
``batched_insert(block_ids, proxy)`` mutates the caller-owned int32 proxy
array in place (admitted block ids get a cache slot, the evicted block's
entry becomes -1); ``batched_insert_async`` does the same on a worker
thread until ``synchronize``; ``batched_erase`` drops ids and recycles
their slots through a free list.

The shared library is built with ``g++`` at first use into
``pqcache_tpu_torch/build/lfu/`` (a directory ``.gitignore`` lists), named by
a hash of the source and the flags. Without a compiler the pure-Python
model below carries the same policy (the tests run both routes);
``LFUCache.native`` says which one an instance uses.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np

SRC = Path(__file__).resolve().parent / "lfu" / "lfu.cc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "lfu"
CXX_FLAGS = ["-O2", "-std=c++17", "-fPIC", "-shared", "-Wall", "-Wextra"]
_lib: Optional[ctypes.CDLL] = None
build_error: Optional[str] = None    # why the last build failed, if it did


def _so_path() -> Path:
    h = hashlib.sha256(SRC.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"liblfu_{h.hexdigest()[:12]}.so"


def _build() -> Optional[Path]:
    """Compile lfu.cc unless a library of this source is there. Returns its
    path, or None (with ``build_error`` set) when there is no compiler or
    the build fails."""
    global build_error
    so = _so_path()
    if so.exists():
        return so
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if cxx is None:
        build_error = "no C++ compiler (g++) found"
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    p = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SRC),
                        "-lpthread"], capture_output=True, text=True)
    if p.returncode != 0:
        build_error = f"g++ rc {p.returncode}: {p.stderr[-2000:]}"
        return None
    os.replace(tmp, so)
    return so


def _load() -> Optional[ctypes.CDLL]:
    global _lib
    if _lib is not None:
        return _lib
    so = _build()
    if so is None:
        return None
    lib = ctypes.CDLL(str(so))
    lib.lfu_create.restype = ctypes.c_void_p
    lib.lfu_create.argtypes = [ctypes.c_int64]
    lib.lfu_destroy.argtypes = [ctypes.c_void_p]
    lib.lfu_size.restype = ctypes.c_int64
    lib.lfu_size.argtypes = [ctypes.c_void_p]
    lib.lfu_contains.restype = ctypes.c_int
    lib.lfu_contains.argtypes = [ctypes.c_void_p, ctypes.c_int32]
    lib.lfu_touch.restype = ctypes.c_int
    lib.lfu_touch.argtypes = [ctypes.c_void_p, ctypes.c_int32]
    for name in ("lfu_batched_insert", "lfu_batched_insert_async",
                 "lfu_batched_erase"):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p,
                       np.ctypeslib.ndpointer(np.int32, flags="C"),
                       ctypes.c_int64,
                       np.ctypeslib.ndpointer(np.int32, flags="C"),
                       ctypes.c_int64]
    lib.lfu_synchronize.argtypes = [ctypes.c_void_p]
    _lib = lib
    return lib


class LFUCache:
    """Block-id -> cache-slot LFU with the in-place proxy protocol. Ties in
    the lowest frequency evict the least recently used id."""

    def __init__(self, capacity: int):
        self.capacity = capacity
        self._lib = _load()
        self._h = (self._lib.lfu_create(capacity)
                   if self._lib is not None else None)
        # the pure-Python model's state
        self._freq: dict[int, int] = {}
        self._tick: dict[int, int] = {}
        self._free_slots: list[int] = []
        self._next_slot = 0
        self._t = 0
        self._keepalive = None

    def __del__(self):
        if getattr(self, "_lib", None) is not None and self._h:
            self._lib.lfu_synchronize(self._h)
            self._lib.lfu_destroy(self._h)
            self._h = None

    @property
    def native(self) -> bool:
        return self._h is not None

    def __len__(self) -> int:
        if self._h is not None:
            return int(self._lib.lfu_size(self._h))
        return len(self._freq)

    def contains(self, key: int) -> bool:
        if self._h is not None:
            return bool(self._lib.lfu_contains(self._h, key))
        return key in self._freq

    @staticmethod
    def _check_proxy(proxy: np.ndarray) -> None:
        if proxy.dtype != np.int32 or not proxy.flags.c_contiguous:
            raise TypeError("proxy must be a C-contiguous int32 array")

    def batched_insert(self, block_ids: np.ndarray, proxy: np.ndarray) -> None:
        """Insert or touch each id in order; ids outside [0, len(proxy))
        are skipped."""
        block_ids = np.ascontiguousarray(block_ids, np.int32)
        self._check_proxy(proxy)
        if self._h is not None:
            self._lib.lfu_batched_insert(
                self._h, block_ids, len(block_ids), proxy, len(proxy))
            return
        for key in block_ids.tolist():
            if key < 0 or key >= len(proxy):
                continue
            self._t += 1
            if key in self._freq:
                self._freq[key] += 1
                self._tick[key] = self._t
                continue
            if len(self._freq) >= self.capacity:
                victim = min(self._freq,
                             key=lambda k: (self._freq[k], self._tick[k]))
                slot = int(proxy[victim])
                proxy[victim] = -1
                del self._freq[victim], self._tick[victim]
            elif self._free_slots:
                slot = self._free_slots.pop()
            else:
                slot = self._next_slot
                self._next_slot += 1
            self._freq[key] = 1
            self._tick[key] = self._t
            proxy[key] = slot

    def batched_erase(self, block_ids: np.ndarray, proxy: np.ndarray) -> None:
        """Drop ids from the policy: their slots go to the free list (taken
        before any eviction), their proxy entries become -1. Call
        ``synchronize`` first: erase runs on the calling thread against the
        proxy the worker may be writing."""
        block_ids = np.ascontiguousarray(block_ids, np.int32)
        self._check_proxy(proxy)
        if self._h is not None:
            self._lib.lfu_batched_erase(
                self._h, block_ids, len(block_ids), proxy, len(proxy))
            return
        for key in block_ids.tolist():
            if key < 0 or key >= len(proxy) or key not in self._freq:
                continue
            if proxy[key] >= 0:
                self._free_slots.append(int(proxy[key]))
            proxy[key] = -1
            del self._freq[key], self._tick[key]

    def batched_insert_async(self, block_ids: np.ndarray,
                             proxy: np.ndarray) -> None:
        """``batched_insert`` on the library's worker thread; the caller
        leaves ``proxy`` alone until ``synchronize``. The Python model
        inserts at once."""
        block_ids = np.ascontiguousarray(block_ids, np.int32)
        self._check_proxy(proxy)
        if self._h is None:
            self.batched_insert(block_ids, proxy)
            return
        self._keepalive = (block_ids, proxy)
        self._lib.lfu_batched_insert_async(
            self._h, block_ids, len(block_ids), proxy, len(proxy))

    def synchronize(self) -> None:
        """Wait for the worker's insert, if one is running."""
        if self._h is not None:
            self._lib.lfu_synchronize(self._h)
        self._keepalive = None
