"""Build and load the hand-written CUDA kernels (``pqcache_tpu_torch/csrc``).

At first use every ``csrc/*.cu`` is compiled by ``nvcc`` into its own
shared library with a plain C interface (one ``nvcc`` per source, all
started together) and loaded with ``ctypes``. Nothing here runs at import:
the CPU tests import every module of the port without a CUDA toolkit.

Libraries are cached under ``build/kernels`` inside the package (a
directory ``.gitignore`` lists), named by a hash of the source and the
flags, so an edited source is rebuilt.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

from pqcache_tpu_torch.runtime.stages import count, span

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC.parent / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-lineinfo"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# argtypes of each library's C entry points (all return a cudaError_t)
SIGNATURES = {
    "flash_attention": {"pq_flash_attention": [_P] * 6 + [_I] * 9 + [_P],
                        "pq_flash_attention_window": [_P] * 4 + [_I] * 9
                        + [_P],
                        "pq_flash_attention_dv": [_P] * 4 + [_I] * 10
                        + [_F, _P]},
    "flash_scores": {"pq_flash_scores": [_P] * 6 + [_I] * 8 + [_P]},
    "block_attn": {"pq_block_attn": [_P, _P] + [_I] * 6
                   + [_P, _I, _I, _P, _I, _I, _I, _P, _I, _I, _I] + [_P] * 4,
                   "pq_block_attn_ctas": [],
                   "pq_latent_attn": [_P, _P] + [_I] * 6
                   + [_P, _I, _I, _P, _I, _I, _I, _P, _I, _I, _I, _I]
                   + [_P] * 5},
    "adc": {"pq_adc_scores": [_P, _P] + [_I] * 6 + [_P, _P],
            "pq_adc_block_scores": [_P, _P, _P] + [_I] * 9 + [_P] * 2,
            "pq_adc_block_scores_ctas": []},
    "gather": {"pq_gather_rows": [_P, _P] + [_I] * 6 + [_P, _P]},
    "jhist_mass": {"pq_jhist_block_mass": [_P, _P] + [_I] * 4 + [_P] * 3
                   + [_I, _I, _P, _P]},
    "w8_matmul": {"pq_w8_group": [_P] * 10 + [_I] * 8 + [_P] * 3},
}

_libs: dict[str, ctypes.CDLL] = {}
build_seconds: float | None = None   # host seconds of the last build span


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _lib_path(src: Path) -> Path:
    h = hashlib.sha256(src.read_bytes())
    for dep in sorted(CSRC.glob("*.cuh")):
        h.update(dep.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{src.stem}_{h.hexdigest()[:12]}.so"


def build_all(verbose: bool = False) -> dict[str, ctypes.CDLL]:
    """Compile (if not cached) and load every kernel library, in a
    host-only ``build`` span (``runtime/stages.py``) whose host time is
    ``build_seconds``; the counters ``build.compiled`` and ``build.loaded``
    count the libraries nvcc compiled and those the cache held. Returns
    {source stem: CDLL}. Raises with nvcc's output on a failed build."""
    global build_seconds
    if _libs:
        return _libs
    with span("build", host_only=True) as sp:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        sources = sorted(CSRC.glob("*.cu"))
        procs = []
        for src in sources:
            dst = _lib_path(src)
            if dst.exists():
                continue
            tmp = dst.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", str(tmp),
                   str(src)]
            procs.append((src, dst, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        failed = []
        for src, dst, tmp, p in procs:
            log, _ = p.communicate()
            if p.returncode != 0:
                failed.append(f"--- {src.name} (nvcc rc {p.returncode})\n"
                              f"{log}")
                continue
            if verbose:
                print(f"[build] {src.name}\n{log}", flush=True)
            os.replace(tmp, dst)
        if failed:
            raise RuntimeError("CUDA kernel build failed:\n"
                               + "\n".join(failed))
        for src in sources:
            lib_ = ctypes.CDLL(str(_lib_path(src)))
            for name, argtypes in SIGNATURES.get(src.stem, {}).items():
                fn = getattr(lib_, name)
                fn.argtypes, fn.restype = argtypes, ctypes.c_int
            _libs[src.stem] = lib_
        count("build.compiled", len(procs))
        count("build.loaded", len(sources) - len(procs))
    build_seconds = sp.host_s
    return _libs

def lib(stem: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<stem>.cu``."""
    return build_all()[stem]


def check(rc: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a C entry point."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc}")


def stream_ptr(device) -> int:
    import torch
    return torch.cuda.current_stream(device).cuda_stream
