"""W8: the weight-only int8 matrix product (x @ W8) * s.

In the JAX package ``pqcache_tpu/models/llama.py::_mm`` (:69) and
``lm_head_logits`` (:90) write ``x @ w.astype(bf16)`` and leave it to XLA to
convert the int8 operand inside the dot, so the weights are read once, as
int8. That fusion was XLA's, not a Pallas kernel; here it is the CUDA kernel
``csrc/w8_matmul.cu``, for decode rows (M <= MAX_ROWS). Its plain version
``w8_matmul_ref`` is the JAX lines themselves in torch: the product rounded
to the activations' dtype, then scaled in that dtype for a layer, in f32 for
the LM head.

On a CPU tensor ``w8_matmul`` computes the plain version; on a CUDA tensor
it launches the kernel or raises. Rows past MAX_ROWS (prefill) are bound by
operations, not bytes: ``models/llama.py::_mm`` sends them to
``w8_dequant_matmul``, which dequantizes the one matrix to a bf16 copy and
calls ``torch.matmul``, as the JAX package leaves the large product to XLA.
"""

from __future__ import annotations

import functools

import torch

from pqcache_tpu_torch.ops import _build

MAX_ROWS = 64          # the kernel's rows: decode (the Engine 1, bench.py B)
WARPS = 4              # warps per CTA (csrc/w8_matmul.cu)


def w8_matmul_ref(x: torch.Tensor, w: torch.Tensor, s: torch.Tensor, *,
                  lm_head: bool = False) -> torch.Tensor:
    """Plain version: x [..., K] @ w [K, N] int8, scaled by s [1, N]
    ([N] taken too). A layer: (x @ w.to(x.dtype)) * s in x.dtype; the LM
    head: the product widened to f32, times s in f32."""
    y = x @ w.to(x.dtype)
    if lm_head:
        return y.float() * s.float().reshape(-1)
    return y * s.to(x.dtype).reshape(-1)


@functools.lru_cache(maxsize=None)
def plan(M: int, N: int, K: int, sms: int, ptr: int = 0):
    """(mt, nb, splits) of one launch: mt tiles of 8 rows cover M (1, 2, 4
    or 8); nb bytes per lane and weight row, of 16, 8, 4 those that N and
    the weights' address ``ptr`` (mod 16) allow and that keep a lane's
    accumulators at 64 registers (mt 4: 8 bytes, mt 8: 4); splits, the CTAs
    of a cluster along K, a power of two up to 16, each at least 64 deep,
    with the CTAs at about two per SM. The widest nb whose grid covers
    every SM once, else the narrowest (a narrow N needs narrow tiles to
    fill the card)."""
    mt = next(m for m in (1, 2, 4, 8) if M <= 8 * m)
    widest = {1: 16, 2: 16, 4: 8, 8: 4}[mt]
    nbs = [b for b in (16, 8, 4) if b <= widest and N % b == 0
           and ptr % b == 0]
    if not nbs:
        raise ValueError(f"w8_matmul: N {N} and the weights' address must "
                         f"be multiples of 4 bytes")
    for nb in nbs:
        tiles = -(-N // (WARPS * 8 * nb))
        cap = max(1, min(16, K // 64, 2 * sms // tiles))
        splits = 1 << (cap.bit_length() - 1)
        if tiles * splits >= sms:
            break
    return mt, nb, splits


@functools.lru_cache(maxsize=None)
def _sms(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _check(x, w, s, K: int, N: int, M: int) -> None:
    """Raise on what the kernel does not take (CUDA tensors only)."""
    if x.device.type != "cuda" or w.device != x.device or s.device != x.device:
        raise ValueError(f"w8_matmul: x on {x.device}, w on {w.device}, s on "
                         f"{s.device}; the kernel takes all on one CUDA "
                         f"device")
    if x.dtype != torch.bfloat16 or w.dtype != torch.int8 \
            or s.dtype != torch.bfloat16:
        raise TypeError(f"w8_matmul kernel takes bf16 x and s and int8 w, "
                        f"got {x.dtype}, {w.dtype}, {s.dtype}")
    if w.dim() != 2 or x.shape[-1] != K or s.numel() != N:
        raise ValueError(f"w8_matmul: x {tuple(x.shape)}, w {tuple(w.shape)},"
                         f" s {tuple(s.shape)} do not fit")
    if not (w.is_contiguous() and s.is_contiguous()):
        raise ValueError("w8_matmul: w and s must be contiguous (a copy of "
                         "the weights would cost more than the product)")
    if not 1 <= M <= MAX_ROWS:
        raise ValueError(f"w8_matmul: {M} rows; the kernel takes 1 to "
                         f"{MAX_ROWS} (prefill rows go to w8_dequant_matmul)")
    if K % 16 or N % 4:
        raise ValueError(f"w8_matmul: K {K} must be a multiple of 16 and N "
                         f"{N} of 4")


def w8_matmul(x: torch.Tensor, w: torch.Tensor, s: torch.Tensor, *,
              lm_head: bool = False) -> torch.Tensor:
    """x [..., K] @ w [K, N] int8, scaled by s [1, N] per column -> [..., N]:
    bf16 for a layer, f32 with ``lm_head``. On the card x holds at most
    MAX_ROWS rows and x, s are bf16."""
    if x.device.type == "cpu":
        return w8_matmul_ref(x, w, s, lm_head=lm_head)
    K, N = w.shape if w.dim() == 2 else (-1, -1)
    M = x.numel() // max(x.shape[-1], 1)
    _check(x, w, s, K, N, M)
    x2 = x.reshape(M, K).contiguous()
    if x2.data_ptr() % 16:
        x2 = x2.clone()
    mt, nb, splits = plan(M, N, K, _sms(x.device), w.data_ptr() % 16)
    out = torch.empty((M, N), device=x.device,
                      dtype=torch.float32 if lm_head else torch.bfloat16)
    _build.check(_build.lib("w8_matmul").pq_w8_matmul(
        x2.data_ptr(), w.data_ptr(), s.data_ptr(), out.data_ptr(), M, N, K,
        mt, nb, splits, int(lm_head), _build.stream_ptr(x.device)),
        "w8_matmul")
    w8_matmul.launches += 1
    return out.reshape(*x.shape[:-1], N)


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
