"""The joint-histogram block scorer: raw per-q-head block mass straight from
the uint8 joint code histogram, with the deferred joins' correction.

The CUDA kernel ``csrc/jhist_mass.cu`` replaces no Pallas kernel: the JAX
package computes this mass with an XLA einsum
(``pqcache_tpu/core/pq.py::joint_block_mass``), where the TPU fuses the
uint8 -> f32 convert into the dot. Its plain PyTorch version
``jhist_block_mass_ref`` is that einsum written out (an f32 copy of the
histogram and a batched product with the [g, C^2] pair table) plus the
pending joins' mass as a one-hot product. On a CPU tensor the wrapper
computes the plain version; on a CUDA tensor it launches the kernel or
raises. The kernel contracts the counts with e1 on the tensor cores, e1
cut exactly into three bf16 pieces; ``split_factors`` is that cut in plain
PyTorch.
"""

from __future__ import annotations

import torch

from pqcache_tpu_torch.ops import _build
from pqcache_tpu_torch.runtime.stages import scoped

MAX_CENTROIDS = 256       # histogram rows of C^2 <= 64 KB
MAX_GROUP = 16            # q heads per kv head (16: MLA's latent head)
MAX_BLOCK = 256           # uint8 counts (core/pq.py::jhist_dtype)
MAX_PENDING = 1024        # pending joins per folded kv head (csrc MAX_K)
FACTOR_SCALE = 2.0 ** 126  # e1's scale before the cut (csrc E1_SCALE)


def _shapes(e: torch.Tensor, J: torch.Tensor, pending, block: int):
    """(Hf, g, C, NB, K) of a call, or raise on what neither version takes."""
    if J.dtype != torch.uint8:
        raise TypeError(f"jhist_block_mass: J must be uint8 counts, got "
                        f"{J.dtype}")
    if e.dim() != 3 or J.dim() != 3 or e.shape[1] != 2:
        raise ValueError(f"jhist_block_mass: e {tuple(e.shape)} is not "
                         f"[H, 2, C] or J {tuple(J.shape)} not [H_kv, NB, "
                         f"C^2]")
    H, _, C = e.shape
    Hf, NB, CC = J.shape
    if C > MAX_CENTROIDS or CC != C * C or Hf < 1 or H % Hf:
        raise ValueError(f"jhist_block_mass: e {tuple(e.shape)} and J "
                         f"{tuple(J.shape)} do not match, or C > "
                         f"{MAX_CENTROIDS}")
    g = H // Hf
    if g > MAX_GROUP:
        raise ValueError(f"jhist_block_mass: {g} q heads per kv head; at "
                         f"most {MAX_GROUP}")
    K = 0
    if pending is not None:
        pos, codes, _ = pending
        K = pos.shape[-1]
        if (pos.shape != (Hf, K) or codes.shape != (Hf, 2, K)
                or not 1 <= block <= MAX_BLOCK):
            raise ValueError(f"jhist_block_mass: pending pos "
                             f"{tuple(pos.shape)}, codes "
                             f"{tuple(codes.shape)} for {Hf} kv heads, "
                             f"block {block} (1 to {MAX_BLOCK})")
    return Hf, g, C, NB, K


def split_factors(e1: torch.Tensor) -> torch.Tensor:
    """The kernel's cut of the factors: e1 · 2^126 (f32) as three bf16
    pieces [3, *e1.shape], hi + mid + lo, each the residual's top 16 bits
    (sign, exponent, 7 bits), truncated, so that each residual and the sum
    of the pieces are exact. For e1 in [0, 1] every nonzero piece is a
    normal bf16."""
    x = e1.float() * FACTOR_SCALE
    pieces = []
    for _ in range(3):
        top = (x.view(torch.int32) & -0x10000).view(torch.float32)
        pieces.append(top.to(torch.bfloat16))
        x = x - top
    return torch.stack(pieces)


@scoped("pq_score")
def jhist_block_mass_ref(e: torch.Tensor, J: torch.Tensor, pending=None, *,
                         block: int = 1) -> torch.Tensor:
    """Plain version of jhist_block_mass (same contract)."""
    Hf, g, C, NB, K = _shapes(e, J, pending, block)
    pair = (e[:, 0, :, None] * e[:, 1, None, :]).reshape(Hf, g, C * C)
    mass = torch.bmm(pair, J.float().transpose(1, 2)).reshape(Hf * g, NB)
    if pending is None:
        return mass
    pos, codes, ring_r = pending
    ok = torch.arange(K, device=pos.device) < ring_r
    c = codes[:, None].expand(Hf, g, 2, K).reshape(Hf * g, 2, K)
    val = torch.where(ok, e[:, 0].gather(1, c[:, 0])
                      * e[:, 1].gather(1, c[:, 1]), 0.0)   # [H, K]
    cols = torch.div(pos, block, rounding_mode="floor").clamp(0, NB - 1)
    cols = cols[:, None].expand(Hf, g, K).reshape(Hf * g, K)
    # a one-hot product sums each column in a fixed order
    onehot = (cols[..., None] == torch.arange(NB, device=cols.device)
              ).float()                                    # [H, K, NB]
    return mass + torch.bmm(val[:, None, :], onehot)[:, 0]


@scoped("pq_score")
def jhist_block_mass(e: torch.Tensor, J: torch.Tensor, pending=None, *,
                     block: int = 1) -> torch.Tensor:
    """Raw per-q-head block mass of one layer's joint histogram.

    e [Hf·g, 2, C] f32 in [0, 1], the exp-LUT factors
    (``core/pq.jhist_exp_lut``); J
    [Hf, NB, C²] uint8, read in place. ``pending``: the joins the histogram
    does not count yet, (pos [Hf, K] int64 tail positions, codes [Hf, 2, K]
    int64, ring_r: the first ring_r of the K are live, a 0-d int32 tensor
    on the device), each adding e0[h, code0] · e1[h, code1] to block
    clamp(pos // block, 0, NB - 1). Returns mass [Hf·g, NB] f32:
    mass[h, n] = Σ_c0 e0[h, c0] Σ_c1 e1[h, c1] J[kv(h), n, c0·C + c1]
    plus the pending terms, not normalised. C <= 256, g <= 16, block <=
    256. ``launches`` counts the kernel's launches, ``mma_launches`` those
    that contracted on the tensor cores (all of them: one body for every
    C)."""
    Hf, g, C, NB, K = _shapes(e, J, pending, block)
    if e.device.type == "cpu":
        return jhist_block_mass_ref(e, J, pending, block=block)
    tensors = (e, J) + (tuple(pending) if pending is not None else ())
    if e.device.type != "cuda" or any(
            not isinstance(t, torch.Tensor) or t.device != e.device
            for t in tensors):
        raise ValueError("jhist_block_mass: the kernel takes every tensor on "
                         "one CUDA device")
    if C < 2 or C & (C - 1):
        raise ValueError(f"jhist_block_mass: the kernel takes C a power of "
                         f"two from 2 to {MAX_CENTROIDS}, got {C}")
    if g > 8 and C < 16:
        raise ValueError(f"jhist_block_mass: the kernel takes 9 to 16 q "
                         f"heads per kv head at C >= 16, got C {C}")
    if e.dtype != torch.float32 or not e.is_contiguous():
        raise ValueError(f"jhist_block_mass: e must be contiguous f32, got "
                         f"{e.dtype}")
    if not J.is_contiguous():
        raise ValueError("jhist_block_mass: J must be contiguous (an f32 "
                         "or compacted copy is what the kernel saves)")
    ptrs = (None, None, None)
    if pending is not None:
        pos, codes, ring_r = pending
        if (pos.dtype != torch.int64 or codes.dtype != torch.int64
                or not pos.is_contiguous() or not codes.is_contiguous()
                or ring_r.dtype != torch.int32 or ring_r.numel() != 1
                or K > MAX_PENDING):
            raise ValueError(f"jhist_block_mass: pending takes contiguous "
                             f"int64 pos and codes, at most {MAX_PENDING} "
                             f"joins, and a one-element int32 ring_r")
        ptrs = (pos.data_ptr(), codes.data_ptr(), ring_r.data_ptr())
    out = torch.empty((Hf * g, NB), dtype=torch.float32, device=e.device)
    _build.check(_build.lib("jhist_mass").pq_jhist_block_mass(
        e.data_ptr(), J.data_ptr(), Hf, g, C, NB, *ptrs, K, int(block),
        out.data_ptr(), _build.stream_ptr(e.device)), "jhist_block_mass")
    jhist_block_mass.launches += 1
    jhist_block_mass.mma_launches += 1     # one tensor-core body for every C
    return out


jhist_block_mass.launches = 0
jhist_block_mass.mma_launches = 0
