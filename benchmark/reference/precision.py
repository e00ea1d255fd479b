"""Number formats of the reference and of its controls.

A ``Precision`` says how the reference rounds what it multiplies and what
it stores:

  * ``stated``: the configuration's own precision: bf16 activations (each
    product's output, the residual stream, the normed rows, the rope'd
    queries and keys rounded to bf16 where the model hands them on), bf16
    weights or weight-only int8 (per output column, absmax / 127, rounding
    half to even) where the configuration states it, whose product is
    rounded to bf16 before its scale (the package's rounding points for
    W8A16: a layer's bf16(bf16(x @ w) * s), the head's f32(bf16(x @ w)) *
    s); the KV cache in bf16 or, for an int8 tail, per channel over the
    prompt's tail (absmax / 127).
  * ``fp8``: the next format below bf16: both operands of every weight
    product in float8 e4m3 (per row of the activations, per output column
    of the weights, absmax / 448).
  * ``int4``: the next format below int8: weights and the KV tail as
    symmetric int4 (absmax / 7), activations as stated.
  * ``f32``: no rounding at all, for the CPU tests that hold the reference
    to the port run in float32.

Every product is taken with f32 accumulation from bf16-exact operands
(e4m3 and int8 values are exact in bf16): ``mm_f32``.
"""

from __future__ import annotations

import torch

FP8_MAX = 448.0


def mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b of bf16 operands, accumulated and returned in f32 (of f32
    operands: the f32 product)."""
    if b.dtype == torch.float32:
        return a.float() @ b
    a, b = a.to(torch.bfloat16), b.to(torch.bfloat16)
    if a.is_cuda:
        lead = a.shape[:-1]
        return torch.mm(a.reshape(-1, a.shape[-1]), b,
                        out_dtype=torch.float32).reshape(*lead, -1)
    return a.float() @ b.float()


def quantize_sym(x: torch.Tensor, qmax: int, dim: int):
    """Symmetric integer codes of x and their f32 scales (absmax / qmax
    over ``dim``, floored), rounding half to even."""
    s = torch.clamp(x.float().abs().amax(dim, keepdim=True) / qmax,
                    min=1e-12)
    return torch.clamp(torch.round(x.float() / s), -qmax, qmax), s


def fp8_round(x: torch.Tensor, dim: int) -> torch.Tensor:
    """x through float8 e4m3 with a per-slice scale over ``dim``: the
    values an fp8 operand carries, in f32."""
    s = torch.clamp(x.float().abs().amax(dim, keepdim=True) / FP8_MAX,
                    min=1e-12)
    return (x.float() / s).to(torch.float8_e4m3fn).float() * s


class Precision:
    """Rounding of weights, activations and the KV tail. ``weights``:
    "bf16" or "int8" (the configuration's), ``mode``: "stated", "fp8" or
    "int4"."""

    def __init__(self, weights: str, kv_tail: str, mode: str = "stated"):
        if mode not in ("stated", "fp8", "int4", "f32"):
            raise ValueError(f"unknown precision mode {mode!r}")
        self.weights, self.kv_tail, self.mode = weights, kv_tail, mode

    def weight(self, w: torch.Tensor) -> tuple:
        """A weight [in, out] as (bf16-exact operand, f32 column scale or
        None)."""
        if self.mode == "fp8":
            q, s = None, torch.clamp(w.float().abs().amax(0, keepdim=True)
                                     / FP8_MAX, min=1e-12)
            q = (w.float() / s).to(torch.float8_e4m3fn).to(torch.bfloat16)
            return q, s
        if self.mode == "int4":
            q, s = quantize_sym(w, 7, 0)
            return q.to(torch.bfloat16), s
        if self.mode == "f32":
            return w.float(), None
        if self.weights == "int8":
            q, s = quantize_sym(w, 127, 0)
            # the port keeps the scale in the weights' dtype
            return q.to(torch.bfloat16), s.to(w.dtype).float()
        return w.to(torch.bfloat16), None

    def embed_rows(self, e: torch.Tensor) -> torch.Tensor:
        """The embedding table [V, E] as the model reads it, f32."""
        if self.mode == "int4":
            q, s = quantize_sym(e, 7, 1)
            return q * s
        if self.weights == "int8" and self.mode == "stated":
            q, s = quantize_sym(e, 127, 1)
            return q * s.to(e.dtype).float()
        if self.mode == "fp8":
            return fp8_round(e, 1)
        return e.float()

    def act(self, x: torch.Tensor) -> torch.Tensor:
        """An activation as the model hands it on: bf16 values, in f32."""
        return x if self.mode == "f32" else x.to(torch.bfloat16).float()

    def tail_bits(self) -> int:
        """0 for a float tail, else the integer tail's largest code."""
        if self.mode == "int4":
            return 7
        return 127 if self.kv_tail == "int8" else 0


def linear(prec: Precision, x: torch.Tensor, w: tuple) -> torch.Tensor:
    """x [..., in] f32 times a weight prepared by ``Precision.weight``; in
    fp8 the rows of x go through e4m3 with their own scales too."""
    q, s = w
    if prec.mode == "fp8":
        xs = torch.clamp(x.abs().amax(-1, keepdim=True) / FP8_MAX,
                         min=1e-12)
        xq = (x / xs).to(torch.float8_e4m3fn)
        return prec.act(mm_f32(xq, q) * xs * s)
    y = mm_f32(x, q)
    if s is None:
        return prec.act(y)
    return prec.act(prec.act(y) * s)
