"""Token sampling: greedy, temperature, top-k and nucleus (top-p).

Counterpart of ``pqcache_tpu/core/sampling.py``. ``make_sampler`` returns
None for greedy decoding (temperature 0; callers keep their argmax), or a
sampler over logits [..., V] (leading batch dims draw independently): the
logits divided by the temperature, truncated to the top-k logits (every
logit >= the k-th largest) and to the nucleus (the sorted ranks whose
preceding probability mass is below top_p, rank 0 always kept), then one
categorical draw.

The JAX package draws with ``jax.random.categorical``, which is
``argmax(gumbel + logits)``. The port draws the same way, Gumbel-max, but
takes the noise as an argument: ``GumbelNoise`` draws it from an explicit
``torch.Generator`` (g = -log(-log(U))). Torch cannot replay
``jax.random``; given JAX's own Gumbel draws, the sampler gives JAX's
tokens. The noise is drawn outside the sampler so that a decode step
captured into a CUDA graph can read it from a static buffer refilled before
each replay: replayed and eager steps then see the same noise.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

NEG_INF = -1e30


def truncated_logits(logits: torch.Tensor, temperature: float,
                     top_k: int = 0, top_p: float = 1.0) -> torch.Tensor:
    """The float32 logits [..., V] a draw takes: divided by the
    temperature, the ones outside the top-k and the nucleus at NEG_INF."""
    lg = logits.float() / temperature
    if top_k and top_k > 0:
        kth = torch.topk(lg, top_k, dim=-1).values[..., -1:]
        lg = torch.where(lg >= kth, lg, NEG_INF)
    if top_p < 1.0:
        sorted_l = torch.sort(lg, dim=-1, descending=True).values
        probs = torch.softmax(sorted_l, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        # keep ranks whose PRECEDING mass is < top_p (always rank 0); the
        # cutoff is the smallest kept sorted logit
        keep = cum - probs < top_p
        cutoff = torch.where(keep, sorted_l, float("inf")).amin(
            -1, keepdim=True)
        lg = torch.where(lg >= cutoff, lg, NEG_INF)
    return lg


def make_sampler(temperature: float = 0.0, top_k: int = 0,
                 top_p: float = 1.0) -> Optional[Callable]:
    """``sample(logits [..., V], noise [..., V] f32) -> int32 [...]``, or
    None for greedy (temperature 0)."""
    if temperature <= 0.0:
        return None

    def sample(logits: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
        lg = truncated_logits(logits, temperature, top_k, top_p)
        return torch.argmax(noise + lg, dim=-1).to(torch.int32)

    return sample


class GumbelNoise:
    """Gumbel noise from a ``torch.Generator`` seeded with ``seed`` on
    ``device``: U uniform in [tiny, 1) as JAX draws it, g = -log(-log(U))."""

    def __init__(self, seed: int, device):
        self.generator = torch.Generator(device=device).manual_seed(seed)
        self.device = torch.device(device)

    def fill_(self, buf: torch.Tensor) -> torch.Tensor:
        """Overwrite the float32 ``buf`` with fresh noise; returns it."""
        torch.rand(buf.shape, generator=self.generator, out=buf)
        tiny = torch.finfo(buf.dtype).tiny
        return buf.clamp_(min=tiny).log_().neg_().log_().neg_()

    def draw(self, shape) -> torch.Tensor:
        """Fresh noise of ``shape`` (float32)."""
        return self.fill_(torch.empty(shape, dtype=torch.float32,
                                      device=self.device))
