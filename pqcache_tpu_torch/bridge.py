"""Move JAX-package parameters and states into the port, through numpy.

The caller converts on the JAX side (``jax.tree.map(np.asarray, tree)``);
this module takes the numpy result and imports neither jax nor ml_dtypes.
bf16 arrays arrive with the ml_dtypes ``bfloat16`` dtype: they are read
through their raw 16-bit pattern, which is exact.
"""

from __future__ import annotations

import numpy as np
import torch

from pqcache_tpu_torch import resolve_device
from pqcache_tpu_torch.policies.infllm import InfLLMState
from pqcache_tpu_torch.runtime.state import DenseState, PQState


def tensor_from_numpy(a, device=None) -> torch.Tensor:
    """numpy array (bf16 via ml_dtypes included) -> a torch tensor on
    ``device`` (cuda unless given) that owns a copy of the data.
    ``np.asarray`` of a JAX array can be a read-only view of JAX's own
    buffer, and the port updates its state in place: sharing the buffer
    would write into memory JAX may still be reading."""
    device = resolve_device(device)
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        # bf16 is the top half of an f32: widen the bit pattern, then narrow
        bits = a.view(np.uint16).astype(np.uint32) << 16
        t = torch.from_numpy(bits.view(np.float32))
        return t.to(device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def params_from_numpy(tree: dict, device=None) -> dict:
    """The JAX params dict (leaves as numpy arrays) -> the port's params
    dict on ``device`` (cuda unless given), same keys and layouts."""
    device = resolve_device(device)
    out = {k: tensor_from_numpy(v, device) for k, v in tree.items()
           if k != "layers"}
    out["layers"] = {k: tensor_from_numpy(v, device)
                     for k, v in tree["layers"].items()}
    return out


def _field(src, name):
    return src[name] if isinstance(src, dict) else getattr(src, name)


def _opt(src, name, device):
    """An optional field (None or absent -> None) as a tensor."""
    v = src.get(name) if isinstance(src, dict) else getattr(src, name, None)
    return None if v is None else tensor_from_numpy(v, device)


def _counter(src, name, device):
    """A counter: a host int from a scalar (single sequence), an int32 [B]
    tensor on ``device`` from a vector (a batched state)."""
    a = np.asarray(_field(src, name))
    if a.ndim == 0:
        return int(a)
    return tensor_from_numpy(a.astype(np.int32), device)


def pq_state_from_numpy(src, device=None) -> PQState:
    """A JAX ``PQState`` with numpy leaves (an object with the fields as
    attributes, or a dict) -> the port's PQState on ``device`` (cuda unless
    given). A batched state (counters [B]) keeps its counters on the device
    and brings its ring (``ring_kv``, ``ring_r``) along."""
    device = resolve_device(device)
    ring_r = _opt(src, "ring_r", device)
    return PQState(
        k_sink=tensor_from_numpy(_field(src, "k_sink"), device),
        v_sink=tensor_from_numpy(_field(src, "v_sink"), device),
        kv_tail=tensor_from_numpy(_field(src, "kv_tail"), device),
        codes=tensor_from_numpy(_field(src, "codes"), device),
        centroids=tensor_from_numpy(_field(src, "centroids"), device),
        phi=tensor_from_numpy(_field(src, "phi"), device),
        n_cand=_counter(src, "n_cand", device),
        pos=_counter(src, "pos", device),
        jhist=_opt(src, "jhist", device),
        k_scale=_opt(src, "k_scale", device),
        v_scale=_opt(src, "v_scale", device),
        ring_kv=_opt(src, "ring_kv", device),
        ring_r=None if ring_r is None else ring_r.to(torch.int32),
    )


def dense_state_from_numpy(src, device=None) -> DenseState:
    """A JAX ``DenseState`` with numpy leaves -> the port's DenseState on
    ``device`` (cuda unless given), with h2o's ``scores`` and ``mask``
    where the source has them; a batched state keeps its counters [B] on
    the device."""
    device = resolve_device(device)
    return DenseState(
        k_cache=tensor_from_numpy(_field(src, "k_cache"), device),
        v_cache=tensor_from_numpy(_field(src, "v_cache"), device),
        length=_counter(src, "length", device),
        start=_counter(src, "start", device),
        pos=_counter(src, "pos", device),
        scores=_opt(src, "scores", device),
        mask=_opt(src, "mask", device),
    )


def infllm_state_from_numpy(src, device=None) -> InfLLMState:
    """A single-sequence JAX ``InfLLMState`` with numpy leaves -> the port's
    InfLLMState on ``device`` (cuda unless given)."""
    device = resolve_device(device)
    return InfLLMState(
        dense=dense_state_from_numpy(_field(src, "dense"), device),
        k_repr=tensor_from_numpy(_field(src, "k_repr"), device),
        repr_valid=tensor_from_numpy(_field(src, "repr_valid"), device),
        gen_scores=tensor_from_numpy(_field(src, "gen_scores"), device),
    )
