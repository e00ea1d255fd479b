"""Sharding rules: which dimension of each leaf the tensor axis splits.

Counterpart of ``pqcache_tpu/parallel/sharding.py``. The JAX package hands
``PartitionSpec`` trees to ``shard_map``, which cuts global arrays; the
port runs one process per rank, and each process holds only its own
contiguous slice of every split leaf. The tables below name, per leaf, the
dimension that ``tp`` splits (None: replicated):

  * parameters (Megatron): the columns of wq, wk, wv, gate and up, the
    rows of wo and down; ``param_specs`` shards the LM head over the vocab,
    as ``sharding.param_specs`` does, while the TP engines keep it
    replicated (``tp_decode.PARAM_SPECS``), so logits come out replicated;
  * PQ and dense states: the kv-head dimension (``phi`` [L, H_kv·S, 1, 1]
    is head-major, so its groups split with their heads).

A batched state is folded [L, B·H_kv, ...] (batch-as-heads); ``_unfold``
and ``_fold`` move between that and [L, B, H_kv, ...], where ``dp`` splits
the slots and ``tp`` the heads.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from pqcache_tpu_torch.config import ModelConfig

_LAYER_SPLIT = {"ln1": None, "ln2": None, "wq": 2, "wk": 2, "wv": 2,
                "wo": 1, "gate": 2, "up": 2, "down": 1}


def param_specs(cfg: Optional[ModelConfig] = None) -> dict:
    """The tensor axis's split dimension of every parameter leaf, the LM
    head vocab-sharded (``sharding.param_specs``)."""
    return {"embed": None, "final_norm": None, "lm_head": 1,
            "layers": dict(_LAYER_SPLIT)}


def pq_state_specs(jhist: bool = False, int8_scales: bool = False,
                   ring: bool = False) -> dict:
    """Split dimension of every PQState field (kv heads; the counters and
    the ring's fill count replicated). Fields left out are None."""
    h = 1
    return {"k_sink": h, "v_sink": h, "kv_tail": h, "codes": h,
            "centroids": h, "phi": h, "n_cand": None, "pos": None,
            "jhist": h if jhist else None,
            "k_scale": h if int8_scales else None,
            "v_scale": h if int8_scales else None,
            "ring_kv": h if ring else None, "ring_r": None}


def dense_state_specs(with_scores: bool = False) -> dict:
    """Split dimension of every DenseState field (h2o's scores and mask
    with their heads)."""
    return {"k_cache": 1, "v_cache": 1, "length": None, "start": None,
            "pos": None, "scores": 1 if with_scores else None,
            "mask": 1 if with_scores else None}


def _slice(t: torch.Tensor, dim: int, rank: int, n: int) -> torch.Tensor:
    """Block ``rank`` of ``n`` along ``dim`` as a contiguous copy (the
    kernels take contiguous inputs, and a view would keep the whole
    tensor alive)."""
    if t.shape[dim] % n:
        raise ValueError(f"dimension {dim} of {tuple(t.shape)} does not "
                         f"split {n} ways")
    w = t.shape[dim] // n
    return t.narrow(dim, rank * w, w).clone(
        memory_format=torch.contiguous_format)


def shard_params(params: dict, rank: int, tp: int,
                 specs: Optional[dict] = None) -> dict:
    """This rank's parameters: a contiguous slice of every split leaf (int8
    weights' per-column scales split with their columns), the replicated
    leaves as they are. ``specs``: ``param_specs()`` or the TP engines'
    ``tp_decode.PARAM_SPECS`` (the default)."""
    if specs is None:
        from pqcache_tpu_torch.parallel.tp_decode import PARAM_SPECS
        specs = PARAM_SPECS

    def one(name, t, table):
        if name.endswith("_s"):
            raise ValueError("W8 weights under tensor parallelism are not "
                             "supported: the JAX engines take bf16 only")
        dim = table[name]
        return t if dim is None or tp == 1 else _slice(t, dim, rank, tp)

    out = {k: one(k, v, specs) for k, v in params.items() if k != "layers"}
    out["layers"] = {k: one(k, v, specs["layers"])
                     for k, v in params["layers"].items()}
    return out


def init_params_shard(cfg: ModelConfig, generator: torch.Generator,
                      rank: int, tp: int, dtype=torch.bfloat16,
                      device=None) -> dict:
    """This rank's ``tp_decode.PARAM_SPECS`` shard of ``llama.init_params(
    cfg, generator, dtype, device)``, the same values, drawn one layer's
    matrix at a time: the process never holds the whole model."""
    from pqcache_tpu_torch.models import llama

    def keep(name, w):            # w: one layer's matrix, no layer axis
        dim = _LAYER_SPLIT[name]
        return w if dim is None or tp == 1 else _slice(w, dim - 1, rank, tp)
    return llama.init_params(cfg, generator, dtype=dtype, device=device,
                             layer_slice=keep)


def gather_layer(local: dict, idx: int, comm, specs: Optional[dict] = None
                 ) -> dict:
    """Layer ``idx``'s whole weights rebuilt from the tp group's shards
    (one all-gather per split leaf, this layer only): what a
    sequence-parallel prefill multiplies by, while each process keeps only
    its shard resident. comm None: the layer as it is."""
    if specs is None:
        from pqcache_tpu_torch.parallel.tp_decode import PARAM_SPECS
        specs = PARAM_SPECS
    out = {}
    for k, v in local["layers"].items():
        dim = specs["layers"][k]
        w = v[idx]
        out[k] = (w if comm is None or dim is None
                  else comm.all_gather(w, dim=dim - 1).contiguous())
    return out


def _unfold(t: torch.Tensor, B: int) -> torch.Tensor:
    """[L, B·H, ...] folded -> [L, B, H, ...]."""
    return t.reshape(t.shape[0], B, t.shape[1] // B, *t.shape[2:])


def _fold(t: torch.Tensor) -> torch.Tensor:
    """[L, B, H, ...] -> [L, B·H, ...] batch-as-heads."""
    return t.reshape(t.shape[0], t.shape[1] * t.shape[2], *t.shape[3:])


def shard_state(state, rank: int, tp: int, *, dp_rank: int = 0,
                dp: int = 1, specs: Optional[dict] = None):
    """This rank's slice of a global state (a PQState or DenseState of the
    port, e.g. a JAX state moved across by ``bridge``): kv-head block
    ``rank`` of ``tp`` of every split field, and for a batched state
    (counters [B]) slot block ``dp_rank`` of ``dp`` too. ``specs``: the
    state's table (``pq_state_specs`` by default, with the optional fields
    the state carries)."""
    if specs is None:
        specs = pq_state_specs(jhist=True, int8_scales=True, ring=True)
    cnt = getattr(state, "pos")
    batched = isinstance(cnt, torch.Tensor) and cnt.dim() == 1
    B = cnt.shape[0] if batched else 1
    out = {}
    for f in dataclasses.fields(state):
        v = getattr(state, f.name)
        dim = specs.get(f.name)
        if v is None:
            out[f.name] = None
        elif dim is None:
            if batched and isinstance(v, torch.Tensor) and v.dim() == 1:
                v = _slice(v, 0, dp_rank, dp)
            out[f.name] = v
        elif batched:
            u = _unfold(v, B)
            out[f.name] = _fold(_slice(_slice(u, 1, dp_rank, dp), 2, rank,
                                       tp)).contiguous()
        else:
            out[f.name] = _slice(v, dim, rank, tp)
    return type(state)(**out)
