"""HF checkpoint loading: safetensors shards -> the port's stacked params.

Counterpart of ``pqcache_tpu/models/loader.py``. Reads the ``*.safetensors``
shards of a llama/mistral-family HF directory itself, without the
``safetensors`` package: each shard is an 8-byte little-endian header
length, a JSON header giving every tensor's ``dtype``, ``shape`` and
``data_offsets`` (relative to the end of the header), then the raw
little-endian bytes. Linear weights are transposed to [in, out] as
``_LAYER_KEYS`` says and stacked into [L, ...] tensors on the device; the
LM head is tied (``embed.T``) when ``lm_head.weight`` is absent.

Tensors are read one at a time, in the file's dtype, straight into the
stacked buffers on the device (each converted there to the target dtype):
at full width the host holds one tensor's bytes at a time and no float32
copy of the model exists anywhere. A bf16 file loaded as bf16 is copied bit
for bit; other dtypes convert with round-to-nearest-even, as the JAX
loader's ``jnp.asarray(a, dtype)`` does.
"""

from __future__ import annotations

import json
import os
import struct
import sys
from typing import Optional

import torch

from pqcache_tpu_torch import resolve_device
from pqcache_tpu_torch.config import ModelConfig

_LAYER_KEYS = {
    "self_attn.q_proj.weight": ("wq", True),
    "self_attn.k_proj.weight": ("wk", True),
    "self_attn.v_proj.weight": ("wv", True),
    "self_attn.o_proj.weight": ("wo", True),
    "mlp.gate_proj.weight": ("gate", True),
    "mlp.up_proj.weight": ("up", True),
    "mlp.down_proj.weight": ("down", True),
    "input_layernorm.weight": ("ln1", False),
    "post_attention_layernorm.weight": ("ln2", False),
}

# safetensors dtype names -> torch dtypes
_DTYPES = {
    "BF16": torch.bfloat16, "F16": torch.float16, "F32": torch.float32,
    "F64": torch.float64, "I8": torch.int8, "U8": torch.uint8,
    "I16": torch.int16, "I32": torch.int32, "I64": torch.int64,
    "BOOL": torch.bool,
}


def load_hf_config(path: str) -> ModelConfig:
    with open(os.path.join(path, "config.json")) as f:
        return ModelConfig.from_hf_config(json.load(f),
                                          name=os.path.basename(path))


def read_header(file: str) -> tuple[int, dict]:
    """(offset of the data section, {name: (dtype, shape, (begin, end))})
    of one safetensors file."""
    with open(file, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
    header.pop("__metadata__", None)
    return 8 + n, {k: (v["dtype"], tuple(v["shape"]),
                       tuple(v["data_offsets"])) for k, v in header.items()}


def read_tensor(file: str, base: int, entry) -> torch.Tensor:
    """One tensor of a shard as a CPU tensor in the file's dtype (a copy of
    its bytes)."""
    dtype, shape, (begin, end) = entry
    if dtype not in _DTYPES:
        raise ValueError(f"{file}: unsupported safetensors dtype {dtype}")
    buf = bytearray(end - begin)
    with open(file, "rb") as f:
        f.seek(base + begin)
        if f.readinto(buf) != len(buf):
            raise ValueError(f"{file}: truncated tensor data")
    if not buf:
        return torch.empty(shape, dtype=_DTYPES[dtype])
    return torch.frombuffer(buf, dtype=_DTYPES[dtype]).reshape(shape)


def load_hf_checkpoint(path: str, cfg: Optional[ModelConfig] = None,
                       dtype=torch.bfloat16, device=None
                       ) -> tuple[ModelConfig, dict]:
    """Load a llama/mistral-family HF checkpoint directory onto ``device``
    (cuda unless given). Returns (config, params) in the layout of
    ``models/llama.init_params``. Raises when a layer tensor is missing."""
    if sys.byteorder != "little":
        raise RuntimeError("safetensors data is little-endian")
    device = resolve_device(device)
    cfg = cfg or load_hf_config(path)
    L = cfg.num_layers
    shards = sorted(f for f in os.listdir(path) if f.endswith(".safetensors"))
    if not shards:
        raise FileNotFoundError(f"no safetensors shards in {path}")

    # where each tensor lives: name -> (file, data offset, header entry)
    index: dict = {}
    for shard in shards:
        file = os.path.join(path, shard)
        base, header = read_header(file)
        for name, entry in header.items():
            index[name] = (file, base, entry)

    def load(name, transpose=False):
        file, base, entry = index[name]
        t = read_tensor(file, base, entry).to(device)
        return (t.T if transpose else t).to(dtype)

    params: dict = {"layers": {}}
    for name, key in (("embed", "model.embed_tokens.weight"),
                      ("final_norm", "model.norm.weight")):
        if key not in index:
            raise ValueError(f"{path}: {key} missing")
        params[name] = load(key).contiguous()
    if "lm_head.weight" in index:
        params["lm_head"] = load("lm_head.weight", transpose=True).contiguous()
    for sub, (name, tr) in _LAYER_KEYS.items():
        keys = [f"model.layers.{i}.{sub}" for i in range(L)]
        missing = [i for i, k in enumerate(keys) if k not in index]
        if missing:
            raise ValueError(f"layer tensors missing for {name}: {missing}")
        first = load(keys[0], tr)
        out = torch.empty((L, *first.shape), dtype=dtype, device=device)
        out[0] = first
        del first
        for i in range(1, L):
            out[i] = load(keys[i], tr)
        params["layers"][name] = out
    if "lm_head" not in params:
        params["lm_head"] = params["embed"].T.contiguous()   # tied
    return cfg, params
