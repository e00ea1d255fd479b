"""The port's HF checkpoint loader against the JAX package's, on the CPU.

A tiny llama checkpoint is written here with the ``safetensors`` package:
``config.json`` and two shards, the first bf16 (embedding, layer 0), the
second float32 (layer 1, final norm and, in one case, the LM head), so the
loaders convert as well as copy. The port reads the format itself; its
tensors must equal the JAX loader's, moved through ``bridge``, bit for bit
(bf16 and float32 targets). A missing layer tensor raises. Weight-only int8
quantization of the loaded params and ``Engine.generate`` must then give
the JAX Engine's greedy tokens (float32 engines).
"""

import json
import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from safetensors.numpy import save_file

from pqcache_tpu import config as jconfig
from pqcache_tpu.core import quant as jquant
from pqcache_tpu.models import llama as jllama
from pqcache_tpu.models import loader as jloader
from pqcache_tpu.runtime.generate import Engine as JEngine
from pqcache_tpu_torch import bridge, config
from pqcache_tpu_torch.core import quant
from pqcache_tpu_torch.models import loader
from pqcache_tpu_torch.runtime.generate import Engine

torch.set_num_threads(1)

_HF = {"wq": "self_attn.q_proj.weight", "wk": "self_attn.k_proj.weight",
       "wv": "self_attn.v_proj.weight", "wo": "self_attn.o_proj.weight",
       "gate": "mlp.gate_proj.weight", "up": "mlp.up_proj.weight",
       "down": "mlp.down_proj.weight", "ln1": "input_layernorm.weight",
       "ln2": "post_attention_layernorm.weight"}


def _write_checkpoint(path, with_head: bool, drop=None):
    """A 2-layer tiny llama in HF layout: shard 1 bf16, shard 2 float32.
    Returns the JAX model config."""
    cfg = jconfig.tiny_model_config(num_layers=2)
    jp = jax.tree.map(np.asarray, jllama.init_params(
        cfg, jax.random.PRNGKey(11), dtype=jnp.float32))
    os.makedirs(path)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump({"vocab_size": cfg.vocab_size,
                   "hidden_size": cfg.hidden_size,
                   "intermediate_size": cfg.intermediate_size,
                   "num_hidden_layers": cfg.num_layers,
                   "num_attention_heads": cfg.num_heads,
                   "num_key_value_heads": cfg.num_kv_heads,
                   "rms_norm_eps": cfg.rms_norm_eps,
                   "rope_theta": cfg.rope_theta,
                   "max_position_embeddings": cfg.max_position_embeddings,
                   "tie_word_embeddings": not with_head}, f)
    # non-trivial norms, so a transposed or swapped norm would show
    rng = np.random.default_rng(2)
    shards = [{"model.embed_tokens.weight": jp["embed"]}, {
        "model.norm.weight": 1 + 0.1 * rng.normal(size=cfg.hidden_size)}]
    if with_head:
        shards[1]["lm_head.weight"] = jp["lm_head"].T
    for i in range(cfg.num_layers):
        for name, sub in _HF.items():
            w = jp["layers"][name][i]
            if name in ("ln1", "ln2"):
                w = 1 + 0.1 * rng.normal(size=w.shape)
            shards[i][f"model.layers.{i}.{sub}"] = w.T if w.ndim == 2 else w
    if drop:
        del shards[1][drop]
    for n, (sh, dt) in enumerate(zip(shards, (ml_dtypes.bfloat16,
                                              np.float32))):
        save_file({k: np.ascontiguousarray(v).astype(dt)
                   for k, v in sh.items()},
                  os.path.join(path, f"model-0000{n + 1}-of-00002"
                               ".safetensors"))
    return cfg


def _bits(t: torch.Tensor) -> np.ndarray:
    t = t.contiguous()
    return (t.view(torch.int16) if t.dtype == torch.bfloat16
            else t.view(torch.int32)).numpy()


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
@pytest.mark.parametrize("with_head", [True, False], ids=["head", "tied"])
def test_loader_matches_jax_bit_for_bit(tmp_path, with_head, dtype):
    path = str(tmp_path / "ckpt")
    _write_checkpoint(path, with_head)
    jdt, tdt = {"bf16": (jnp.bfloat16, torch.bfloat16),
                "f32": (jnp.float32, torch.float32)}[dtype]
    jcfg, jparams = jloader.load_hf_checkpoint(path, dtype=jdt)
    cfg, params = loader.load_hf_checkpoint(path, dtype=tdt, device="cpu")
    assert cfg == config.ModelConfig(**{
        f: getattr(jcfg, f) for f in jcfg.__dataclass_fields__})
    want = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                    device="cpu")
    assert set(params) == set(want)
    assert set(params["layers"]) == set(want["layers"])
    flat = [(k, params[k], want[k]) for k in params if k != "layers"] + [
        (k, params["layers"][k], want["layers"][k]) for k in want["layers"]]
    for name, got, ref in flat:
        assert got.dtype == tdt and got.shape == ref.shape, name
        np.testing.assert_array_equal(_bits(got), _bits(ref), err_msg=name)
    if not with_head:
        assert torch.equal(params["lm_head"], params["embed"].T)


def test_loader_raises_on_a_missing_layer_tensor(tmp_path):
    path = str(tmp_path / "ckpt")
    _write_checkpoint(path, True, drop="model.layers.1.self_attn.q_proj.weight")
    with pytest.raises(ValueError, match="missing for wq: \\[1\\]"):
        jloader.load_hf_checkpoint(path)
    with pytest.raises(ValueError, match="missing for wq: \\[1\\]"):
        loader.load_hf_checkpoint(path, device="cpu")
    with pytest.raises(FileNotFoundError):
        loader.load_hf_checkpoint(str(tmp_path), cfg=config.tiny_model_config(),
                                  device="cpu")


def test_header_reader_reads_the_format(tmp_path):
    # the reader against the safetensors package's own writer: dtypes,
    # shapes, offsets and the metadata entry it skips
    f = str(tmp_path / "x.safetensors")
    arrays = {"a": np.arange(12, dtype=np.int8).reshape(3, 4),
              "b": np.linspace(-1, 1, 6).astype(np.float16),
              "c": np.arange(5, dtype=np.int64),
              "e": np.zeros((0, 3), np.float32)}
    save_file(arrays, f, metadata={"format": "pt"})
    base, header = loader.read_header(f)
    assert set(header) == set(arrays)
    for k, a in arrays.items():
        t = loader.read_tensor(f, base, header[k])
        assert tuple(t.shape) == a.shape
        np.testing.assert_array_equal(t.numpy(), a)


@pytest.mark.parametrize("policy", ["original", "no_drop_lb"])
def test_loaded_w8_engine_gives_jax_tokens(tmp_path, policy):
    path = str(tmp_path / "ckpt")
    _write_checkpoint(path, True)
    jcfg, jparams = jloader.load_hf_checkpoint(path, dtype=jnp.float32)
    cfg, params = loader.load_hf_checkpoint(path, dtype=torch.float32,
                                            device="cpu")
    jparams, params = (jquant.quantize_weight_tree(jparams),
                       quant.quantize_weight_tree(params))

    def ecfg(mod, m):
        return mod.EngineConfig(
            model=m, budget=mod.BudgetConfig(compress_ratio=0.3,
                                             recent_ratio=0.5, sink_size=4),
            runtime=mod.RuntimeConfig(policy=policy, prefill_bucket=64,
                                      max_new_tokens=16, max_seq_len=1024,
                                      kernels="xla"))
    ids = np.random.default_rng(4).integers(0, cfg.vocab_size, 300)
    want = JEngine(ecfg(jconfig, jcfg), jparams,
                   dtype=jnp.float32).generate(ids, 10)
    got = Engine(ecfg(config, cfg), params, dtype=torch.float32,
                 device="cpu").generate(ids, 10)
    assert got.tokens == want.tokens
