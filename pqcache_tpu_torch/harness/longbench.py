"""LongBench v1 evaluation harness of the port.

Counterpart of ``pqcache_tpu/harness/longbench.py`` (the reference's
vq_pred.py, eval.py and parse_result.py): chat-template formatting, middle
truncation to the model's max length, greedy generation through the port's
``Engine``, resumable per-sample jsonl output named by the config string,
host sharding, and the scoring and aggregation step. The JSON tables
(prompts, generation lengths, model lengths) are the port's own copies in
``pqcache_tpu_torch/configs``.

Usage (on the card; ``--device cpu`` runs the plain versions on the CPU):
  python -m pqcache_tpu_torch.harness.longbench predict \\
      --model llama-3.1 --checkpoint /path/to/hf_dir \\
      --compressor pq_search --compress-ratio 0.1 \\
      --datasets trec triviaqa --data-dir ./data --out-dir ./pred
  python -m pqcache_tpu_torch.harness.longbench score --pred-dir ./pred

``--checkpoint random:tiny`` or ``random:<preset>`` (a ``MODEL_PRESETS``
name) gives random weights from a seeded generator on the device and the
asset-free whitespace tokenizer; an HF directory goes through
``models/loader.py`` and a ``transformers`` tokenizer.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
import zlib

import numpy as np

from pqcache_tpu_torch.config import (BudgetConfig, CacheConfig, EngineConfig,
                                      ModelConfig, PQConfig, RuntimeConfig)
from pqcache_tpu_torch.harness.metrics import (DATASET2METRIC,
                                               PAPER_DATASETS, scorer,
                                               scorer_e)

_CFG_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "configs")


def _load_json(name):
    with open(os.path.join(_CFG_DIR, name)) as f:
        return json.load(f)


def build_chat(tokenizer, prompt: str, model_name: str) -> str:
    """Chat-template formatting (vq_pred.py:63-97, llama/mistral branches)."""
    if "llama" in model_name and "3" in model_name:
        messages = [
            {"role": "system", "content": "You are a helpful assistant."},
            {"role": "user", "content": prompt},
        ]
        return tokenizer.apply_chat_template(
            messages, tokenize=False, add_generation_prompt=True)
    if "llama" in model_name or "mistral" in model_name:
        return f"[INST]{prompt}[/INST]"
    return prompt


# datasets whose prompts are used raw (vq_pred.py:148)
_NO_CHAT = {"trec", "triviaqa", "samsum", "lsht", "lcc", "repobench-p"}


def middle_truncate(tokenizer, prompt: str, max_length: int):
    """Middle truncation, keeping head and tail halves (vq_pred.py:142-146).
    Returns (prompt, its token count, capped at max_length)."""
    ids = tokenizer(prompt, truncation=False, return_tensors=None,
                    add_special_tokens=True)["input_ids"]
    if len(ids) <= max_length:
        return prompt, len(ids)
    half = max_length // 2
    head = tokenizer.decode(ids[:half], skip_special_tokens=True)
    tail = tokenizer.decode(ids[-half:], skip_special_tokens=True)
    return head + tail, max_length


def make_engine_config(args, model_cfg: ModelConfig) -> EngineConfig:
    """EngineConfig from a harness argparse namespace. Knobs that the
    leaner NAH and GSM8K command lines do not expose take the LongBench
    command line's defaults."""
    g = lambda name, default: getattr(args, name, default)  # noqa: E731
    return EngineConfig(
        model=model_cfg,
        pq=PQConfig(
            n_subvec_per_head=args.n_subvec_per_head,
            n_subbits=args.n_subbits,
            metric=args.metric,
            kmeans_iters=args.max_iter if args.max_iter > 0 else 8,
            select_block=g("select_block", 1),
        ),
        budget=BudgetConfig(
            compress_ratio=args.compress_ratio,
            recent_ratio=args.recent_ratio,
            sink_size=args.sink_size,
        ),
        cache=CacheConfig(
            offload=g("offload", False),
            block_size=g("cache_block_size", 128),
            hbm_cache_tokens=g("global_cache_size", 4096),
            cache_topk_blocks=g("cache_topk", 32),
            kv_dtype=g("kv_dtype", "bf16"),
        ),
        runtime=RuntimeConfig(
            policy=args.compressor,
            prefill_bucket=args.prefill_bucket,
            max_new_tokens=512,
            max_seq_len=args.max_seq_len,
            gqa=args.gqa,
            sparq_topr=args.topr,
            important_ratio=args.important_ratio,
            prefill_chunk=g("prefill_chunk", 0),
            temperature=g("temperature", 0.0),
            top_k=g("top_k", 0),
            top_p=g("top_p", 1.0),
            sample_seed=g("sample_seed", 0),
        ),
    )


class WhitespaceTokenizer:
    """Asset-free tokenizer (crc32-bucketed whitespace tokens), so that the
    whole predict pipeline runs without downloaded checkpoints. crc32, not
    Python's salted hash(): resume-by-line-count needs the same ids in
    every process."""

    eos_token_id = 1

    def __init__(self, vocab_size: int):
        self.vocab_size = vocab_size

    def __call__(self, text, **kw):
        ids = [2 + (zlib.crc32(w.encode("utf-8")) % (self.vocab_size - 2))
               for w in text.split()]
        return {"input_ids": ids or [2]}

    def decode(self, ids, **kw):
        return " ".join(f"w{int(i)}" for i in ids)

    def apply_chat_template(self, messages, **kw):
        return " ".join(m["content"] for m in messages)


def load_model(args):
    """(model config, params on the device, tokenizer). checkpoint = an HF
    directory, or 'random:tiny' / 'random:<preset>' for random weights
    (seed 0) with the whitespace tokenizer."""
    import torch

    from pqcache_tpu_torch import resolve_device
    device = resolve_device(getattr(args, "device", None))
    if args.checkpoint.startswith("random:"):
        from pqcache_tpu_torch.config import MODEL_PRESETS, tiny_model_config
        from pqcache_tpu_torch.models import llama

        name = args.checkpoint.split(":", 1)[1]
        model_cfg = (tiny_model_config() if name == "tiny"
                     else MODEL_PRESETS[name])
        params = llama.init_params(
            model_cfg, torch.Generator(device=device).manual_seed(0),
            device=device)
        return model_cfg, params, WhitespaceTokenizer(model_cfg.vocab_size)
    from transformers import AutoTokenizer

    from pqcache_tpu_torch.models.loader import load_hf_checkpoint

    model_cfg, params = load_hf_checkpoint(args.checkpoint, device=device)
    tokenizer = AutoTokenizer.from_pretrained(args.checkpoint, use_fast=True)
    return model_cfg, params, tokenizer


def predict(args) -> None:
    from pqcache_tpu_torch.runtime.generate import Engine

    model2maxlen = _load_json("model2maxlen.json")
    dataset2prompt = _load_json("dataset2prompt.json")
    dataset2maxlen = _load_json("dataset2maxlen.json")

    max_length = model2maxlen.get(args.model, args.max_seq_len)
    model_cfg, params, tokenizer = load_model(args)
    if getattr(args, "weight_int8", False):
        # the weight-only int8 quality arm (core/quant.quantize_weight_tree)
        from pqcache_tpu_torch.core import quant
        params = quant.quantize_weight_tree(params)
    cfg = make_engine_config(args, model_cfg)
    engine = Engine(cfg, params, device=getattr(args, "device", None))
    eos_ids = tuple(tokenizer.eos_token_id
                    if isinstance(tokenizer.eos_token_id, (list, tuple))
                    else [tokenizer.eos_token_id])

    config_str = "_".join(cfg.config_str_list())
    if getattr(args, "weight_int8", False):
        config_str += "_w8"   # the W8 arm's output files apart
    for dataset in args.datasets or PAPER_DATASETS:
        data_path = os.path.join(args.data_dir, f"{dataset}.jsonl")
        if not os.path.exists(data_path):
            print(f"[skip] {data_path} not found", file=sys.stderr)
            continue
        out_dir = os.path.join(args.out_dir, args.model, dataset,
                               args.exp_name)
        os.makedirs(out_dir, exist_ok=True)
        suffix = f".shard{args.shard.replace('/', 'of')}" if args.shard else ""
        out_path = os.path.join(out_dir, f"{config_str}{suffix}.jsonl")

        # resume by line count (vq_pred.py:118-129)
        done = 0
        if os.path.exists(out_path):
            with open(out_path, encoding="utf-8") as f:
                done = sum(1 for _ in f)

        prompt_format = dataset2prompt[dataset]
        max_gen = dataset2maxlen[dataset]
        n_tokens_out, t_start = 0, time.perf_counter()
        with open(data_path, encoding="utf-8") as f:
            samples = [json.loads(line) for line in f]
        if args.limit:
            samples = samples[:args.limit]
        if args.shard:
            # host-sharded evaluation (InfLLM/benchmark/pred.py:18-19)
            rank, world = map(int, args.shard.split("/"))
            samples = samples[rank::world]
        for i, obj in enumerate(samples):
            if i < done:
                continue
            prompt = prompt_format.format(**obj)
            prompt, n_ctx = middle_truncate(tokenizer, prompt, max_length)
            if dataset not in _NO_CHAT:
                prompt = build_chat(tokenizer, prompt, args.model)
            ids = tokenizer(prompt, truncation=False,
                            add_special_tokens=True)["input_ids"]
            res = engine.generate(np.asarray(ids, np.int64),
                                  max_new_tokens=max_gen, eos_ids=eos_ids)
            toks = [t for t in res.tokens if t not in eos_ids]
            pred = tokenizer.decode(toks, skip_special_tokens=True)
            n_tokens_out += len(res.tokens)
            with open(out_path, "a", encoding="utf-8") as f:
                json.dump({"pred": pred, "answers": obj.get("answers"),
                           "all_classes": obj.get("all_classes"),
                           "length": obj.get("length"),
                           "input_tokens": int(n_ctx),
                           "policy": res.policy_name}, f, ensure_ascii=False)
                f.write("\n")
        dt = time.perf_counter() - t_start
        print(f"[{dataset}] {len(samples) - done} samples, "
              f"{n_tokens_out} tokens in {dt:.1f}s")


def score(args) -> None:
    """Score the prediction jsonl files into result.json (eval.py:79-122)."""
    results = {}
    for root, _, files in os.walk(args.pred_dir):
        for fn in files:
            if not fn.endswith(".jsonl"):
                continue
            # path layout: <out>/<model>/<dataset>/<exp>/<config>.jsonl
            parts = os.path.normpath(os.path.join(root, fn)).split(os.sep)
            if len(parts) < 3:
                continue
            dataset = parts[-3]
            if dataset not in DATASET2METRIC:
                continue
            preds, answers, lengths, classes = [], [], [], None
            with open(os.path.join(root, fn), encoding="utf-8") as f:
                for line in f:
                    o = json.loads(line)
                    preds.append(o["pred"])
                    answers.append(o["answers"])
                    lengths.append(o.get("length") or o.get("input_tokens", 0))
                    classes = o.get("all_classes")
            if getattr(args, "e", False):
                # LongBench-E length-bucketed scoring (eval.py:50-66)
                val = scorer_e(dataset, preds, answers, lengths, classes)
            else:
                val = scorer(dataset, preds, answers, classes)
            results.setdefault(fn[:-6], {})[dataset] = val
    for config_str, per_ds in sorted(results.items()):
        vals = list(per_ds.values())
        if vals and isinstance(vals[0], dict):  # scorer_e buckets
            per_ds["__avg__"] = {
                b: round(sum(v[b] for v in vals) / len(vals), 2)
                for b in ("0-4k", "4-8k", "8k+")}
        else:
            per_ds["__avg__"] = round(sum(vals) / max(len(vals), 1), 2)
    out = os.path.join(args.pred_dir, "result.json")
    with open(out, "w") as f:
        json.dump(results, f, indent=2, ensure_ascii=False)
    print(json.dumps(results, indent=2, ensure_ascii=False))


def add_engine_args(p: argparse.ArgumentParser) -> None:
    """The engine flags that the LongBench, NAH and GSM8K command lines
    share, with their defaults."""
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--compress-ratio", dest="compress_ratio", type=float,
                   default=0.1)
    p.add_argument("--recent-ratio", dest="recent_ratio", type=float,
                   default=0.5)
    p.add_argument("--important-ratio", dest="important_ratio", type=float,
                   default=0.5)
    p.add_argument("--sink-size", dest="sink_size", type=int, default=32)
    p.add_argument("--n-subvec-per-head", type=int, default=2)
    p.add_argument("--n-subbits", type=int, default=6)
    p.add_argument("--max-iter", dest="max_iter", type=int, default=0)
    p.add_argument("--topr", type=int, default=32)
    p.add_argument("--gqa", type=lambda s: s == "True", default=True)
    p.add_argument("--max-seq-len", dest="max_seq_len", type=int,
                   default=33000)
    p.add_argument("--prefill-bucket", type=int, default=2048)
    p.add_argument("--device", default=None,
                   help="cuda unless given (cpu runs the plain versions)")


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    sub = p.add_subparsers(dest="cmd", required=True)

    pp = sub.add_parser("predict")
    add_engine_args(pp)
    pp.add_argument("--model", default="llama-3.1")
    pp.add_argument("--compressor", default="pq_search",
                    choices=["original", "pq_search", "h2o", "no_drop_lb",
                             "sparq_f", "infllm"])
    pp.add_argument("--metric", default="euc", choices=["euc", "ip"])
    pp.add_argument("--select-block", dest="select_block", type=int,
                    default=1,
                    help="retrieval granularity: 1 = per-token top-k "
                         "(reference parity), >1 = block-granular "
                         "(joint-histogram scorer when S=2)")
    # host-offload tier knobs (vq_pred.py:253-257 cache geometry)
    pp.add_argument("--offload", action="store_true",
                    help="host-offload tier: KV in pinned host memory and "
                         "a device block cache")
    pp.add_argument("--cache-block-size", type=int, default=128)
    pp.add_argument("--global-cache-size", type=int, default=4096)
    pp.add_argument("--cache-topk", type=int, default=32)
    pp.add_argument("--temperature", type=float, default=0.0,
                    help="0 = greedy (the reference protocol); >0 samples")
    pp.add_argument("--top-k", dest="top_k", type=int, default=0)
    pp.add_argument("--top-p", dest="top_p", type=float, default=1.0)
    pp.add_argument("--sample-seed", dest="sample_seed", type=int, default=0)
    pp.add_argument("--weight-int8", dest="weight_int8",
                    action="store_true",
                    help="weight-only int8 "
                         "(core/quant.quantize_weight_tree)")
    pp.add_argument("--kv-dtype", dest="kv_dtype", default="bf16",
                    choices=["bf16", "int8"],
                    help="KV-tail storage dtype; int8 halves the tail "
                         "(per-channel scales, core/quant.py)")
    pp.add_argument("--prefill-chunk", type=int, default=0,
                    help="chunked prefill slab in tokens; 0 = one pass")
    pp.add_argument("--datasets", nargs="*", default=None)
    pp.add_argument("--data-dir", default="./data")
    pp.add_argument("--out-dir", default="./pred")
    pp.add_argument("--exp-name", default="default_exp")
    pp.add_argument("--limit", type=int, default=0)
    pp.add_argument("--shard", default="",
                    help="'rank/world' host-sharded evaluation")
    pp.set_defaults(fn=predict)

    sp = sub.add_parser("score")
    sp.add_argument("--pred-dir", required=True)
    sp.add_argument("--e", action="store_true",
                    help="LongBench-E length-bucketed scoring (eval.py --e)")
    sp.set_defaults(fn=score)
    return p.parse_args(argv)


def main(argv=None):
    a = parse_args(argv)
    a.fn(a)


if __name__ == "__main__":
    main()
