"""Needle-in-a-haystack harness of the port.

Counterpart of ``pqcache_tpu/harness/nah.py`` (the reference's
test_nah.py:17-92). Reads prompts from a jsonl file ({"prompt": ...}),
generates ``--max-new`` tokens with the configured compressor and writes
{"response": ...} lines; without an input file it builds synthetic
haystacks with a planted needle over a context-length x depth grid and
reports retrieval accuracy (a substring match of the needle's payload).

Usage (on the card; add ``--device cpu`` for the CPU):
  python -m pqcache_tpu_torch.harness.nah --checkpoint random:tiny \\
      --compressor pq_search --ctx 4096 8192 --depths 0.1 0.5 0.9
"""

from __future__ import annotations

import argparse
import json

import numpy as np

NEEDLE = ("The best thing to do in San Francisco is eat a sandwich and sit "
          "in Dolores Park on a sunny day.")
QUESTION = "What is the best thing to do in San Francisco?"
FILLER = ("The grass is green. The sky is blue. The sun is warm. "
          "Trees grow tall. Rivers flow to the sea. ")


def build_haystack(tokenizer, ctx_tokens: int, depth: float) -> str:
    filler_ids = tokenizer(FILLER, add_special_tokens=False)["input_ids"]
    reps = max(1, ctx_tokens // max(len(filler_ids), 1) + 1)
    body = FILLER * reps
    ids = tokenizer(body, add_special_tokens=False)["input_ids"][:ctx_tokens]
    cut = int(len(ids) * depth)
    pre = tokenizer.decode(ids[:cut])
    post = tokenizer.decode(ids[cut:])
    return (f"{pre}\n{NEEDLE}\n{post}\n\nBased on the content above, "
            f"answer: {QUESTION}\nAnswer:")


def run(args) -> None:
    from pqcache_tpu_torch.harness.longbench import (load_model,
                                                     make_engine_config)
    from pqcache_tpu_torch.runtime.generate import Engine

    model_cfg, params, tokenizer = load_model(args)
    cfg = make_engine_config(args, model_cfg)
    engine = Engine(cfg, params, device=args.device)
    eos = (tokenizer.eos_token_id,)

    results = []
    if args.input:
        with open(args.input, encoding="utf-8") as f:
            prompts = [json.loads(line).get("prompt", "") for line in f]
        for p in prompts:
            ids = tokenizer(p)["input_ids"]
            res = engine.generate(np.asarray(ids, np.int64),
                                  max_new_tokens=args.max_new, eos_ids=eos)
            text = tokenizer.decode(res.tokens, skip_special_tokens=True)
            results.append({"response": text})
    else:
        hits = 0
        grid = [(c, d) for c in args.ctx for d in args.depths]
        for ctx, depth in grid:
            prompt = build_haystack(tokenizer, ctx, depth)
            ids = tokenizer(prompt)["input_ids"]
            res = engine.generate(np.asarray(ids, np.int64),
                                  max_new_tokens=args.max_new, eos_ids=eos)
            text = tokenizer.decode(res.tokens, skip_special_tokens=True)
            ok = "Dolores" in text or "sandwich" in text
            hits += ok
            row = {"ctx": ctx, "depth": depth, "hit": bool(ok),
                   "response": text[:200]}
            results.append(row)
            print(json.dumps(row), flush=True)
        print(json.dumps({"accuracy": hits / max(len(grid), 1)}))

    if args.out:
        with open(args.out, "w", encoding="utf-8") as f:
            for r in results:
                f.write(json.dumps(r, ensure_ascii=False) + "\n")


def parse_args(argv=None):
    from pqcache_tpu_torch.harness.longbench import add_engine_args
    p = argparse.ArgumentParser()
    add_engine_args(p)
    p.add_argument("--compressor", default="pq_search")
    p.add_argument("--metric", default="euc")
    p.add_argument("--max-new", dest="max_new", type=int, default=128)
    p.add_argument("--input", default=None)
    p.add_argument("--out", default=None)
    p.add_argument("--ctx", type=int, nargs="*", default=[4096, 8192, 16384])
    p.add_argument("--depths", type=float, nargs="*",
                   default=[0.1, 0.5, 0.9])
    return p.parse_args(argv)


if __name__ == "__main__":
    run(parse_args())
