"""GSM8K many-shot evaluation of the port.

Counterpart of ``pqcache_tpu/harness/gsm8k.py`` (the reference's
GSM8k/evaluation_gsm8k.py): an n-shot prompt from the train split, greedy
generation with the configured compressor, scored by last-number match
(evaluation_gsm8k.py:67-86). Reads local gsm8k jsonl files
({"question", "answer"}) through ``--train`` / ``--test``.

Usage (on the card; add ``--device cpu`` for the CPU):
  python -m pqcache_tpu_torch.harness.gsm8k --checkpoint /path/to/hf_dir \\
      --train train.jsonl --test test.jsonl --shots 64
"""

from __future__ import annotations

import argparse
import json
import re

import numpy as np


def extract_last_number(s: str):
    s = s.replace(",", "")
    nums = re.findall(r"\d*\.?\d+", s)
    return float(nums[-1]) if nums else None


def answer_correct(pred: str, gold: str) -> bool:
    p, g = extract_last_number(pred), extract_last_number(gold)
    return p is not None and g is not None and p == g


def build_prompt(shots, question) -> str:
    parts = []
    for s in shots:
        parts.append(f"Question: {s['question']}\nAnswer: {s['answer']}\n")
    parts.append(f"Question: {question}\nAnswer:")
    return "\n".join(parts)


def run(args) -> None:
    from pqcache_tpu_torch.harness.longbench import (load_model,
                                                     make_engine_config)
    from pqcache_tpu_torch.runtime.generate import Engine

    model_cfg, params, tokenizer = load_model(args)
    cfg = make_engine_config(args, model_cfg)
    engine = Engine(cfg, params, device=args.device)
    eos = (tokenizer.eos_token_id,)

    with open(args.train, encoding="utf-8") as f:
        train = [json.loads(line) for line in f][: args.shots]
    with open(args.test, encoding="utf-8") as f:
        test = [json.loads(line) for line in f]
    if args.limit:
        test = test[: args.limit]

    correct = 0
    for i, sample in enumerate(test):
        prompt = build_prompt(train, sample["question"])
        ids = tokenizer(prompt)["input_ids"]
        res = engine.generate(np.asarray(ids, np.int64),
                              max_new_tokens=args.max_new, eos_ids=eos)
        pred = tokenizer.decode(res.tokens, skip_special_tokens=True)
        pred = pred.split("Question:")[0]  # stop at the next few-shot turn
        ok = answer_correct(pred, sample["answer"])
        correct += ok
        if args.out:
            with open(args.out, "a", encoding="utf-8") as f:
                json.dump({"idx": i, "pred": pred, "gold": sample["answer"],
                           "correct": bool(ok)}, f, ensure_ascii=False)
                f.write("\n")
    acc = correct / max(len(test), 1)
    print(json.dumps({"accuracy": acc, "n": len(test),
                      "shots": args.shots}))


def parse_args(argv=None):
    from pqcache_tpu_torch.harness.longbench import add_engine_args
    p = argparse.ArgumentParser()
    add_engine_args(p)
    p.add_argument("--train", required=True)
    p.add_argument("--test", required=True)
    p.add_argument("--shots", type=int, default=64)
    p.add_argument("--limit", type=int, default=0)
    p.add_argument("--max-new", dest="max_new", type=int, default=256)
    p.add_argument("--out", default=None)
    p.add_argument("--compressor", default="pq_search")
    p.add_argument("--metric", default="euc")
    return p.parse_args(argv)


if __name__ == "__main__":
    run(parse_args())
