"""The port's evaluation harnesses against the JAX package's, on the CPU.

The port keeps its own copies of the LongBench metrics and JSON tables;
over a table of (prediction, answer) strings every metric must score as
the JAX package's does, and the tables must equal the repository's
``configs/``. The LongBench command line runs predict, a resume that
writes nothing, and score with ``--device cpu`` (``random:tiny`` weights,
the whitespace tokenizer). With the JAX package's random weights moved
into the port's ``load_model`` through ``bridge``, the `original` policy's
prediction lines must equal the JAX command line's, line for line (both
engines greedy in float32: in bf16 the two summation orders round apart
and part the free-running predictions after about 20 tokens). Then the config-string naming, middle
truncation, and the NAH grid and GSM8K pipelines end to end.
``torch.set_num_threads(1)``: the suite runs with several workers.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pqcache_tpu import config as jconfig
from pqcache_tpu.harness import longbench as jlb
from pqcache_tpu.harness import metrics as JM
from pqcache_tpu.models import llama as jllama
from pqcache_tpu_torch import bridge, config
from pqcache_tpu_torch.harness import gsm8k, longbench as lb, metrics as M
from pqcache_tpu_torch.harness import nah

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (prediction, ground truth, all_classes)
PAIRS = [
    ("the answer is Paris", "Paris", None),
    ("Paris", "Paris", None),
    ("", "Paris", None),
    ("The Eiffel Tower, in Paris!", "the eiffel tower", None),
    ("a cat sat on the mat", "the cat sat on a mat", None),
    ("This is about sports", "sports", ["sports", "politics"]),
    ("sports and politics", "sports", ["sports", "politics"]),
    ("none of these", "sports", ["sports"]),
    ("there are 5 passages", "5", None),
    ("3 or 5", "5", None),
    ("Paragraph 7", "Paragraph 7", None),
    ("see 3 and 7", "Paragraph 7", None),
    ("段落3", "段落3", None),
    ("答案是北京。", "北京", None),
    ("# comment\nreturn x + 1", "return x + 1", None),
    ("```\ndef f():\n    return 2", "def f():", None),
]
METRICS = ["qa_f1_score", "qa_f1_zh_score", "rouge_score", "rouge_zh_score",
           "classification_score", "retrieval_score", "retrieval_zh_score",
           "count_score", "code_sim_score"]


@pytest.mark.parametrize("metric", METRICS)
def test_metrics_match_jax(metric):
    for pred, gt, classes in PAIRS:
        assert getattr(M, metric)(pred, gt, all_classes=classes) == \
            getattr(JM, metric)(pred, gt, all_classes=classes), (pred, gt)


def test_scorers_and_tables_match_jax():
    assert M.PAPER_DATASETS == JM.PAPER_DATASETS
    assert {k: v.__name__ for k, v in M.DATASET2METRIC.items()} == \
        {k: v.__name__ for k, v in JM.DATASET2METRIC.items()}
    preds = [p for p, _, _ in PAIRS]
    answers = [[gt] for _, gt, _ in PAIRS]
    lengths = [1000 * (i % 10) for i in range(len(PAIRS))]
    for ds in ("qasper", "trec", "samsum", "passage_count", "lcc",
               "multifieldqa_zh", "passage_retrieval_zh"):
        classes = ["sports", "politics"]
        assert M.scorer(ds, preds, answers, classes) == JM.scorer(
            ds, preds, answers, classes), ds
        assert M.scorer_e(ds, preds, answers, lengths, classes) == \
            JM.scorer_e(ds, preds, answers, lengths, classes), ds
    for name in ("dataset2maxlen.json", "dataset2prompt.json",
                 "model2maxlen.json", "model2path.json"):
        with open(os.path.join(ROOT, "configs", name)) as f:
            assert lb._load_json(name) == json.load(f), name


def _data(tmp_path):
    """trec (raw prompts, classification) and passage_count (chat
    template, count) samples, some past the 256-token model length."""
    rng = np.random.default_rng(0)
    words = ["alpha", "beta", "gamma", "delta", "sports", "politics"]
    d = tmp_path / "data"
    os.makedirs(d)
    with open(d / "trec.jsonl", "w") as f:
        for i in range(3):
            ctx = " ".join(rng.choice(words, size=100 + 150 * i))
            f.write(json.dumps({"input": f"question {i}", "context": ctx,
                                "answers": ["sports"],
                                "all_classes": ["sports", "politics"],
                                "length": 100 + 150 * i}) + "\n")
    with open(d / "passage_count.jsonl", "w") as f:
        for i in range(2):
            ctx = " ".join(rng.choice(words, size=300))
            f.write(json.dumps({"context": ctx, "answers": [str(i + 3)],
                                "length": 300}) + "\n")
    return d


def _predict_argv(tmp_path, policy, *extra):
    return ["predict", "--checkpoint", "random:tiny", "--model", "tiny",
            "--compressor", policy, "--compress-ratio", "0.3",
            "--sink-size", "4", "--n-subbits", "4", "--max-seq-len", "256",
            "--prefill-bucket", "64", "--datasets", "trec", "passage_count",
            "--data-dir", str(tmp_path / "data"),
            "--out-dir", str(tmp_path / "pred"), *extra]


def _lines(path):
    with open(path, encoding="utf-8") as f:
        return [json.loads(line) for line in f]


def test_longbench_predict_resume_score_on_the_cpu(tmp_path, capsys):
    _data(tmp_path)
    for policy, extra in (("pq_search", ("--metric", "ip")),
                          ("no_drop_lb", ()), ("sparq_f", ()),
                          ("pq_search", ("--gqa", "False"))):
        lb.main(_predict_argv(tmp_path, policy, "--device", "cpu", *extra))
    files = sorted((tmp_path / "pred").rglob("*.jsonl"))
    # one file per configuration and dataset (gqa is in the name)
    assert len(files) == 4 * 2
    for f in files:
        rows = _lines(f)
        assert len(rows) == (3 if "trec" in str(f) else 2)
        assert all(set(r) == {"pred", "answers", "all_classes", "length",
                              "input_tokens", "policy"} for r in rows)
        assert max(r["input_tokens"] for r in rows) <= 256
    trec = _lines(next(f for f in files if "trec" in str(f)))
    assert trec[-1]["input_tokens"] == 256        # middle-truncated
    # resume: a second run writes nothing
    capsys.readouterr()
    lb.main(_predict_argv(tmp_path, "no_drop_lb", "--device", "cpu"))
    assert "[trec] 0 samples" in capsys.readouterr().out
    assert sorted((tmp_path / "pred").rglob("*.jsonl")) == files
    lb.main(["score", "--pred-dir", str(tmp_path / "pred")])
    result = json.load(open(tmp_path / "pred" / "result.json"))
    assert set(result) == {f.name[:-6] for f in files}
    for per_ds in result.values():
        assert set(per_ds) == {"trec", "passage_count", "__avg__"}
    lb.main(["score", "--pred-dir", str(tmp_path / "pred"), "--e"])
    result = json.load(open(tmp_path / "pred" / "result.json"))
    assert all(set(v["__avg__"]) == {"0-4k", "4-8k", "8k+"}
               for v in result.values())


def test_longbench_original_lines_match_jax(tmp_path, monkeypatch):
    # the JAX command line's random:tiny weights (float32), moved into the
    # port; both command lines' engines in float32
    from pqcache_tpu.runtime import generate as jgenerate
    from pqcache_tpu_torch.runtime import generate
    _data(tmp_path)
    jparams = jllama.init_params(jconfig.tiny_model_config(),
                                 jax.random.PRNGKey(0), dtype=jnp.float32)
    params = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                      device="cpu")
    own, jown = lb.load_model, jlb.load_model
    monkeypatch.setattr(lb, "load_model",
                        lambda args: (*own(args)[:1], params, own(args)[2]))
    monkeypatch.setattr(jlb, "load_model",
                        lambda args: (*jown(args)[:1], jparams,
                                      jown(args)[2]))
    JEng, Eng = jgenerate.Engine, generate.Engine
    monkeypatch.setattr(jgenerate, "Engine", lambda cfg, p: JEng(
        cfg, p, dtype=jnp.float32))
    monkeypatch.setattr(generate, "Engine", lambda cfg, p, device: Eng(
        cfg, p, dtype=torch.float32, device=device))
    jargs = jlb.parse_args(_predict_argv(tmp_path / "jax", "original")[:-4]
                           + ["--data-dir", str(tmp_path / "data"),
                              "--out-dir", str(tmp_path / "jax")])
    jargs.fn(jargs)
    lb.main(_predict_argv(tmp_path, "original", "--device", "cpu"))
    for ds, n in (("trec", 3), ("passage_count", 2)):
        rel = os.path.join("tiny", ds, "default_exp", "original.jsonl")
        got = _lines(tmp_path / "pred" / rel)
        assert len(got) == n and got == _lines(tmp_path / "jax" / rel), ds


def test_config_str_and_middle_truncation():
    tok = lb.WhitespaceTokenizer(256)
    jtok = jlb.WhitespaceTokenizer(256)
    text = " ".join(f"t{i}" for i in range(100))
    assert tok(text) == jtok(text)
    assert lb.middle_truncate(tok, text, 40) == jlb.middle_truncate(
        jtok, text, 40)
    out, n = lb.middle_truncate(tok, text, 40)
    # head and tail halves joined as JAX joins them (the decoded halves
    # meet without a space)
    assert n == 40 and out.startswith("w") and len(out.split()) == 39
    assert lb.middle_truncate(tok, text, 200) == (text, 100)
    for model in ("llama-3.1", "mistral-7b-Instruct-32k", "tiny"):
        assert lb.build_chat(tok, "hi", model) == jlb.build_chat(jtok, "hi",
                                                                 model)
    for policy in ("original", "pq_search", "sparq_f", "no_drop_lb", "h2o"):
        for extra in ([], ["--gqa", "False"], ["--topr", "8"]):
            argv = ["predict", "--checkpoint", "random:tiny",
                    "--compressor", policy, *extra]
            cfg = lb.make_engine_config(lb.parse_args(argv),
                                        config.tiny_model_config())
            jcfg = jlb.make_engine_config(jlb.parse_args(argv),
                                          jconfig.tiny_model_config())
            assert cfg.config_str_list() == jcfg.config_str_list()
            assert json.loads(cfg.to_json()) == json.loads(jcfg.to_json())
    cfg = lb.make_engine_config(lb.parse_args(
        ["predict", "--checkpoint", "x", "--compress-ratio", "0.1"]),
        config.tiny_model_config())
    s = "_".join(cfg.config_str_list())
    assert "budget_0.1" in s and "subvec_2" in s and "mode_pq_search" in s


def test_nah_grid_end_to_end(tmp_path, capsys):
    out = tmp_path / "nah.jsonl"
    nah.run(nah.parse_args([
        "--checkpoint", "random:tiny", "--device", "cpu",
        "--compressor", "pq_search", "--compress-ratio", "0.3",
        "--sink-size", "4", "--n-subbits", "4", "--max-seq-len", "512",
        "--prefill-bucket", "64", "--max-new", "4", "--ctx", "150", "300",
        "--depths", "0.25", "0.75", "--out", str(out)]))
    lines = capsys.readouterr().out.strip().splitlines()
    rows = [json.loads(line) for line in lines[:-1]]
    assert [(r["ctx"], r["depth"]) for r in rows] == [
        (150, 0.25), (150, 0.75), (300, 0.25), (300, 0.75)]
    acc = json.loads(lines[-1])["accuracy"]
    assert acc == sum(r["hit"] for r in rows) / 4
    assert len(_lines(out)) == 4
    # the haystack is the JAX harness's
    from pqcache_tpu.harness import nah as jnah
    tok = lb.WhitespaceTokenizer(256)
    assert nah.build_haystack(tok, 150, 0.5) == jnah.build_haystack(
        jlb.WhitespaceTokenizer(256), 150, 0.5)


def test_gsm8k_pipeline_end_to_end(tmp_path, capsys):
    train = tmp_path / "train.jsonl"
    test = tmp_path / "test.jsonl"
    train.write_text("".join(
        json.dumps({"question": f"What is {i} plus {i}?",
                    "answer": f"#### {2 * i}"}) + "\n" for i in range(3)))
    test.write_text("".join(json.dumps(
        {"question": f"What is 2 times {i}?", "answer": f"#### {2 * i}"})
        + "\n" for i in range(2)))
    out = tmp_path / "preds.jsonl"
    gsm8k.run(gsm8k.parse_args([
        "--checkpoint", "random:tiny", "--device", "cpu", "--train",
        str(train), "--test", str(test), "--shots", "2", "--max-new", "6",
        "--max-seq-len", "256", "--prefill-bucket", "64",
        "--compress-ratio", "0.3", "--compressor", "sparq_f", "--out",
        str(out)]))
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["n"] == 2 and summary["shots"] == 2
    assert 0.0 <= summary["accuracy"] <= 1.0
    rows = _lines(out)
    assert len(rows) == 2 and {"pred", "gold", "correct"} <= set(rows[0])
    from pqcache_tpu.harness import gsm8k as jgsm8k
    for pred, gold in (("so the total is 42 dollars", "#### 42"),
                       ("maybe 41", "#### 42"), ("1,234 apples", "#### 1234"),
                       ("", "#### 1")):
        assert gsm8k.answer_correct(pred, gold) == jgsm8k.answer_correct(
            pred, gold)
    assert gsm8k.build_prompt([{"question": "q", "answer": "a"}], "x") == \
        jgsm8k.build_prompt([{"question": "q", "answer": "a"}], "x")


def test_load_model_random_weights_and_device(tmp_path):
    args = lb.parse_args(["predict", "--checkpoint", "random:tiny",
                          "--device", "cpu"])
    cfg, params, tok = lb.load_model(args)
    assert cfg == config.tiny_model_config()
    assert params["embed"].device.type == "cpu"
    assert params["embed"].dtype == torch.bfloat16
    assert isinstance(tok, lb.WhitespaceTokenizer)
    # the same seed gives the same weights
    assert torch.equal(lb.load_model(args)[1]["embed"], params["embed"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            lb.load_model(lb.parse_args(["predict", "--checkpoint",
                                         "random:tiny"]))
