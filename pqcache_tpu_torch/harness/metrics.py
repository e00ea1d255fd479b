"""LongBench v1 scoring metrics: the port's own copy of
``pqcache_tpu/harness/metrics.py`` (the standard THUDM/LongBench metrics of
the reference's metrics.py:1-144), kept here so that the port imports
nothing of the JAX package.

fuzzywuzzy is replaced by difflib.SequenceMatcher (the ratio fuzz.ratio
computes). ``jieba`` (Chinese word segmentation) falls back to characters
and ``rouge`` scores 0.0 where the package is missing, as in the JAX copy.
"""

from __future__ import annotations

import difflib
import re
import string
from collections import Counter
from typing import List


def normalize_answer(s: str) -> str:
    s = s.lower()
    s = "".join(ch for ch in s if ch not in set(string.punctuation))
    s = re.sub(r"\b(a|an|the)\b", " ", s)
    return " ".join(s.split())


_CN_PUNCT = ("！？｡。＂＃＄％＆＇（）＊＋，－／：；＜＝＞＠［＼］＾＿｀"
             "｛｜｝～｟｠｢｣､、〃》「」『』【】〔〕〖〗〘〙〚〛〜〝〞〟〰"
             "〾〿–—‘’‛“”„‟…‧﹏.")


def normalize_zh_answer(s: str) -> str:
    s = s.lower()
    punct = set(string.punctuation + _CN_PUNCT)
    s = "".join(ch for ch in s if ch not in punct)
    return "".join(s.split())


def _f1(pred_tokens: List[str], gt_tokens: List[str]) -> float:
    common = Counter(pred_tokens) & Counter(gt_tokens)
    num_same = sum(common.values())
    if num_same == 0 or not pred_tokens or not gt_tokens:
        return 0.0
    precision = num_same / len(pred_tokens)
    recall = num_same / len(gt_tokens)
    return 2 * precision * recall / (precision + recall)


def qa_f1_score(prediction: str, ground_truth: str, **kw) -> float:
    return _f1(normalize_answer(prediction).split(),
               normalize_answer(ground_truth).split())


def qa_f1_zh_score(prediction: str, ground_truth: str, **kw) -> float:
    try:
        import jieba
        pred = [t for t in jieba.cut(prediction, cut_all=False)]
        gt = [t for t in jieba.cut(ground_truth, cut_all=False)]
    except ImportError:
        pred, gt = list(prediction), list(ground_truth)
    pred = [normalize_zh_answer(t) for t in pred]
    gt = [normalize_zh_answer(t) for t in gt]
    return _f1([t for t in pred if t], [t for t in gt if t])


def rouge_score(prediction: str, ground_truth: str, **kw) -> float:
    try:
        from rouge import Rouge
        scores = Rouge().get_scores([prediction], [ground_truth],
                                    avg=True)
        return scores["rouge-l"]["f"]
    except Exception:
        return 0.0


def rouge_zh_score(prediction: str, ground_truth: str, **kw) -> float:
    try:
        import jieba
        prediction = " ".join(jieba.cut(prediction, cut_all=False))
        ground_truth = " ".join(jieba.cut(ground_truth, cut_all=False))
    except ImportError:
        prediction = " ".join(prediction)
        ground_truth = " ".join(ground_truth)
    return rouge_score(prediction, ground_truth)


def classification_score(prediction: str, ground_truth: str, **kw) -> float:
    em_match_list = []
    all_classes = kw.get("all_classes") or []
    for class_name in all_classes:
        if class_name in prediction:
            em_match_list.append(class_name)
    for match_term in list(em_match_list):
        if match_term in ground_truth and match_term != ground_truth:
            em_match_list.remove(match_term)
    if ground_truth in em_match_list:
        return 1.0 / len(em_match_list)
    return 0.0


def retrieval_score(prediction: str, ground_truth: str, **kw) -> float:
    matches = re.findall(r"Paragraph (\d+)", ground_truth)
    if not matches:
        return 0.0
    gt_id = matches[0]
    numbers = re.findall(r"\d+", prediction)
    if not numbers:
        return 0.0
    right = sum(1 for n in numbers if str(n) == str(gt_id))
    return right / len(numbers)


def retrieval_zh_score(prediction: str, ground_truth: str, **kw) -> float:
    matches = re.findall(r"段落(\d+)", ground_truth)
    if not matches:
        return 0.0
    gt_id = matches[0]
    numbers = re.findall(r"\d+", prediction)
    if not numbers:
        return 0.0
    right = sum(1 for n in numbers if str(n) == str(gt_id))
    return right / len(numbers)


def count_score(prediction: str, ground_truth: str, **kw) -> float:
    numbers = re.findall(r"\d+", prediction)
    if not numbers:
        return 0.0
    right = sum(1 for n in numbers if str(n) == str(ground_truth))
    return right / len(numbers)


def code_sim_score(prediction: str, ground_truth: str, **kw) -> float:
    all_lines = prediction.lstrip("\n").split("\n")
    prediction = ""
    for line in all_lines:
        if ("`" not in line) and ("#" not in line) and ("//" not in line):
            prediction = line
            break
    return difflib.SequenceMatcher(
        None, prediction.strip(), ground_truth.strip()).ratio()


DATASET2METRIC = {
    "narrativeqa": qa_f1_score,
    "qasper": qa_f1_score,
    "multifieldqa_en": qa_f1_score,
    "multifieldqa_zh": qa_f1_zh_score,
    "hotpotqa": qa_f1_score,
    "2wikimqa": qa_f1_score,
    "musique": qa_f1_score,
    "dureader": rouge_zh_score,
    "gov_report": rouge_score,
    "qmsum": rouge_score,
    "multi_news": rouge_score,
    "vcsum": rouge_zh_score,
    "trec": classification_score,
    "triviaqa": qa_f1_score,
    "samsum": rouge_score,
    "lsht": classification_score,
    "passage_retrieval_en": retrieval_score,
    "passage_count": count_score,
    "passage_retrieval_zh": retrieval_zh_score,
    "lcc": code_sim_score,
    "repobench-p": code_sim_score,
}

# the 14 tasks evaluated in the paper (vq_pred.py:427-429)
PAPER_DATASETS = [
    "narrativeqa", "qasper", "multifieldqa_en", "hotpotqa", "2wikimqa",
    "musique", "gov_report", "qmsum", "multi_news", "trec", "triviaqa",
    "samsum", "passage_count", "passage_retrieval_en",
]


def _sample_score(dataset: str, pred: str, gts, all_classes) -> float:
    metric = DATASET2METRIC[dataset]
    if dataset in ("trec", "triviaqa", "samsum", "lsht"):
        pred = pred.lstrip("\n").split("\n")[0]
    return max((metric(pred, gt, all_classes=all_classes) for gt in gts),
               default=0.0)


def scorer(dataset: str, predictions, answers, all_classes=None) -> float:
    """Mean metric over samples ×100 (eval.py:68-77)."""
    total = sum(_sample_score(dataset, p, gts, all_classes)
                for p, gts in zip(predictions, answers))
    return round(100 * total / max(len(predictions), 1), 2)


def scorer_e(dataset: str, predictions, answers, lengths,
             all_classes=None) -> dict:
    """LongBench-E length-bucketed scoring (eval.py:50-66): per-sample max
    metric, bucketed by context length into 0-4k / 4-8k / 8k+, mean ×100 per
    bucket (NaN-free: empty buckets score 0.0 with count 0 recorded)."""
    buckets: dict = {"0-4k": [], "4-8k": [], "8k+": []}
    for pred, gts, length in zip(predictions, answers, lengths):
        s = _sample_score(dataset, pred, gts, all_classes)
        if length < 4000:
            buckets["0-4k"].append(s)
        elif length < 8000:
            buckets["4-8k"].append(s)
        else:
            buckets["8k+"].append(s)
    return {k: round(100 * sum(v) / len(v), 2) if v else 0.0
            for k, v in buckets.items()}
