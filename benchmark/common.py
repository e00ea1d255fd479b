"""Configuration files, seeds, percentiles and chunk pacing.

``percentile`` and ``pacing_gaps`` are frozen copies of the arithmetic of
``pqcache_tpu_torch/harness/serving.py`` (``_pct`` and the chunk pacing of
``summarize``), so that the yardstick does not move with the program.
"""

from __future__ import annotations

import json
import subprocess
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def workload(name: str) -> dict:
    """A cell: its file ``workloads/<name>.json`` over its traffic's
    parameters (``traffic/<traffic>.json``), with its configuration's file
    (``configs/<config>.json``) under "model"."""
    cell = load_json(ROOT / "workloads" / f"{name}.json")
    wl = dict(load_json(ROOT / "traffic" / f"{cell['traffic']}.json"))
    wl.update(cell, name=name)
    wl["model"] = load_json(ROOT / "configs" / f"{wl['config']}.json")
    return wl


def head_dim(cfg: dict) -> int:
    """head_dim where the config gives it, else hidden / heads (the
    convention of the model's family)."""
    return int(cfg.get("head_dim")
               or cfg["hidden_size"] // cfg["num_attention_heads"])


def model_shape(cfg: dict) -> dict:
    """The sizes the harness and the roofline read, by short names."""
    return dict(V=cfg["vocab_size"], E=cfg["hidden_size"],
                I=cfg["intermediate_size"], L=cfg["num_hidden_layers"],
                H=cfg["num_attention_heads"], Hkv=cfg["num_key_value_heads"],
                D=head_dim(cfg), eps=cfg["rms_norm_eps"],
                theta=cfg["rope_theta"])


def budget(model: dict, prompt_tokens: int) -> dict:
    """PQCache's per-step budget at a prompt length: sink, local, topk and
    the selected blocks (``core/budget.py``'s arithmetic)."""
    b, pq = model["budget"], model["pq"]
    n = prompt_tokens - b["sink"]
    local = int(n * b["compress_ratio"] * b["recent_ratio"])
    topk = int(n * b["compress_ratio"] * (1.0 - b["recent_ratio"]))
    blocks = max(-(-topk // pq["select_block"]), 1)
    return dict(sink=b["sink"], local=local, topk=topk, blocks=blocks,
                block=pq["select_block"])


def seed_bits(seed: int) -> int:
    """Any whole number as a 63-bit seed for torch and numpy."""
    return int(seed) & (2 ** 63 - 1)


def rng(seed: int, stream: int) -> np.random.Generator:
    """Independent numpy streams of one seed: 1 prompt, 2 first tokens,
    3 the sample that the reference checks."""
    return np.random.default_rng([seed_bits(seed), stream])


def percentile(vals, q: float) -> float:
    """numpy's linear percentile (serving.py's ``_pct``)."""
    return float(np.percentile(np.asarray(vals, np.float64), q))


def pacing_gaps(times, counts) -> list:
    """Per-token gaps from chunk pacing (serving.py's ``summarize``): a
    chunk that ends at times[i + 1] and delivered counts[i] tokens gives
    each of them (times[i + 1] - times[i]) / counts[i]; times[0] is when
    the first chunk's wait began."""
    out = []
    for i, n in enumerate(counts):
        out.extend([(times[i + 1] - times[i]) / n] * int(n))
    return out


def window_rate(t_start: float, ends, counts, streams: int) -> float:
    """Tokens a second over the whole window: every stream's tokens of
    every chunk, over the time from the window's start to the last chunk's
    end."""
    return sum(counts) * streams / (ends[-1] - t_start)


def card_info() -> str:
    """The card's name and power limit as nvidia-smi reads them."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.SubprocessError):
        return "unknown"
